// D2Q9 lattice-Boltzmann steps for Hopper (sm_90a), K steps per launch in
// shared memory (temporal blocking) by persistent, TMA-fed blocks; plain C
// interface.
//
// Replaces the Pallas TPU kernel
// airfoil_tpu/lbm/kernel.py::lbm_steps_pallas_tiled (body _tiled_kernel,
// kernel.py:85-140), which runs K fused steps on row strips whose halo
// windows it moves HBM -> VMEM by DMA. The plain torch version is
// airfoil_tpu_torch/lbm/core.py::lbm_step (the full-grid step the tiled
// result is defined to equal), and the Python wrapper is
// airfoil_tpu_torch/lbm/kernel.py::lbm_steps_tiled. It serves the lattices
// that lbm_steps.cu cannot hold on chip.
//
// Design. The lattice is cut into kTileY x kTileX tiles; a tile's window is
// the tile plus kSteps cells on every side: the 9 f values and the static
// cell word (lbm/kernel.py::cell_word, built once per mask) of each cell.
// A launch runs k <= kSteps steps on every tile: step M of kSteps computes
// the cells at least M cells inside the window (the first k - kSteps
// margins are skipped when k < kSteps), so every read stays inside the
// window and on cells the previous step computed; the last step computes
// exactly the tile and writes it from registers to `out` (each warp 128
// contiguous bytes per direction), so nothing is stored twice.
//
// Persistent blocks: as many as fit on the card at once (blocks per SM from
// the occupancy), each walking the tiles in row-major order with a stride
// of the grid size, so that neighbouring blocks read overlapping windows
// from L2 at about the same time. A block keeps a ring of two window
// buffers and one scratch buffer in shared memory: while it steps tile t
// (ring buffer -> scratch -> ring buffer ...), the Tensor Memory
// Accelerator loads tile t+1's window into the other ring buffer: one
// cp.async.bulk.tensor on a 3-D map over (9, NY, NX) for f and one on a 2-D
// map over the (NY, NX) words, completing on that buffer's mbarrier. TMA
// fills out-of-range cells with zeros, not with the periodic wrap, so a
// tile whose window crosses the grid's edge (and every tile when NX % 8 !=
// 0 or a base is not 16 B aligned, TMA's stride and alignment rules for the
// uint16 words) is loaded by the block's threads through the plain path,
// indexed modulo NY and NX: the only place that takes a runtime `%`. The
// step loop divides only by compile-time constants.
//
// A call runs ceil(steps / kSteps) launches, ping-ponged between `out` and
// `scratch` so that the input is never written and the last round lands in
// `out`. There is no alignment rule and no size limit beyond 32-bit
// indexing: ragged edge tiles store only the cells that exist. Tensor maps
// are encoded through the runtime's driver entry point (nothing more to
// link) and cached per (pointer, shape, device).
//
// Tile, K and threads (chosen on the card against the variants named
// here). Shared memory per block is 3 f windows of 36 B a cell and 2 word
// windows: 32x16 tiles at K = 4 (40x24 windows) take 108,304 B, two
// blocks an SM; 64x16 at K = 4 194,320 B and
// K = 8 on 32x16 172,048 B, one block an SM, and both ran slower. The
// window ratio (window cells over tile cells) is 1.875, 1.6875 and 3.0; a
// cell is computed 1.31, 1.25 and 1.79 times a kept cell-step. 512
// threads a block ran 1-3% faster than 256.
//
// Bound. Per kept cell and call of kSteps steps the kernel moves (38 r +
// 36) B of device memory, r the window ratio (mostly L2 hits for the
// overlapping halos), against 74 B for the lattice read and written once.
// Per computed cell-step it makes 19 shared-memory accesses and ~100 flops
// with ~150 instructions, so once the loads are hidden it is bound by the
// SMs' instruction issue, not by device memory.

#include <atomic>
#include <mutex>

#include "lbm_cell.cuh"
#include "lbm_tma.cuh"

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 16;
constexpr int kSteps = 4;  // steps per launch, and the halo width in cells
constexpr int kTiledThreads = 512;
constexpr int kWinX = kTileX + 2 * kSteps;
constexpr int kWinY = kTileY + 2 * kSteps;
constexpr int kWin = kWinX * kWinY;
constexpr int kPlaneBytes = 9 * kWin * 4;  // one f window
// A TMA box must start on a 16 B boundary of its row: the word window
// starts kWordLead >= kSteps columns left of the tile (a multiple of 8
// uint16), is kWordPitch columns wide, and the f window's column 0 is its
// column kWordShift.
constexpr int kWordLead = (kSteps + 7) / 8 * 8;
constexpr int kWordShift = kWordLead - kSteps;
constexpr int kWordPitch = (kWordLead + kTileX + kSteps + 7) / 8 * 8;
constexpr int kWordBytes = kWordPitch * kWinY * 2;  // one word window
constexpr int kWordStride = (kWordBytes + 127) / 128 * 128;
constexpr int kBarOffset = 3 * kPlaneBytes + 2 * kWordStride;
constexpr int kSmemBytes = kBarOffset + 2 * 8;
constexpr int kMaxDevices = 64;
constexpr int kMapCache = 16;
static_assert(kTileX % 8 == 0 && kSteps % 4 == 0 && kWinX <= 256 && kWinY <= 256,
              "window rows must start and end on 16 B boundaries; a box is at most 256");
static_assert(kPlaneBytes % 128 == 0, "window buffers must stay 128 B aligned");

// v modulo n for any v (C's % truncates towards zero).
__device__ __forceinline__ int wrap_any(int v, int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ float* window_at(unsigned char* smem, int b) {
  return reinterpret_cast<float*>(smem + b * kPlaneBytes);
}
__device__ __forceinline__ uint16_t* words_at(unsigned char* smem, int b) {
  return reinterpret_cast<uint16_t*>(smem + 3 * kPlaneBytes + b * kWordStride);
}
__device__ __forceinline__ uint64_t* bar_at(unsigned char* smem, int b) {
  return reinterpret_cast<uint64_t*>(smem + kBarOffset) + b;
}

__device__ __forceinline__ void tile_origin(int t, int tiles_x, int* y0, int* x0) {
  const int ty = t / tiles_x;
  *y0 = ty * kTileY;
  *x0 = (t - ty * tiles_x) * kTileX;
}

// A window (and its word window) that lies inside the grid can come by TMA.
__device__ __forceinline__ bool inside(int y0, int x0, int ny, int nx) {
  return y0 >= kSteps && x0 >= kWordLead && y0 + kTileY + kSteps <= ny &&
         x0 - kWordLead + kWordPitch <= nx;
}

// Issued by one thread: window buffer b <- the window of the tile at
// (y0, x0), f and words, completing on b's mbarrier.
__device__ __forceinline__ void load_tma(unsigned char* smem, int b, const CUtensorMap* fmap,
                                         const CUtensorMap* wmap, int y0, int x0) {
  uint64_t* bar = bar_at(smem, b);
  mbar_expect_tx(bar, kPlaneBytes + kWordBytes);
  tma_load_3d(window_at(smem, b), fmap, bar, x0 - kSteps, y0 - kSteps, 0);
  tma_load_2d(words_at(smem, b), wmap, bar, x0 - kWordLead, y0 - kSteps);
}

// All threads: the window of the tile at (y0, x0), indexed modulo NY, NX.
__device__ __forceinline__ void load_plain(float* win, uint16_t* wd, const float* __restrict__ f,
                                           const uint16_t* __restrict__ word, int ny, int nx,
                                           int y0, int x0) {
  const int n = ny * nx;
  for (int c = threadIdx.x; c < kWin; c += kTiledThreads) {
    const int ly = c / kWinX;
    const int lx = c - ly * kWinX;
    const int g = wrap_any(y0 - kSteps + ly, ny) * nx + wrap_any(x0 - kSteps + lx, nx);
    wd[ly * kWordPitch + kWordShift + lx] = word[g];
#pragma unroll
    for (int i = 0; i < 9; ++i) win[i * kWin + c] = f[i * n + g];
  }
}

// One step on the cells at least M cells inside the window, src -> dst; the
// last (M == kSteps, exactly the tile) writes the cells that exist to out.
template <int M>
__device__ __forceinline__ void step_region(const float* src, float* dst, const uint16_t* wd,
                                            float* __restrict__ out, int ny, int nx, int y0,
                                            int x0, const StepParams& p) {
  constexpr int w = kWinX - 2 * M;
  constexpr int h = kWinY - 2 * M;
  for (int c = threadIdx.x; c < w * h; c += kTiledThreads) {
    const int row = c / w;
    const int col = c - row * w;
    const int cell = (M + row) * kWinX + M + col;
    float fin[9];
    step_cell(fin, src, kWin, cell, kWinX, wd[(M + row) * kWordPitch + kWordShift + M + col], p);
    if constexpr (M == kSteps) {
      const int gy = y0 + row;
      const int gx = x0 + col;
      if (gy < ny && gx < nx) {
        const int n = ny * nx;
#pragma unroll
        for (int i = 0; i < 9; ++i) out[i * n + gy * nx + gx] = fin[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i) dst[i * kWin + cell] = fin[i];
    }
  }
}

// Steps M..kSteps of a round of k, alternating a and b.
template <int M>
__device__ __forceinline__ void run_steps(int k, float* a, float* b, const uint16_t* wd,
                                          float* __restrict__ out, int ny, int nx, int y0,
                                          int x0, const StepParams& p) {
  if constexpr (M <= kSteps) {
    if (M > kSteps - k) {
      step_region<M>(a, b, wd, out, ny, nx, y0, x0, p);
      if constexpr (M < kSteps) {
        __syncthreads();
        run_steps<M + 1>(k, b, a, wd, out, ny, nx, y0, x0, p);
      }
    } else {
      run_steps<M + 1>(k, a, b, wd, out, ny, nx, y0, x0, p);
    }
  }
}

__global__ void __launch_bounds__(kTiledThreads)
lbm_tiled_kernel(const __grid_constant__ CUtensorMap fmap,
                 const __grid_constant__ CUtensorMap wmap, const float* __restrict__ f,
                 float* __restrict__ out, const uint16_t* __restrict__ word, int ny, int nx,
                 int k, int use_tma, StepParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* scratch = window_at(smem, 2);
  const int tiles_x = (nx + kTileX - 1) / kTileX;
  const int tiles = tiles_x * ((ny + kTileY - 1) / kTileY);
  if (threadIdx.x == 0) {
    mbar_init(bar_at(smem, 0));
    mbar_init(bar_at(smem, 1));
  }
  __syncthreads();

  uint32_t phase = 0;  // bit b: parity of buffer b's next TMA phase
  int t = blockIdx.x;
  int y0 = 0, x0 = 0;
  bool tma = false;
  if (t < tiles) {
    tile_origin(t, tiles_x, &y0, &x0);
    tma = use_tma && inside(y0, x0, ny, nx);
  }
  if (tma && threadIdx.x == 0) load_tma(smem, 0, &fmap, &wmap, y0, x0);
  for (int it = 0; t < tiles; ++it) {
    const int b = it & 1;
    const int tn = t + gridDim.x;
    int ny0 = 0, nx0 = 0;
    bool tma_next = false;
    if (tn < tiles) {
      tile_origin(tn, tiles_x, &ny0, &nx0);
      tma_next = use_tma && inside(ny0, nx0, ny, nx);
    }
    // The other ring buffer was released by the last tile's closing
    // fence and barrier: prefetch the next tile into it.
    if (tma_next && threadIdx.x == 0) load_tma(smem, b ^ 1, &fmap, &wmap, ny0, nx0);
    float* win = window_at(smem, b);
    uint16_t* wd = words_at(smem, b);
    if (tma) {
      mbar_wait(bar_at(smem, b), (phase >> b) & 1u);
      phase ^= 1u << b;
    } else {
      load_plain(win, wd, f, word, ny, nx, y0, x0);
      __syncthreads();
    }
    run_steps<1>(k, win, scratch, wd, out, ny, nx, y0, x0, p);
    // This thread's writes to the window buffer come before any later TMA
    // write to it.
    fence_proxy_async();
    __syncthreads();
    t = tn;
    y0 = ny0;
    x0 = nx0;
    tma = tma_next;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

struct MapEntry {
  const void* ptr;
  int rank, ny, nx, device;
  CUtensorMap map;
};
std::mutex g_map_mu;
MapEntry g_maps[kMapCache];
int g_map_next = 0;

// The tensor map whose box is one window: of a (9, ny, nx) float32 lattice
// (rank 3) or of the (ny, nx) uint16 words (rank 2, the wider word window)
// at `ptr`.
cudaError_t tensor_map(const void* ptr, int rank, int ny, int nx, int device, CUtensorMap* map) {
  std::lock_guard<std::mutex> lock(g_map_mu);
  for (const MapEntry& e : g_maps) {
    if (e.ptr == ptr && e.rank == rank && e.ny == ny && e.nx == nx && e.device == device) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t elem = rank == 3 ? 4 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(nx), static_cast<cuuint64_t>(ny), 9};
  const cuuint64_t strides[2] = {nx * elem, static_cast<cuuint64_t>(ny) * nx * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(rank == 3 ? kWinX : kWordPitch), kWinY, 9};
  const cuuint32_t unit[3] = {1, 1, 1};
  MapEntry& e = g_maps[g_map_next];
  g_map_next = (g_map_next + 1) % kMapCache;
  e.ptr = nullptr;
  const CUresult r = encode(
      &e.map, rank == 3 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT16, rank,
      const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  e.ptr = ptr;
  e.rank = rank;
  e.ny = ny;
  e.nx = nx;
  e.device = device;
  *map = e.map;
  return cudaSuccess;
}

// Per device, set up once: the shared-memory limit, the SM count and the
// blocks an SM holds (a race only repeats the same harmless calls).
struct DeviceInfo {
  std::atomic<bool> ready;
  int sm_count;
  int per_sm;
};
DeviceInfo g_devices[kMaxDevices];

cudaError_t device_info(int device, DeviceInfo** info) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo* d = &g_devices[device];
  if (!d->ready.load()) {
    cudaError_t err = cudaFuncSetAttribute(lbm_tiled_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&d->sm_count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d->per_sm, lbm_tiled_kernel,
                                                        kTiledThreads, kSmemBytes);
    if (err != cudaSuccess) return err;
    if (d->per_sm < 1) return cudaErrorInvalidConfiguration;
    d->ready.store(true);
  }
  *info = d;
  return cudaSuccess;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Runs `steps` >= 1 steps from `f` into `out` on `stream`, kSteps per
// launch. `scratch` (same size as `f`) is needed when steps > kSteps;
// `word` holds the ny*nx uint16 cell words. All pointers are device
// pointers except `feq_in` (9 floats, host). Returns the first CUDA error
// (0 on success), a refused shared-memory size, tensor map or launch
// included. Does not synchronise.
int lbm_steps_tiled_launch(const float* f, float* out, float* scratch, const uint16_t* word,
                           int ny, int nx, int steps, const float* feq_in, float inv_tau,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  DeviceInfo* d;
  err = device_info(device, &d);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  StepParams p;
  for (int i = 0; i < 9; ++i) p.feq_in[i] = feq_in[i];
  p.inv_tau = inv_tau;
  const int tiles = ((nx + kTileX - 1) / kTileX) * ((ny + kTileY - 1) / kTileY);
  const int grid = tiles < d->per_sm * d->sm_count ? tiles : d->per_sm * d->sm_count;
  const bool tma_ok = nx % 8 == 0 && aligned16(word);
  CUtensorMap wmap = {};
  if (tma_ok) {
    err = tensor_map(word, 2, ny, nx, device, &wmap);
    if (err != cudaSuccess) return err;
  }
  const int full = steps / kSteps;
  const int rounds = full + (steps % kSteps ? 1 : 0);
  const float* from = f;
  for (int r = 0; r < rounds; ++r) {
    const int k = r < full ? kSteps : steps % kSteps;
    float* to = ((rounds - 1 - r) % 2 == 0) ? out : scratch;
    const bool use_tma = tma_ok && aligned16(from);
    CUtensorMap fmap = {};
    if (use_tma) {
      err = tensor_map(from, 3, ny, nx, device, &fmap);
      if (err != cudaSuccess) return err;
    }
    lbm_tiled_kernel<<<grid, kTiledThreads, kSmemBytes, s>>>(fmap, wmap, from, to, word, ny, nx,
                                                              k, use_tma, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    from = to;
  }
  return 0;
}

// The compiled kernel on `device`: {tile width, tile height, steps per
// launch, dynamic shared bytes per block, threads per block, blocks per
// SM, SMs}.
int lbm_tiled_shape(int device, int* shape) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  DeviceInfo* d;
  err = device_info(device, &d);
  if (err != cudaSuccess) return err;
  shape[0] = kTileX;
  shape[1] = kTileY;
  shape[2] = kSteps;
  shape[3] = kSmemBytes;
  shape[4] = kTiledThreads;
  shape[5] = d->per_sm;
  shape[6] = d->sm_count;
  return 0;
}

const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
