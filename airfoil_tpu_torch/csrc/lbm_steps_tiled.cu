// D2Q9 lattice-Boltzmann steps for Hopper (sm_90a), K steps per launch in
// shared memory (temporal blocking); plain C interface.
//
// Replaces the Pallas TPU kernel
// airfoil_tpu/lbm/kernel.py::lbm_steps_pallas_tiled (body _tiled_kernel,
// kernel.py:85-140), which runs K fused steps on row strips whose halo
// windows it moves HBM -> VMEM by DMA. The plain torch version is
// airfoil_tpu_torch/lbm/core.py::lbm_step (the full-grid step the tiled
// result is defined to equal), and the Python wrapper is
// airfoil_tpu_torch/lbm/kernel.py::lbm_steps_tiled.
//
// Design. One block per 2-D tile of kTileY x kTileX interior cells. A
// launch loads the tile's window, the tile plus kSteps cells on every side,
// into shared memory: the 9 f values and a uint16 word per cell. Window
// coordinates are taken modulo NY and NX (never clamped), which is the
// periodic wrap of the full-grid step and holds even where a window is
// larger than the grid. The word carries the bounce bits (computed once
// per call over the whole grid by bounce_bits_kernel, as the one-step
// kernel does) plus the outlet and edge-equilibrium roles of the cell,
// taken from its global coordinates. The block then runs k <= kSteps steps
// between two shared buffers, one __syncthreads() per step. Step s of k
// computes only the cells at least s + (kSteps - k) cells inside the
// window edge, so every read stays inside the window and on cells that the
// previous step computed; after k steps the interior is exact and only it
// is stored. The per-cell arithmetic is lbm_cell() of lbm_cell.cuh, shared
// with the one-step kernel, so the two agree bit for bit.
//
// A call runs ceil(steps / kSteps) launches: full rounds of kSteps steps
// and a shorter last round, ping-ponged between `out` and `scratch` so
// that the input is never written and the last round lands in `out`.
// There is no alignment rule: ragged edge tiles store only the cells that
// exist.
//
// Tile and K. Shared memory per block is window cells x (2 buffers x 36 B
// + 2 B). At kTileX = 32, kTileY = 16, kSteps = 4 the window is 40 x 24 =
// 960 cells, 71,040 B: three blocks fit in an SM's 227 KB, so one block's
// loads overlap another's steps. (The 64 x 16 tile at K = 4 needs 125 KB,
// one block per SM, with every load exposed; a full-width strip as on the
// TPU does not fit at all: one row at NX = 2048 is 74 KB.) Larger K cuts
// device-memory traffic but grows the halo's redundant work: at K = 8 the
// same tile computes 1.79 cells for each cell it keeps, at K = 4 1.31.
//
// Bound. Per interior cell and step the kernel moves (38 r + 36) / K bytes
// of device memory, r = window cells / interior cells = 1.875: 26.8 B,
// against 74 B for the one-step kernel. Shared-memory traffic is 74 B per
// computed cell-step (9 gathered reads, 9 writes, the word), times 1.31
// for the halo: ~97 B per kept cell-step, about a third of what the
// card's shared bandwidth allows at the device-memory bound. What should
// set the pace of this simple version is neither: each block loads its
// whole window before its first step and stores after its last, with
// __syncthreads() between, so latency is hidden only by the other two
// blocks on the SM. TMA loads, clusters and overlapping the next tile's
// load with the current tile's steps are the known next steps.

#include <atomic>

#include "lbm_cell.cuh"

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 16;
constexpr int kSteps = 4;  // steps per launch, and the halo width in cells
constexpr int kWinX = kTileX + 2 * kSteps;
constexpr int kWinY = kTileY + 2 * kSteps;
constexpr int kWin = kWinX * kWinY;
constexpr unsigned kOutletBit = 1u << 9;
constexpr unsigned kEdgeBit = 1u << 10;
constexpr int kSmemBytes = 2 * 9 * kWin * sizeof(float) + kWin * sizeof(uint16_t);
constexpr int kMaxDevices = 64;

// v modulo n for any v (C's % truncates towards zero).
__device__ __forceinline__ int wrap_any(int v, int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

__global__ void __launch_bounds__(kThreads, 3)
lbm_tiled_kernel(const float* __restrict__ f, float* __restrict__ out,
                 const uint16_t* __restrict__ bits, int ny, int nx, int k,
                 StepParams p) {
  extern __shared__ float smem[];
  float* src = smem;             // [9][kWin]
  float* dst = smem + 9 * kWin;  // [9][kWin]
  uint16_t* word = reinterpret_cast<uint16_t*>(smem + 18 * kWin);
  const int n = ny * nx;
  const int tx0 = blockIdx.x * kTileX;
  const int ty0 = blockIdx.y * kTileY;

  // Load the window; consecutive threads take consecutive x.
  for (int c = threadIdx.x; c < kWin; c += kThreads) {
    const int ly = c / kWinX;
    const int lx = c - ly * kWinX;
    const int gy = wrap_any(ty0 - kSteps + ly, ny);
    const int gx = wrap_any(tx0 - kSteps + lx, nx);
    const int g = gy * nx + gx;
    unsigned w = bits[g];
    if (is_outlet_at(gx, nx)) w |= kOutletBit;
    if (is_edge_eq_at(gy, gx, ny, nx)) w |= kEdgeBit;
    word[c] = static_cast<uint16_t>(w);
#pragma unroll
    for (int i = 0; i < 9; ++i) src[i * kWin + c] = f[i * n + g];
  }
  __syncthreads();

  for (int s = 1; s <= k; ++s) {
    const int m = s + kSteps - k;  // margin: rows/columns left out this step
    const int w = kWinX - 2 * m;
    const int h = kWinY - 2 * m;
    for (int c = threadIdx.x; c < w * h; c += kThreads) {
      const int row = c / w;
      const int cell = (m + row) * kWinX + m + (c - row * w);
      const unsigned b = word[cell];
      const bool is_outlet = b & kOutletBit;

      // Stream (gather from x - e_i), bounce back, outlet copy.
      float fin[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        int from;
        if (is_outlet) {
          from = i * kWin + cell - 1;
        } else if ((b >> i) & 1u) {
          from = opp_of(i) * kWin + cell;
        } else {
          from = i * kWin + cell - ey_of(i) * kWinX - ex_of(i);
        }
        fin[i] = src[from];
      }

      lbm_cell(fin, b & 1u, is_outlet, b & kEdgeBit, p);
#pragma unroll
      for (int i = 0; i < 9; ++i) dst[i * kWin + cell] = fin[i];
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }

  // Store the interior cells that exist (edge tiles may be ragged).
  for (int c = threadIdx.x; c < kTileX * kTileY; c += kThreads) {
    const int ty = c / kTileX;
    const int tx = c - ty * kTileX;
    const int gy = ty0 + ty;
    const int gx = tx0 + tx;
    if (gy < ny && gx < nx) {
      const int cell = (ty + kSteps) * kWinX + tx + kSteps;
#pragma unroll
      for (int i = 0; i < 9; ++i) out[i * n + gy * nx + gx] = src[i * kWin + cell];
    }
  }
}

}  // namespace

extern "C" {

// Runs `steps` >= 1 steps from `f` into `out` on `stream`, kSteps per
// launch. `scratch` (same size as `f`) is needed when steps > kSteps;
// `bits` holds ny*nx uint16. All pointers are device pointers except
// `feq_in` (9 floats, host). Returns the first CUDA error (0 on success),
// a refused shared-memory size or launch included. Does not synchronise.
int lbm_steps_tiled_launch(const float* f, float* out, float* scratch,
                           const float* solid, uint16_t* bits, int ny, int nx,
                           int steps, const float* feq_in, float inv_tau,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // The shared-memory limit is a per-device attribute of the kernel; set
  // it once per device (setting it again is harmless, so a race is too).
  static std::atomic<bool> smem_set[kMaxDevices];
  if (device >= kMaxDevices || !smem_set[device].load()) {
    err = cudaFuncSetAttribute(lbm_tiled_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) smem_set[device].store(true);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const int blocks = (ny * nx + kThreads - 1) / kThreads;
  bounce_bits_kernel<<<blocks, kThreads, 0, s>>>(solid, bits, ny, nx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  StepParams p;
  for (int i = 0; i < 9; ++i) p.feq_in[i] = feq_in[i];
  p.inv_tau = inv_tau;
  const dim3 grid((nx + kTileX - 1) / kTileX, (ny + kTileY - 1) / kTileY);
  const int full = steps / kSteps;
  const int rounds = full + (steps % kSteps ? 1 : 0);
  const float* from = f;
  for (int r = 0; r < rounds; ++r) {
    const int k = r < full ? kSteps : steps % kSteps;
    float* to = ((rounds - 1 - r) % 2 == 0) ? out : scratch;
    lbm_tiled_kernel<<<grid, kThreads, kSmemBytes, s>>>(from, to, bits, ny, nx,
                                                         k, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    from = to;
  }
  return 0;
}

// The compiled tile: {kTileX, kTileY, kSteps, dynamic shared bytes per block}.
void lbm_tiled_shape(int* shape) {
  shape[0] = kTileX;
  shape[1] = kTileY;
  shape[2] = kSteps;
  shape[3] = kSmemBytes;
}

const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
