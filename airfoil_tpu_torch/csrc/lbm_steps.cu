// D2Q9 lattice-Boltzmann steps for Hopper (sm_90a), the whole lattice on
// chip for a whole call, one cooperative launch; plain C interface.
//
// Replaces the Pallas TPU kernel airfoil_tpu/lbm/kernel.py::lbm_steps_pallas
// (body _kernel, kernel.py:39-51), which keeps the (9, NY, NX) float32
// lattice in VMEM across all `steps` fused steps of
// airfoil_tpu/lbm/core.py::step_body. The plain torch version is
// airfoil_tpu_torch/lbm/core.py::lbm_step, and the Python wrapper is
// airfoil_tpu_torch/lbm/kernel.py::lbm_steps. This file also holds
// cell_word_kernel, the counterpart of the bounce rolls that the Pallas
// kernel hoists out of its step loop (kernel.py:45); lbm/kernel.py::
// cell_word launches it once per mask, not once per call.
//
// Design. One persistent block per SM, launched cooperatively, each owning
// a 2-D tile of the lattice (the plan, tiles_x x tiles_y tiles of tile_w x
// tile_h cells, is chosen by lbm/kernel.py::resident_plan from the card's
// SM count and opt-in shared memory). A block loads its tile and a one-cell
// ring (indices modulo NY and NX, the periodic wrap of the reference's
// roll) into shared memory once, and keeps its cells' words in registers.
// It then runs every step between two shared buffers: each thread steps
// its (at most kCellsPerThread) cells with lbm_cell(); the tile's edge
// cells also go to a global exchange surface; cooperative_groups'
// grid.sync(); the block pulls its ring from the neighbours' edge cells and
// __syncthreads(). Two exchange surfaces alternate by step parity, so a
// fast block never overwrites a ring that a slow neighbour has yet to read.
// The last step writes the tile straight from registers to `out` (each
// warp 128 contiguous bytes per direction); no step writes the lattice to
// device memory in between, and the input is never written.
//
// Bound. A call reads the lattice and the word once and writes the lattice
// once: 38 B + 36 B a cell, whatever `steps` is. In between, each step
// moves a tile's perimeter (2 (tile_w + tile_h) + 4 cells x 36 B, twice)
// through L2 and waits at one grid barrier; the ~100 flops a cell-step and
// 19 shared-memory accesses are spread over all 132 SMs. So a short call
// is bound by the launch and the barriers, a long one by the SMs' issue of
// the per-cell arithmetic. Capacity: two buffers of 36 B a cell in an SM's
// 227 KB, about 400,000 cells on 132 SMs (640x384 fits; 1024x512 does not,
// and goes to lbm_steps_tiled.cu). The wrapper refuses what the plan cannot
// hold, and this file refuses a plan that the occupancy cannot co-schedule
// (cudaErrorCooperativeLaunchTooLarge) without launching.
//
// Precision: built without fast math, so 1/rho, sqrtf and the clamp's
// division are IEEE; nvcc still contracts multiply-adds into FMAs, so the
// result is not bit-equal to the torch step (held to rtol 1e-5, atol 1e-6),
// but it is bit-equal to lbm_steps_tiled.cu, which calls the same
// pull_window() and lbm_cell() on the same values.

#include <cooperative_groups.h>

#include <atomic>

#include "lbm_cell.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kResidentThreads = 1024;
constexpr int kCellsPerThread = 4;  // a tile holds at most 4 x 1024 cells
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
cell_word_kernel(const float* __restrict__ solid, uint16_t* __restrict__ word,
                 int ny, int nx) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= ny * nx) return;
  const int y = cell / nx;
  const int x = cell - y * nx;
  const bool self = solid[cell] > 0.5f;
  unsigned b = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int src = wrap(y - ey_of(i), ny) * nx + wrap(x - ex_of(i), nx);
    if (self || solid[src] > 0.5f) b |= 1u << i;
  }
  if (x == nx - 1) {
    b |= kOutletBit;
  } else if (x == 0 || y == 0 || y == ny - 1) {
    b |= kEdgeBit;
  }
  word[cell] = static_cast<uint16_t>(b);
}

struct Plan {
  int tiles_x, tiles_y, tile_w, tile_h;
};

// Slot of edge cell (y, x) of an h x w tile in its block's exchange record
// of 2 (tw + th) cells per direction: top row, bottom row, left column,
// right column, in that order of preference. Writer and reader both use it.
__device__ __forceinline__ int edge_slot(int y, int x, int h, int w, int tw,
                                         int th) {
  return y == 0 ? x
                : (y == h - 1 ? tw + x : (x == 0 ? 2 * tw + y : 2 * tw + th + y));
}

__global__ void __launch_bounds__(kResidentThreads, 1)
lbm_resident_kernel(const float* __restrict__ f, float* __restrict__ out,
                    const uint16_t* __restrict__ word, float* xchg, int ny,
                    int nx, int steps, Plan plan, StepParams p) {
  extern __shared__ float smem[];
  const int tw = plan.tile_w;
  const int th = plan.tile_h;
  const int pitch = tw + 2;
  const int plane = pitch * (th + 2);
  const int bx = blockIdx.x % plan.tiles_x;
  const int by = blockIdx.x / plan.tiles_x;
  const int x0 = bx * tw;
  const int y0 = by * th;
  const int w = min(tw, nx - x0);  // the last tile of a row or column may be ragged
  const int h = min(th, ny - y0);
  const int n = ny * nx;
  const int perim = 2 * (tw + th);
  const size_t half = static_cast<size_t>(gridDim.x) * 9 * perim;
  float* src = smem;
  float* dst = smem + 9 * plane;

  // The window: the tile and its one-cell ring.
  for (int c = threadIdx.x; c < (h + 2) * (w + 2); c += blockDim.x) {
    const int ly = c / (w + 2);
    const int lx = c - ly * (w + 2);
    const int g = wrap(y0 - 1 + ly, ny) * nx + wrap(x0 - 1 + lx, nx);
#pragma unroll
    for (int i = 0; i < 9; ++i) src[i * plane + ly * pitch + lx] = f[i * n + g];
  }
  // This thread's cells (ly << 16 | lx, or -1) and their words, fixed for
  // the whole call.
  int pos[kCellsPerThread];
  unsigned wd[kCellsPerThread];
#pragma unroll
  for (int k = 0; k < kCellsPerThread; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    pos[k] = -1;
    wd[k] = 0;
    if (c < h * w) {
      const int ly = c / w;
      const int lx = c - ly * w;
      pos[k] = (ly << 16) | lx;
      wd[k] = word[(y0 + ly) * nx + x0 + lx];
    }
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  for (int s = 1; s <= steps; ++s) {
    const bool last = s == steps;
    float* mine = xchg + (s & 1) * half + static_cast<size_t>(blockIdx.x) * 9 * perim;
#pragma unroll
    for (int k = 0; k < kCellsPerThread; ++k) {
      if (pos[k] < 0) continue;
      const int ly = pos[k] >> 16;
      const int lx = pos[k] & 0xffff;
      const int cell = (ly + 1) * pitch + lx + 1;
      float fin[9];
      step_cell(fin, src, plane, cell, pitch, wd[k], p);
      if (last) {
        const int g = (y0 + ly) * nx + x0 + lx;
#pragma unroll
        for (int i = 0; i < 9; ++i) out[i * n + g] = fin[i];
      } else {
#pragma unroll
        for (int i = 0; i < 9; ++i) dst[i * plane + cell] = fin[i];
        if (ly == 0 || ly == h - 1 || lx == 0 || lx == w - 1) {
          float* slot = mine + edge_slot(ly, lx, h, w, tw, th);
#pragma unroll
          for (int i = 0; i < 9; ++i) __stcg(slot + i * perim, fin[i]);
        }
      }
    }
    if (last) break;
    grid.sync();

    // The ring: r runs over the top row, the bottom row (both with their
    // corners), then the left and the right column. Each ring cell is an
    // edge cell of the neighbouring tile (indices modulo the tile grid);
    // L2 only (ld.cg), since the values were written during this launch.
    const float* surf = xchg + (s & 1) * half;
    for (int r = threadIdx.x; r < 2 * (w + h) + 4; r += blockDim.x) {
      int ly, lx;
      if (r < 2 * (w + 2)) {
        const bool top = r < w + 2;
        ly = top ? -1 : h;
        lx = (top ? r : r - (w + 2)) - 1;
      } else {
        const int q = r - 2 * (w + 2);
        lx = q < h ? -1 : w;
        ly = q < h ? q : q - h;
      }
      const int dy = ly < 0 ? -1 : (ly >= h ? 1 : 0);
      const int dx = lx < 0 ? -1 : (lx >= w ? 1 : 0);
      const int nbx = wrap(bx + dx, plan.tiles_x);
      const int nby = wrap(by + dy, plan.tiles_y);
      const int nw = min(tw, nx - nbx * tw);
      const int nh = min(th, ny - nby * th);
      const int qy = dy < 0 ? nh - 1 : (dy > 0 ? 0 : ly);
      const int qx = dx < 0 ? nw - 1 : (dx > 0 ? 0 : lx);
      const float* from = surf + static_cast<size_t>(nby * plan.tiles_x + nbx) * 9 * perim +
                          edge_slot(qy, qx, nh, nw, tw, th);
      const int cell = (ly + 1) * pitch + lx + 1;
#pragma unroll
      for (int i = 0; i < 9; ++i) dst[i * plane + cell] = __ldcg(from + i * perim);
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }
}

// Shared-memory limit, SM count: per device, queried once (a race only
// repeats the same harmless calls).
struct DeviceInfo {
  std::atomic<bool> ready;
  int sm_count;
  int smem_optin;
  std::atomic<uint64_t> occupancy;  // smem bytes << 32 | blocks per SM, the last asked
};
DeviceInfo g_devices[kMaxDevices];

cudaError_t device_info(int device, DeviceInfo** info) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo* d = &g_devices[device];
  if (!d->ready.load()) {
    cudaError_t err = cudaDeviceGetAttribute(&d->sm_count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&d->smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(lbm_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d->smem_optin);
    if (err != cudaSuccess) return err;
    d->ready.store(true);
  }
  *info = d;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The card's {SM count, opt-in shared memory per block in bytes}: what
// bounds the resident plan.
int lbm_device_limits(int device, int* limits) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  DeviceInfo* d;
  err = device_info(device, &d);
  if (err != cudaSuccess) return err;
  limits[0] = d->sm_count;
  limits[1] = d->smem_optin;
  return 0;
}

// The static cell word of `solid` (ny*nx floats) into `word` (ny*nx
// uint16), one launch on `stream`. Does not synchronise.
int lbm_cell_word_launch(const float* solid, uint16_t* word, int ny, int nx,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int blocks = (ny * nx + kThreads - 1) / kThreads;
  cell_word_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(solid, word, ny, nx);
  return cudaGetLastError();
}

// Runs `steps` >= 1 steps from `f` into `out` on `stream` in one
// cooperative launch of tiles_x * tiles_y blocks of tile_w x tile_h cells.
// `word` holds ny*nx uint16 cell words, `xchg` 2 * blocks * 9 * 2 (tile_w +
// tile_h) floats. All pointers are device pointers except `feq_in` (9
// floats, host). Returns the first CUDA error (0 on success), without
// launching when the plan does not fit the block or the card cannot hold
// every block at once. Does not synchronise.
int lbm_steps_launch(const float* f, float* out, float* xchg,
                     const uint16_t* word, int ny, int nx, int steps,
                     int tiles_x, int tiles_y, int tile_w, int tile_h,
                     const float* feq_in, float inv_tau, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  DeviceInfo* d;
  err = device_info(device, &d);
  if (err != cudaSuccess) return err;
  if (tile_w * tile_h > kCellsPerThread * kResidentThreads || tiles_x * tile_w < nx ||
      tiles_y * tile_h < ny || (tiles_x - 1) * tile_w >= nx || (tiles_y - 1) * tile_h >= ny)
    return cudaErrorInvalidValue;
  const size_t smem = 2 * 9 * static_cast<size_t>(tile_w + 2) * (tile_h + 2) * sizeof(float);
  if (smem > static_cast<size_t>(d->smem_optin)) return cudaErrorInvalidValue;
  const int blocks = tiles_x * tiles_y;
  const uint64_t last = d->occupancy.load();
  int per_sm = static_cast<int>(last & 0xffffffffu);
  if (last >> 32 != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lbm_resident_kernel,
                                                        kResidentThreads, smem);
    if (err != cudaSuccess) return err;
    d->occupancy.store(static_cast<uint64_t>(smem) << 32 | static_cast<uint32_t>(per_sm));
  }
  if (per_sm * d->sm_count < blocks) return cudaErrorCooperativeLaunchTooLarge;

  StepParams p;
  for (int i = 0; i < 9; ++i) p.feq_in[i] = feq_in[i];
  p.inv_tau = inv_tau;
  Plan plan{tiles_x, tiles_y, tile_w, tile_h};
  void* args[] = {&f, &out, &word, &xchg, &ny, &nx, &steps, &plan, &p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lbm_resident_kernel),
                                    dim3(blocks), dim3(kResidentThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
