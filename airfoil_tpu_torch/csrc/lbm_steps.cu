// D2Q9 lattice-Boltzmann steps for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel airfoil_tpu/lbm/kernel.py::lbm_steps_pallas
// (body _kernel, kernel.py:39-51): `steps` fused steps of
// airfoil_tpu/lbm/core.py::step_body on a (9, NY, NX) float32 lattice.
// The plain torch version is airfoil_tpu_torch/lbm/core.py::lbm_step, and
// the Python wrapper is airfoil_tpu_torch/lbm/kernel.py::lbm_steps.
//
// Design. One launch per step, one thread per cell, two lattice buffers
// ping-ponged over the `steps` launches so the last step lands in `out`
// (the input is never written). The 9 bounce-back selections depend only
// on the solid mask, so they are computed once per call into a per-cell
// uint16 bitmask (bit i: direction i bounces), as the Pallas kernel hoists
// its 8 rolls out of the step loop. Streaming indexes modulo NY and NX,
// exactly as the reference's periodic roll: edge cells read their wrapped
// neighbours before the boundary conditions overwrite them, and a solid
// edge cell keeps values bounced from wrapped mask reads.
//
// Bound. Per cell and step: 9 float reads (gathered from the neighbours;
// each warp's reads stay contiguous along NX) and 9 float writes, 72 B of
// f traffic, plus the 2 B mask word. Arithmetic is ~100 flops per cell,
// far below the card's rate, so the kernel is bound by memory traffic and,
// on small lattices, by the launch cadence: the 384x192 default lattice is
// 2.65 MB per buffer, so both buffers sit in the 50 MB L2 and a step is a
// few microseconds.
//
// The per-cell arithmetic after the pull (lbm_cell.cuh) is shared with the
// K-steps-per-launch kernel lbm_steps_tiled.cu, which serves lattices too
// large for L2 and keeps K steps on chip per launch.
//
// Precision: built without fast math, so 1/rho, sqrtf and the clamp's
// division are IEEE; nvcc still contracts multiply-adds into FMAs, so the
// result is not bit-equal to the torch step (held to rtol 1e-5, atol 1e-6).

#include "lbm_cell.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
lbm_step_kernel(const float* __restrict__ f, float* __restrict__ out,
                const uint16_t* __restrict__ bits, int ny, int nx, StepParams p) {
  const int n = ny * nx;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  const int y = cell / nx;
  const int x = cell - y * nx;
  const unsigned b = bits[cell];
  const bool is_outlet = is_outlet_at(x, nx);
  const int left = y * nx + wrap(x - 1, nx);

  // Stream (gather from x - e_i), bounce back, outlet copy.
  float fin[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    int src;
    if (is_outlet) {
      src = i * n + left;
    } else if ((b >> i) & 1u) {
      src = opp_of(i) * n + cell;
    } else {
      src = i * n + wrap(y - ey_of(i), ny) * nx + wrap(x - ex_of(i), nx);
    }
    fin[i] = f[src];
  }

  lbm_cell(fin, b & 1u, is_outlet, is_edge_eq_at(y, x, ny, nx), p);
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i * n + cell] = fin[i];
}

}  // namespace

extern "C" {

// Runs `steps` >= 1 steps from `f` into `out` on `stream`. `scratch` (same
// size as `f`) is needed when steps > 1; `bits` holds ny*nx uint16. All
// pointers are device pointers except `feq_in` (9 floats, host). Returns
// the first CUDA error (0 on success). Does not synchronise.
int lbm_steps_launch(const float* f, float* out, float* scratch,
                     const float* solid, uint16_t* bits, int ny, int nx,
                     int steps, const float* feq_in, float inv_tau,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = ny * nx;
  const int blocks = (n + kThreads - 1) / kThreads;

  bounce_bits_kernel<<<blocks, kThreads, 0, s>>>(solid, bits, ny, nx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  StepParams p;
  for (int i = 0; i < 9; ++i) p.feq_in[i] = feq_in[i];
  p.inv_tau = inv_tau;
  const float* src = f;
  for (int k = 0; k < steps; ++k) {
    float* dst = ((steps - 1 - k) % 2 == 0) ? out : scratch;
    lbm_step_kernel<<<blocks, kThreads, 0, s>>>(src, dst, bits, ny, nx, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return 0;
}

const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
