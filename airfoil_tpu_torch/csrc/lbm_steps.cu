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
// few microseconds. Keeping K steps on chip per launch (clusters or
// temporal blocking) is the next step for this kernel.
//
// Precision: built without fast math, so 1/rho, sqrtf and the clamp's
// division are IEEE; nvcc still contracts multiply-adds into FMAs, so the
// result is not bit-equal to the torch step (held to rtol 1e-5, atol 1e-6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__host__ __device__ constexpr int ex_of(int i) {
  return (i == 1 || i == 5 || i == 8) ? 1 : (i == 3 || i == 6 || i == 7) ? -1 : 0;
}
__host__ __device__ constexpr int ey_of(int i) {
  return (i == 2 || i == 5 || i == 6) ? 1 : (i == 4 || i == 7 || i == 8) ? -1 : 0;
}
__host__ __device__ constexpr int opp_of(int i) {
  return i == 0 ? 0 : (i <= 4 ? (i + 1) % 4 + 1 : (i - 3) % 4 + 5);
}
// Weights rounded from double, as numpy's float32 D2Q9_W is.
__host__ __device__ constexpr float w_of(int i) {
  return i == 0 ? (float)(4.0 / 9.0) : (i <= 4 ? (float)(1.0 / 9.0) : (float)(1.0 / 36.0));
}

__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

struct StepParams {
  float feq_in[9];  // equilibrium at (rho=1, u=(U0,0)) for inlet/top/bottom
  float inv_tau;
};

__global__ void __launch_bounds__(kThreads)
bounce_bits_kernel(const float* __restrict__ solid, uint16_t* __restrict__ bits,
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
  bits[cell] = static_cast<uint16_t>(b);
}

__global__ void __launch_bounds__(kThreads)
lbm_step_kernel(const float* __restrict__ f, float* __restrict__ out,
                const uint16_t* __restrict__ bits, int ny, int nx, StepParams p) {
  const int n = ny * nx;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  const int y = cell / nx;
  const int x = cell - y * nx;
  const unsigned b = bits[cell];
  const bool is_solid = b & 1u;
  const bool is_outlet = x == nx - 1;
  const bool is_edge_eq = (x == 0 || y == 0 || y == ny - 1) && !is_outlet;
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

  float rho = fin[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) rho = rho + fin[i];
  const float inv = 1.0f / rho;
  const float ux = (fin[1] + fin[5] + fin[8] - fin[3] - fin[6] - fin[7]) * inv;
  const float uy = (fin[2] + fin[5] + fin[6] - fin[4] - fin[7] - fin[8]) * inv;

  // Stability net; comparisons rather than fminf/fmaxf so NaN propagates
  // as it does through jnp.clip / torch.clamp.
  const float rho_c = rho < 0.5f ? 0.5f : (rho > 2.0f ? 2.0f : rho);
  const float spd = sqrtf(ux * ux + uy * uy);
  const float scale = spd > 0.35f ? 0.35f / (spd > 1e-12f ? spd : 1e-12f) : 1.0f;
  const float uxc = ux * scale;
  const float uyc = uy * scale;
  const float uu = uxc * uxc + uyc * uyc;

  const bool skip_collide = is_solid || is_outlet;
  const bool apply_edge = is_edge_eq && !is_solid;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    float v;
    if (apply_edge) {
      v = p.feq_in[i];
    } else if (skip_collide) {
      v = fin[i];
    } else {
      const float eu = (float)ex_of(i) * uxc + (float)ey_of(i) * uyc;
      const float feq = w_of(i) * rho_c * (1.0f + 3.0f * eu + 4.5f * eu * eu - 1.5f * uu);
      v = fin[i] - (fin[i] - feq) * p.inv_tau;
    }
    out[i * n + cell] = v;
  }
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
