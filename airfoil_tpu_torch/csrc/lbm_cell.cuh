// D2Q9 per-cell arithmetic shared by the two LBM kernels of the port
// (lbm_steps.cu, one step per launch; lbm_steps_tiled.cu, K steps per
// launch in shared memory). Both kernels pull the 9 values of a cell, then
// call lbm_cell(), so for the same pulled values they produce the same
// bits: the tiled kernel is held to the one-step kernel with max abs 0.
//
// The arithmetic is airfoil_tpu_torch/lbm/core.py::step_body after the
// streaming gather: rho, u, the stability clamps, BGK collision, the
// equilibrium edges and the solid/outlet selects, in the reference's order.
// Precision: built without fast math, so 1/rho, sqrtf and the clamp's
// division are IEEE; nvcc contracts multiply-adds into FMAs.

#pragma once

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

// v modulo n for v in [-n, 2n): one period either way.
__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

struct StepParams {
  float feq_in[9];  // equilibrium at (rho=1, u=(U0,0)) for inlet/top/bottom
  float inv_tau;
};

// Per-cell bounce word, bit i set where direction i bounces back (the cell
// itself or its streaming source x - e_i is solid); bit 0 is "own cell is
// solid". Computed once per call: the mask does not change between steps.
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

// Boundary roles from global coordinates: the last column is the outlet
// (it wins at the right-hand corners); the first column, first row and
// last row take the edge equilibrium.
__device__ __forceinline__ bool is_outlet_at(int x, int nx) { return x == nx - 1; }
__device__ __forceinline__ bool is_edge_eq_at(int y, int x, int ny, int nx) {
  return (x == 0 || y == 0 || y == ny - 1) && x != nx - 1;
}

// Everything after the pull: `fin` holds the 9 streamed values of one cell
// (after bounce-back and the outlet copy) and is overwritten in place with
// the cell's 9 new values.
__device__ __forceinline__ void lbm_cell(float (&fin)[9], bool is_solid,
                                         bool is_outlet, bool is_edge_eq,
                                         const StepParams& p) {
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
    fin[i] = v;
  }
}

}  // namespace
