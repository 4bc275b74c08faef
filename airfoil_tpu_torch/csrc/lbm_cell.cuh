// D2Q9 per-cell arithmetic shared by the two LBM kernels of the port
// (lbm_steps.cu, the whole lattice resident on chip for a call;
// lbm_steps_tiled.cu, K steps per launch on tiles). Both kernels pull the 9
// values of a cell from a window in shared memory with pull_window(), then
// call lbm_cell(), so for the same pulled values they produce the same bits:
// the tiled kernel is held to the resident one with max abs 0.
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

// The static cell word (lbm/kernel.py::cell_word): bit i (0-8) set where
// direction i bounces back (the cell itself or its streaming source x - e_i
// is solid; bit 0 is "own cell is solid"), bit 9 the outlet column, bit 10
// the edge equilibrium (first column, first and last row; the outlet wins
// at the right-hand corners).
constexpr unsigned kOutletBit = 1u << 9;
constexpr unsigned kEdgeBit = 1u << 10;

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

// Stream (gather from x - e_i), bounce back, outlet copy: the 9 values that
// window cell `cell` pulls from `src` ([9][plane] floats, rows `pitch`
// apart) under its cell word `b`. The outlet copies its left neighbour's
// pre-stream values; a bounced direction takes the cell's own opposite one.
__device__ __forceinline__ void pull_window(float (&fin)[9], const float* src,
                                            int plane, int cell, int pitch,
                                            unsigned b) {
  const bool is_outlet = b & kOutletBit;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    // Selects, not branches: one shared-memory read per direction.
    int from = ((b >> i) & 1u) ? opp_of(i) * plane + cell
                               : i * plane + cell - ey_of(i) * pitch - ex_of(i);
    from = is_outlet ? i * plane + cell - 1 : from;
    fin[i] = src[from];
  }
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
    // Every cell computes the collision and then selects, so a warp whose
    // cells differ in role does not branch.
    const float eu = (float)ex_of(i) * uxc + (float)ey_of(i) * uyc;
    const float feq = w_of(i) * rho_c * (1.0f + 3.0f * eu + 4.5f * eu * eu - 1.5f * uu);
    const float collided = fin[i] - (fin[i] - feq) * p.inv_tau;
    fin[i] = apply_edge ? p.feq_in[i] : (skip_collide ? fin[i] : collided);
  }
}

// Pull, then step, one window cell under its cell word.
__device__ __forceinline__ void step_cell(float (&fin)[9], const float* src,
                                          int plane, int cell, int pitch,
                                          unsigned b, const StepParams& p) {
  pull_window(fin, src, plane, cell, pitch, b);
  lbm_cell(fin, b & 1u, b & kOutletBit, b & kEdgeBit, p);
}

}  // namespace
