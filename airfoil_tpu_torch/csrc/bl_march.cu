// Integral boundary-layer march for Hopper (sm_90a), plain C interface.
//
// Replaces the station scans of airfoil_tpu/viscous/march.py: march_side
// (march.py:157, a lax.scan over stations whose body runs a fixed
// 8-iteration Newton solve with a jax.jacfwd Jacobian) and march_wake
// (march.py:352). There is no Pallas kernel behind them; XLA compiles the
// scan. The plain torch version is airfoil_tpu_torch/viscous/march.py, and
// the Python wrapper is airfoil_tpu_torch/viscous/kernel.py.
//
// Design. One block of two warps per lane (a lane is one surface side of
// one solve, or one wake: the coupled solve marches its side pair as two
// lanes, a polar would add its alpha/Re points as more), so two lanes never
// share a warp and a laminar side and a turbulent one run their own
// branches at the same time. In each warp of the block, thread k evaluates
// residuals of the implicit interval equations on the one-tangent dual D1
// (bl_closures.cuh) seeded in unknown k, which gives their values and
// column k of their Jacobian rows (forward mode, as jax.jacfwd). Warp 0
// evaluates the momentum and kinetic-energy equations (rows 0 and 1, the
// station's closures) and warp 1 the amplification or shear-lag equation
// (row 2) at the same time. The rows meet in a 48 B Jacobian in shared memory behind one barrier per
// Newton iteration, and every thread solves the same 3x3 system by Gaussian
// elimination with partial pivoting (what jnp.linalg.solve does), so all
// keep identical unknowns without a broadcast. Branches depend only on
// values, which every thread computes alike, so no warp diverges. The
// threads walk the lane's M stations in order with the carry in registers:
// 8 Newton iterations a station, the same clip and non-finite guard, the
// clamps, sticky separation flags and transition bookkeeping of march.py in
// its order; one thread stores. The 3x3 solve and the knot table of
// amp_h_mod use compile-time indices only (selects for the pivot swap), so
// nothing goes to local memory.
//
// Bound. Neither memory (each station reads 3 floats and writes 8 values
// per lane) nor the card's throughput at a few lanes: a lane is a serial
// chain of ~79 x 8 dependent residual evaluations and 3x3 solves, so a
// call takes the latency of that chain, and a side pair keeps 4 warps of
// the card's 132 SMs busy. Most of that latency is the chain's IEEE
// divisions (two per dual division) and precise expf/logf/powf/tanhf; fast
// math would shorten them but rounds otherwise than torch, so it is not
// used. What the design does: it removes the two sides' divergence,
// divides the dual arithmetic of one thread by about three (one tangent
// instead of three), runs the third equation beside the other two, and
// keeps everything in registers. Many lanes run on their own blocks in one
// launch at nearly the time of one, until the card runs out of issue slots
// or registers: a lane holds 64 threads of about 72 registers, so an H100
// keeps 14 lanes an SM resident, and a call of more lanes (1,848 on its 132
// SMs) takes a second wave.
//
// Precision: built with -fmad=false and without fast math, so each float
// operation rounds as torch's one-operation-per-kernel arithmetic does; the
// 3x3 solve and the transcendental functions may differ from torch's by
// rounding. A D1 tangent is the expression of the same tangent of a dual
// with three, and each warp computes what it reads by the same operations,
// so the kernel computes what a one-thread, three-tangent evaluation
// computes, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bl_closures.cuh"

namespace {

using bl::D1;

// One block of kWarps warps per lane; in each warp threads 0..kCols-1
// carry the Jacobian's columns and the others repeat the last.
constexpr int kWarps = 2;
constexpr int kCols = 3;
constexpr int kNewtonIters = 8;
static_assert(kNewtonIters % 2 == 0, "a station starts on Jacobian buffer 0");
constexpr float kAvgW = 0.7f;
constexpr float kAvgW1 = 0.3f;   // 1 - kAvgW, as float32(1.0 - 0.7)
constexpr float kKlag = 5.6f;
constexpr float kHkReset = 1.55f;
constexpr float kCtauInitFactor = 0.7f;
constexpr float kHkWakeCap = 10.0f;

template <class A, class B>
__device__ __forceinline__ auto avg(const A& f1, const B& f2) {
  return kAvgW1 * f1 + kAvgW * f2;
}

// Closure values at one station (march.py::_regime_quantities).
template <class T>
struct Regime {
  T hk, ret, hs, cf, cd;
};

// Its first two: the shape factor and the momentum-thickness Reynolds number.
template <class T>
__device__ __forceinline__ void shape_re(T theta, const T& dstar, float ue,
                                         float nu, T& hk, T& ret) {
  theta = bl::clip_lo(theta, 1e-10f);
  hk = bl::clip(dstar / theta, 1.02f, 12.0f);
  ret = bl::clip_lo(ue * theta / nu, 1.0f);
}

template <class T>
__device__ Regime<T> regime(const T& theta, const T& dstar, float ue,
                            float nu, const T& ctau, bool turb, bool wake) {
  Regime<T> q;
  shape_re(theta, dstar, ue, nu, q.hk, q.ret);
  if (turb) {
    q.hs = bl::turb_hstar(q.hk, q.ret);
    q.cf = bl::turb_cf(q.hk, q.ret);
    const T us = bl::turb_us(q.hk, q.hs);
    q.cd = 0.5f * q.cf * us + bl::clip(ctau, 0.0f, 0.3f) * (1.0f - us);
  } else {
    q.hs = bl::lam_hstar(q.hk);
    q.cf = bl::lam_cf(q.hk, q.ret);
    q.cd = bl::lam_diss(q.hk, q.ret, q.hs);
  }
  if (wake) {
    q.cf = bl::constant<T>(0.0f);
    const T us = bl::turb_us(q.hk, q.hs);
    q.cd = bl::clip(ctau, 0.0f, 0.3f) * (1.0f - us);
  }
  return q;
}

// What one thread of a lane's block does: its Jacobian column (`col`,
// written if `writer`), which residuals it evaluates (rows 0 and 1 in warp
// 0, row 2 in warp 1), and whether it stores the outputs.
struct Role {
  int col;
  bool writer, rows12, row3, store;
  __device__ Role() {
    const int t = threadIdx.x % 32, warp = threadIdx.x / 32;
    col = t < kCols ? t : kCols - 1;
    writer = t < kCols;
    rows12 = warp == 0;
    row3 = warp == kWarps - 1;
    store = row3 && t == 0;
  }
};

// Station-1 terms of the interval residual: they do not depend on the
// unknowns, so they are formed once per station, each warp for its own
// rows: the closures of station 1 for rows 0 and 1, the amplification rate
// or shear lag and what they read for row 2.
struct Start {
  float t1, d1, a1, ctau1;
  Regime<float> q;
  float rate1, lag1;
};

__device__ Start start_terms(float t1, float d1, float a1, float ue1,
                             float nu, bool turb, bool wake, bool rows12,
                             bool row3) {
  Start st{};
  st.t1 = t1;
  st.d1 = d1;
  st.a1 = a1;
  st.ctau1 = expf(bl::clip(a1, -20.0f, 0.0f));
  if (rows12) st.q = regime(t1, d1, ue1, nu, st.ctau1, turb, wake);
  if (!row3) return st;
  if (!rows12) shape_re(t1, d1, ue1, nu, st.q.hk, st.q.ret);
  if (turb) {
    if (!rows12) st.q.hs = bl::turb_hstar(st.q.hk, st.q.ret);
    const float cteq1 = bl::turb_cteq(st.q.hk, st.q.ret, st.q.hs);
    const float del1 = bl::delta_thickness(t1, d1, st.q.hk);
    st.lag1 = kKlag * (sqrtf(cteq1) - sqrtf(st.ctau1)) / (2.0f * del1);
  } else {
    st.rate1 = bl::amplification_rate(st.q.hk, t1, st.q.ret);
  }
  return st;
}

// march.py::_step_residual for z2 = (ln t2, ln d2, a2), with z2[col]
// seeded as the dual direction: r.v is a residual and r.t its derivative in
// z2[col]. Split in two by equation: the scaled momentum and kinetic-energy
// residuals (r[0], r[1]) here, the third in step_residual3. Each computes
// what it reads of station 2 by the same operations, so the split changes
// no value.
struct Unknowns {
  D1 t2, d2, a2;
};

__device__ __forceinline__ Unknowns seed(const float z[3], int col) {
  return {bl::texp(bl::dual(z[0], col == 0 ? 1.0f : 0.0f)),
          bl::texp(bl::dual(z[1], col == 1 ? 1.0f : 0.0f)),
          bl::dual(z[2], col == 2 ? 1.0f : 0.0f)};
}

__device__ __forceinline__ void step_residual12(
    const float z[3], int col, const Start& st, float s1, float ue1,
    float s2, float ue2, float nu, bool turb, bool wake, D1 r[2]) {
  const Unknowns u = seed(z, col);
  const D1& t2 = u.t2;

  const float ds = bl::clip_lo(s2 - s1, 1e-8f);
  const float due = ue2 - ue1;
  const float ue_m = avg(ue1, ue2);
  const D1 t_m = avg(st.t1, t2);

  const D1 ctau2 = bl::texp(bl::clip(u.a2, -20.0f, 0.0f));
  const Regime<D1> q2 = regime(t2, u.d2, ue2, nu, ctau2, turb, wake);
  const Regime<float>& q1 = st.q;

  const D1 h_m = avg(q1.hk, q2.hk);
  const D1 hs_m = avg(q1.hs, q2.hs);
  const D1 cf_m = avg(q1.cf, q2.cf);
  const D1 cd_m = avg(q1.cd, q2.cd);

  // von Karman momentum integral
  const D1 r1 = (t2 - st.t1) / ds + (2.0f + h_m) * (t_m / ue_m) * (due / ds)
                - 0.5f * cf_m;
  // kinetic-energy shape parameter equation
  const D1 r2 = t_m * (q2.hs - q1.hs) / ds
                + hs_m * (1.0f - h_m) * (t_m / ue_m) * (due / ds)
                - (2.0f * cd_m - hs_m * 0.5f * cf_m);

  // Scale residuals to comparable magnitude (theta is tiny).
  const D1 t_floor = bl::clip_lo(t_m, 1e-10f);
  r[0] = r1 / t_floor * ds;
  r[1] = r2 / t_floor * ds;
}

// Amplification (laminar) / shear-stress lag (turbulent), scaled.
__device__ __forceinline__ D1 step_residual3(const float z[3], int col,
                                             const Start& st, float s1,
                                             float s2, float ue2, float nu,
                                             bool turb) {
  const Unknowns u = seed(z, col);
  const float ds = bl::clip_lo(s2 - s1, 1e-8f);
  D1 hk2, ret2;
  shape_re(u.t2, u.d2, ue2, nu, hk2, ret2);
  if (turb) {
    const D1 ctau2 = bl::texp(bl::clip(u.a2, -20.0f, 0.0f));
    const D1 hs2 = bl::turb_hstar(hk2, ret2);
    const D1 cteq2 = bl::turb_cteq(hk2, ret2, hs2);
    const D1 del2 = bl::delta_thickness(u.t2, u.d2, hk2);
    const D1 lag2 = kKlag * (bl::tsqrt(cteq2) - bl::tsqrt(ctau2)) / (2.0f * del2);
    const D1 r3 = (u.a2 - st.a1) / ds - avg(st.lag1, lag2);
    return r3 * 1.0f;
  }
  const D1 rate2 = bl::amplification_rate(hk2, u.t2, ret2);
  const D1 r3 = (u.a2 - st.a1) / ds - avg(st.rate1, rate2);
  return r3 * ds;
}

__device__ __forceinline__ void swap_if(bool c, float& x, float& y) {
  const float tx = x;
  x = c ? y : x;
  y = c ? tx : y;
}

// Solves A x = b by Gaussian elimination with partial pivoting (the first
// row of largest magnitude, as LAPACK's getrf). A zero pivot gives a
// non-finite x, which the caller's guard discards. Every index is a
// compile-time constant and the row swap is a select, so a, b and x stay
// in registers.
__device__ __forceinline__ void solve3(float a[3][3], float b[3],
                                       float x[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int p = k;
    float best = fabsf(a[k][k]);
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      const bool more = fabsf(a[i][k]) > best;
      p = more ? i : p;
      best = more ? fabsf(a[i][k]) : best;
    }
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) swap_if(p == i, a[k][j], a[i][j]);
      swap_if(p == i, b[k], b[i]);
    }
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      const float l = a[i][k] / a[k][k];
#pragma unroll
      for (int j = k + 1; j < 3; ++j) a[i][j] -= l * a[k][j];
      b[i] -= l * b[k];
    }
  }
#pragma unroll
  for (int i = 2; i >= 0; --i) {
    float acc = b[i];
#pragma unroll
    for (int j = i + 1; j < 3; ++j) acc -= a[i][j] * x[j];
    x[i] = acc / a[i][i];
  }
}

// The Jacobian of one Newton iteration: rows 0..2, columns 0..2 and the
// residual's value in column 3. Two of them alternate by iteration, so one
// barrier per iteration suffices: a warp writes buffer it % 2 only after the
// barrier of iteration it - 1, which the other passes only after reading
// buffer it % 2 in iteration it - 2.
using Jacobian = float[3][4];

// The fixed-count damped Newton of one station (march.py's `newton`), run
// alike by all the lane's threads: thread `col` of a warp evaluates column
// `col` of the warp's rows of the Jacobian; the barrier gives every thread
// the whole system.
__device__ __forceinline__ void newton(float z[3], const Role& role,
                                       Jacobian* jac, const Start& st,
                                       float s1, float ue1, float s2,
                                       float ue2, float nu, bool turb,
                                       bool wake) {
  const int col = role.col;
#pragma unroll 1
  for (int it = 0; it < kNewtonIters; ++it) {
    float(*J)[4] = jac[it & 1];
    if (role.rows12) {
      D1 r[2];
      step_residual12(z, col, st, s1, ue1, s2, ue2, nu, turb, wake, r);
      if (role.writer) {
        J[0][col] = r[0].t;
        J[1][col] = r[1].t;
        if (col == 0) {
          J[0][3] = r[0].v;
          J[1][3] = r[1].v;
        }
      }
    }
    if (role.row3) {
      const D1 r = step_residual3(z, col, st, s1, s2, ue2, nu, turb);
      if (role.writer) {
        J[2][col] = r.t;
        if (col == 0) J[2][3] = r.v;
      }
    }
    __syncthreads();
    float a[3][3], b[3], dz[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int k = 0; k < 3; ++k) a[i][k] = J[i][k];
      a[i][i] = a[i][i] + 1e-8f;
      b[i] = -J[i][3];
    }
    solve3(a, b, dz);
    bool bad = false;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      dz[i] = bl::clip(dz[i], -0.5f, 0.5f);
      bad = bad || !isfinite(dz[i]);
    }
    if (!bad)
#pragma unroll
      for (int i = 0; i < 3; ++i) z[i] = z[i] + dz[i];
  }
}

// Per-step growth clamp: theta and dstar may at most double per station.
__device__ void growth_clamp(const float z[3], float t1, float d1, float* t2,
                             float* d2) {
  const float lt1 = logf(bl::clip_lo(t1, 1e-10f));
  const float ld1 = logf(bl::clip_lo(d1, 1e-10f));
  const float z0 = bl::tmin(bl::tmax(z[0], lt1 - 0.7f), lt1 + 0.7f);
  const float z1 = bl::tmin(bl::tmax(z[1], ld1 - 0.7f), ld1 + 0.7f);
  *t2 = expf(bl::clip(z0, -23.0f, 0.0f));
  *d2 = expf(bl::clip(z1, -23.0f, 1.0f));
}

struct SideOut {
  float *theta, *dstar, *hk, *cf, *amp, *ctau, *x_tr;
  uint8_t *turb, *sep;
};

__global__ void __launch_bounds__(32 * kWarps)
march_side_kernel(const float* __restrict__ s_all,
                  const float* __restrict__ ue_all,
                  const float* __restrict__ x_all,
                  const float* __restrict__ nu_l,
                  const float* __restrict__ n_crit_l,
                  const float* __restrict__ x_forced_l, SideOut out,
                  int lanes, int m) {
  const int lane = blockIdx.x;
  if (lane >= lanes) return;
  const Role role;
  const bool store = role.store;
  __shared__ Jacobian jac[2];
  const float* s = s_all + (size_t)lane * m;
  const float* ue = ue_all + (size_t)lane * m;
  const float* x = x_all + (size_t)lane * m;
  const size_t o = (size_t)lane * m;
  const float nu = nu_l[lane], n_crit = n_crit_l[lane];
  const float x_forced = x_forced_l[lane];

  // Stagnation-point initial condition (stagnation_ic).
  const float kk = bl::clip_lo(ue[0] / bl::clip_lo(s[0], 1e-8f), 1e-6f);
  const float theta0 = sqrtf(0.075f * nu / kk);
  const float dstar0 = 2.24f * theta0;
  if (store) {
    const float hk0 = dstar0 / theta0;
    const float ret0 = bl::clip_lo(ue[0] * theta0 / nu, 1.0f);
    out.theta[o] = theta0;
    out.dstar[o] = dstar0;
    out.hk[o] = hk0;
    out.cf[o] = bl::lam_cf(hk0, ret0);
    out.amp[o] = 0.0f;
    out.ctau[o] = NAN;
    out.turb[o] = 0;
    out.sep[o] = 0;
  }

  // Trip coordinate: x masked to -1 before the leading edge (the first
  // station of minimum x).
  int i_le = 0;
  for (int k = 1; k < m; ++k)
    if (x[k] < x[i_le]) i_le = k;

  float t1 = theta0, d1 = dstar0, a1 = 0.0f, seprun1 = 0.0f;
  bool turb1 = false, tripped = false, lam_sep1 = false;
  float xtr = x[m - 1];
  for (int k = 0; k + 1 < m; ++k) {
    const float s1 = s[k], ue1 = ue[k], x1 = x[k];
    const float s2 = s[k + 1], ue2 = ue[k + 1], x2 = x[k + 1];
    const float xt1 = k >= i_le ? x1 : -1.0f;

    // Transition trigger at interval start: free, tripped, or a laminar
    // separation that has run 0.05c.
    const bool becomes_turb =
        !turb1 && (a1 >= n_crit || xt1 >= x_forced || seprun1 > 0.05f);
    const bool turb2 = turb1 || becomes_turb;
    if (becomes_turb && !tripped) xtr = x1;
    tripped = tripped || becomes_turb;

    // Transition treatment: theta continuous, Hk reset, ctau from
    // equilibrium.
    if (becomes_turb) {
      d1 = bl::tmin(d1, t1 * kHkReset);
      const float hk1 = bl::clip(d1 / bl::clip_lo(t1, 1e-10f), 1.02f, 12.0f);
      const float ret1 = bl::clip_lo(ue1 * t1 / nu, 1.0f);
      const float hs1 = bl::turb_hstar(hk1, ret1);
      const float cteq1 = bl::turb_cteq(hk1, ret1, hs1);
      a1 = logf(cteq1 * kCtauInitFactor);
    }

    float z[3] = {logf(bl::clip_lo(t1, 1e-10f)),
                  logf(bl::clip_lo(d1, 1e-10f)), a1};
    const Start st = start_terms(t1, d1, a1, ue1, nu, turb2, false,
                                 role.rows12, role.row3);
    newton(z, role, jac, st, s1, ue1, s2, ue2, nu, turb2, false);

    float t2, d2;
    growth_clamp(z, t1, d1, &t2, &d2);
    float a2 = bl::tmin(bl::tmax(z[2], a1 - 3.0f), a1 + 3.0f);

    // Cap Hk to step over the separation singularity; a separated laminar
    // layer stays pinned at the cap until transition.
    const float hk_cap = turb2 ? bl::kHkTurbMax : bl::kHkLamMax;
    const float hk2_raw = d2 / bl::clip_lo(t2, 1e-10f);
    bool sep = hk2_raw > hk_cap;
    if (sep) d2 = hk_cap * t2;
    const bool lam_sep2 = !turb2 && (lam_sep1 || hk2_raw > 4.05f);
    if (lam_sep2) d2 = bl::tmax(t2 * bl::kHkLamMax, d2);
    sep = sep || lam_sep2;
    a2 = turb2 ? bl::clip(a2, -18.0f, -1.0f) : bl::clip(a2, 0.0f, 30.0f);
    if (!turb2) {
      // Laminar amplification integrated explicitly from the solved states.
      const float hk1e = bl::clip(d1 / bl::clip_lo(t1, 1e-10f), 1.02f, 12.0f);
      const float ret1e = bl::clip_lo(ue1 * t1 / nu, 1.0f);
      const float hk2e = bl::clip(d2 / bl::clip_lo(t2, 1e-10f), 1.02f, 12.0f);
      const float ret2e = bl::clip_lo(ue2 * t2 / nu, 1.0f);
      const float rate_lam = avg(bl::amplification_rate(hk1e, t1, ret1e),
                                 bl::amplification_rate(hk2e, t2, ret2e));
      const float ds12 = bl::clip_lo(s2 - s1, 1e-8f);
      a2 = bl::clip(a1 + ds12 * rate_lam, 0.0f, 30.0f);
    }

    seprun1 = lam_sep2 ? seprun1 + fabsf(x2 - x1) : 0.0f;

    if (store) {
      const float ctau2 = expf(bl::clip(a2, -20.0f, 0.0f));
      const Regime<float> q2 = regime(t2, d2, ue2, nu, ctau2, turb2, false);
      const size_t j = o + k + 1;
      out.theta[j] = t2;
      out.dstar[j] = d2;
      out.hk[j] = q2.hk;
      out.cf[j] = q2.cf;
      out.amp[j] = turb2 ? NAN : a2;
      out.ctau[j] = turb2 ? ctau2 : NAN;
      out.turb[j] = turb2;
      out.sep[j] = sep;
    }
    t1 = t2;
    d1 = d2;
    a1 = a2;
    turb1 = turb2;
    lam_sep1 = lam_sep2;
  }
  if (store) out.x_tr[lane] = xtr;
}

__global__ void __launch_bounds__(32 * kWarps)
march_wake_kernel(const float* __restrict__ s_all,
                  const float* __restrict__ ue_all,
                  const float* __restrict__ nu_l,
                  const float* __restrict__ theta0_l,
                  const float* __restrict__ dstar0_l,
                  const float* __restrict__ ctau0_l, float* theta_o,
                  float* dstar_o, float* hk_o, int lanes, int m) {
  const int lane = blockIdx.x;
  if (lane >= lanes) return;
  const Role role;
  const bool store = role.store;
  __shared__ Jacobian jac[2];
  const float* s = s_all + (size_t)lane * m;
  const float* ue = ue_all + (size_t)lane * m;
  const size_t o = (size_t)lane * m;
  const float nu = nu_l[lane];
  float t1 = theta0_l[lane], d1 = dstar0_l[lane];
  float a1 = logf(bl::clip(ctau0_l[lane], 1e-7f, 0.3f));
  if (store) {
    theta_o[o] = t1;
    dstar_o[o] = d1;
    hk_o[o] = d1 / bl::clip_lo(t1, 1e-10f);
  }
  for (int k = 0; k + 1 < m; ++k) {
    float z[3] = {logf(bl::clip_lo(t1, 1e-10f)),
                  logf(bl::clip_lo(d1, 1e-10f)), a1};
    const Start st = start_terms(t1, d1, a1, ue[k], nu, true, true,
                                 role.rows12, role.row3);
    newton(z, role, jac, st, s[k], ue[k], s[k + 1], ue[k + 1], nu, true,
           true);
    float t2, d2;
    growth_clamp(z, t1, d1, &t2, &d2);
    const float a2 = bl::clip(z[2], -18.0f, -1.0f);
    // Wake Hk floor is 1 (uniform profile); cap generously.
    float hk2 = d2 / bl::clip_lo(t2, 1e-10f);
    if (hk2 > kHkWakeCap) d2 = t2 * kHkWakeCap;
    hk2 = bl::clip(hk2, 1.0f, kHkWakeCap);
    if (store) {
      theta_o[o + k + 1] = t2;
      dstar_o[o + k + 1] = d2;
      hk_o[o + k + 1] = hk2;
    }
    t1 = t2;
    d1 = d2;
    a1 = a2;
  }
}

}  // namespace

extern "C" {

// Marches `lanes` sides of `m` stations each (row-major (lanes, m) inputs
// and outputs, per-lane nu, n_crit and forced-transition x) on `stream`.
// All pointers are device pointers. Returns the launch's CUDA error (0 on
// success). Does not synchronise.
int bl_march_side_launch(const float* s, const float* ue, const float* x,
                         const float* nu, const float* n_crit,
                         const float* x_forced, float* theta, float* dstar,
                         float* hk, float* cf, float* amp, float* ctau,
                         uint8_t* turb, uint8_t* sep, float* x_tr, int lanes,
                         int m, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  SideOut out{theta, dstar, hk, cf, amp, ctau, x_tr, turb, sep};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  march_side_kernel<<<lanes, 32 * kWarps, 0, st>>>(s, ue, x, nu, n_crit,
                                                   x_forced, out, lanes, m);
  return cudaGetLastError();
}

// Marches `lanes` wakes of `m` stations from their merged TE states.
int bl_march_wake_launch(const float* s, const float* ue, const float* nu,
                         const float* theta0, const float* dstar0,
                         const float* ctau0, float* theta, float* dstar,
                         float* hk, int lanes, int m, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  march_wake_kernel<<<lanes, 32 * kWarps, 0, st>>>(
      s, ue, nu, theta0, dstar0, ctau0, theta, dstar, hk, lanes, m);
  return cudaGetLastError();
}

const char* bl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
