// Integral boundary-layer march for Hopper (sm_90a), plain C interface.
//
// Replaces the station scans of airfoil_tpu/viscous/march.py: march_side
// (march.py:157, a lax.scan over stations whose body runs a fixed
// 8-iteration Newton solve with a jax.jacfwd Jacobian) and march_wake
// (march.py:352). There is no Pallas kernel behind them; XLA compiles the
// scan. The plain torch version is airfoil_tpu_torch/viscous/march.py, and
// the Python wrapper is airfoil_tpu_torch/viscous/kernel.py.
//
// Design. One thread per lane (a lane is one surface side of one solve:
// the coupled solve marches its side pair as two lanes, a polar would add
// its alpha/Re points as more). The thread walks its M stations in order
// with the carry in registers. At each station it runs the 8 Newton
// iterations: the residual of the implicit interval equations is evaluated
// once on the dual type D3 (bl_closures.cuh), which gives the residual and
// its 3x3 Jacobian together (forward mode, as jax.jacfwd); the system is
// solved by Gaussian elimination with partial pivoting (what
// jnp.linalg.solve does) and the step goes through the same clip and
// non-finite guard. The clamps, sticky separation flags and transition
// bookkeeping follow march.py in its order.
//
// Bound. Neither memory (each station reads 3 floats and writes 8 values
// per lane) nor the card's throughput: a lane is a serial chain of
// ~79 x 8 dependent dual residuals of ~1,000 flops each, so a call takes
// the latency of that chain on one thread, and the card is nearly idle for
// the two lanes of one solve. The design's answer for now is only to keep
// the whole chain in one launch, where the plain torch version issues some
// 3,000 small operations per Newton iteration. Speed is later work (more
// threads per lane, one warp per lane's Jacobian columns, or many lanes).
//
// Precision: built with -fmad=false and without fast math, so each float
// operation rounds as torch's one-operation-per-kernel arithmetic does; the
// 3x3 solve and the transcendental functions may differ from torch's by
// rounding.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bl_closures.cuh"

namespace {

using bl::D3;

constexpr int kThreads = 32;
constexpr int kNewtonIters = 8;
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

template <class T>
__device__ Regime<T> regime(T theta, const T& dstar, float ue, float nu,
                            const T& ctau, bool turb, bool wake) {
  Regime<T> q;
  theta = bl::clip_lo(theta, 1e-10f);
  q.hk = bl::clip(dstar / theta, 1.02f, 12.0f);
  q.ret = bl::clip_lo(ue * theta / nu, 1.0f);
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

// Station-1 terms of the interval residual: they do not depend on the
// unknowns, so they are formed once per station.
struct Start {
  float t1, d1, a1, ctau1;
  Regime<float> q;
  float rate1, lag1;
};

__device__ Start start_terms(float t1, float d1, float a1, float ue1,
                             float nu, bool turb, bool wake) {
  Start st;
  st.t1 = t1;
  st.d1 = d1;
  st.a1 = a1;
  st.ctau1 = expf(bl::clip(a1, -20.0f, 0.0f));
  st.q = regime(t1, d1, ue1, nu, st.ctau1, turb, wake);
  if (turb) {
    const float cteq1 = bl::turb_cteq(st.q.hk, st.q.ret, st.q.hs);
    const float del1 = bl::delta_thickness(t1, d1, st.q.hk);
    st.lag1 = kKlag * (sqrtf(cteq1) - sqrtf(st.ctau1)) / (2.0f * del1);
    st.rate1 = 0.0f;
  } else {
    st.rate1 = bl::amplification_rate(st.q.hk, t1, st.q.ret);
    st.lag1 = 0.0f;
  }
  return st;
}

// march.py::_step_residual for z2 = (ln t2, ln d2, a2) seeded as duals:
// r[i].v is residual i and r[i].t[k] its derivative in z2[k].
__device__ void step_residual(const float z[3], const Start& st, float s1,
                              float ue1, float s2, float ue2, float nu,
                              bool turb, bool wake, D3 r[3]) {
  const D3 t2 = bl::texp(bl::dual(z[0], 1.0f, 0.0f, 0.0f));
  const D3 d2 = bl::texp(bl::dual(z[1], 0.0f, 1.0f, 0.0f));
  const D3 a2 = bl::dual(z[2], 0.0f, 0.0f, 1.0f);

  const float ds = bl::clip_lo(s2 - s1, 1e-8f);
  const float due = ue2 - ue1;
  const float ue_m = avg(ue1, ue2);
  const D3 t_m = avg(st.t1, t2);

  const D3 ctau2 = bl::texp(bl::clip(a2, -20.0f, 0.0f));
  const Regime<D3> q2 = regime(t2, d2, ue2, nu, ctau2, turb, wake);
  const Regime<float>& q1 = st.q;

  const D3 h_m = avg(q1.hk, q2.hk);
  const D3 hs_m = avg(q1.hs, q2.hs);
  const D3 cf_m = avg(q1.cf, q2.cf);
  const D3 cd_m = avg(q1.cd, q2.cd);

  // von Karman momentum integral
  const D3 r1 = (t2 - st.t1) / ds + (2.0f + h_m) * (t_m / ue_m) * (due / ds)
                - 0.5f * cf_m;
  // kinetic-energy shape parameter equation
  const D3 r2 = t_m * (q2.hs - q1.hs) / ds
                + hs_m * (1.0f - h_m) * (t_m / ue_m) * (due / ds)
                - (2.0f * cd_m - hs_m * 0.5f * cf_m);

  // Amplification (laminar) / shear-stress lag (turbulent)
  D3 r3;
  if (turb) {
    const D3 cteq2 = bl::turb_cteq(q2.hk, q2.ret, q2.hs);
    const D3 del2 = bl::delta_thickness(t2, d2, q2.hk);
    const D3 lag2 = kKlag * (bl::tsqrt(cteq2) - bl::tsqrt(ctau2)) / (2.0f * del2);
    r3 = (a2 - st.a1) / ds - avg(st.lag1, lag2);
  } else {
    const D3 rate2 = bl::amplification_rate(q2.hk, t2, q2.ret);
    r3 = (a2 - st.a1) / ds - avg(st.rate1, rate2);
  }

  // Scale residuals to comparable magnitude (theta is tiny).
  const D3 t_floor = bl::clip_lo(t_m, 1e-10f);
  r[0] = r1 / t_floor * ds;
  r[1] = r2 / t_floor * ds;
  r[2] = turb ? r3 * 1.0f : r3 * ds;
}

// Solves A x = b by Gaussian elimination with partial pivoting (the first
// row of largest magnitude, as LAPACK's getrf). A zero pivot gives a
// non-finite x, which the caller's guard discards.
__device__ void solve3(float a[3][3], float b[3], float x[3]) {
  for (int k = 0; k < 3; ++k) {
    int p = k;
    for (int i = k + 1; i < 3; ++i)
      if (fabsf(a[i][k]) > fabsf(a[p][k])) p = i;
    if (p != k) {
      for (int j = 0; j < 3; ++j) {
        const float tmp = a[k][j];
        a[k][j] = a[p][j];
        a[p][j] = tmp;
      }
      const float tb = b[k];
      b[k] = b[p];
      b[p] = tb;
    }
    for (int i = k + 1; i < 3; ++i) {
      const float l = a[i][k] / a[k][k];
      for (int j = k + 1; j < 3; ++j) a[i][j] -= l * a[k][j];
      b[i] -= l * b[k];
    }
  }
  for (int i = 2; i >= 0; --i) {
    float acc = b[i];
    for (int j = i + 1; j < 3; ++j) acc -= a[i][j] * x[j];
    x[i] = acc / a[i][i];
  }
}

// The fixed-count damped Newton of one station (march.py's `newton`).
__device__ void newton(float z[3], const Start& st, float s1, float ue1,
                       float s2, float ue2, float nu, bool turb, bool wake) {
  for (int it = 0; it < kNewtonIters; ++it) {
    D3 r[3];
    step_residual(z, st, s1, ue1, s2, ue2, nu, turb, wake, r);
    float a[3][3], b[3], dz[3];
    for (int i = 0; i < 3; ++i) {
      for (int k = 0; k < 3; ++k) a[i][k] = r[i].t[k];
      a[i][i] = a[i][i] + 1e-8f;
      b[i] = -r[i].v;
    }
    solve3(a, b, dz);
    bool bad = false;
    for (int i = 0; i < 3; ++i) {
      dz[i] = bl::clip(dz[i], -0.5f, 0.5f);
      bad = bad || !isfinite(dz[i]);
    }
    if (!bad)
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

__global__ void __launch_bounds__(kThreads)
march_side_kernel(const float* __restrict__ s_all,
                  const float* __restrict__ ue_all,
                  const float* __restrict__ x_all,
                  const float* __restrict__ nu_l,
                  const float* __restrict__ n_crit_l,
                  const float* __restrict__ x_forced_l, SideOut out,
                  int lanes, int m) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
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
  {
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
    const Start st = start_terms(t1, d1, a1, ue1, nu, turb2, false);
    newton(z, st, s1, ue1, s2, ue2, nu, turb2, false);

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

    const float ctau2 = expf(bl::clip(a2, -20.0f, 0.0f));
    const Regime<float> q2 = regime(t2, d2, ue2, nu, ctau2, turb2, false);
    seprun1 = lam_sep2 ? seprun1 + fabsf(x2 - x1) : 0.0f;

    const size_t j = o + k + 1;
    out.theta[j] = t2;
    out.dstar[j] = d2;
    out.hk[j] = q2.hk;
    out.cf[j] = q2.cf;
    out.amp[j] = turb2 ? NAN : a2;
    out.ctau[j] = turb2 ? ctau2 : NAN;
    out.turb[j] = turb2;
    out.sep[j] = sep;
    t1 = t2;
    d1 = d2;
    a1 = a2;
    turb1 = turb2;
    lam_sep1 = lam_sep2;
  }
  out.x_tr[lane] = xtr;
}

__global__ void __launch_bounds__(kThreads)
march_wake_kernel(const float* __restrict__ s_all,
                  const float* __restrict__ ue_all,
                  const float* __restrict__ nu_l,
                  const float* __restrict__ theta0_l,
                  const float* __restrict__ dstar0_l,
                  const float* __restrict__ ctau0_l, float* theta_o,
                  float* dstar_o, float* hk_o, int lanes, int m) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const float* s = s_all + (size_t)lane * m;
  const float* ue = ue_all + (size_t)lane * m;
  const size_t o = (size_t)lane * m;
  const float nu = nu_l[lane];
  float t1 = theta0_l[lane], d1 = dstar0_l[lane];
  float a1 = logf(bl::clip(ctau0_l[lane], 1e-7f, 0.3f));
  theta_o[o] = t1;
  dstar_o[o] = d1;
  hk_o[o] = d1 / bl::clip_lo(t1, 1e-10f);
  for (int k = 0; k + 1 < m; ++k) {
    float z[3] = {logf(bl::clip_lo(t1, 1e-10f)),
                  logf(bl::clip_lo(d1, 1e-10f)), a1};
    const Start st = start_terms(t1, d1, a1, ue[k], nu, true, true);
    newton(z, st, s[k], ue[k], s[k + 1], ue[k + 1], nu, true, true);
    float t2, d2;
    growth_clamp(z, t1, d1, &t2, &d2);
    const float a2 = bl::clip(z[2], -18.0f, -1.0f);
    // Wake Hk floor is 1 (uniform profile); cap generously.
    float hk2 = d2 / bl::clip_lo(t2, 1e-10f);
    if (hk2 > kHkWakeCap) d2 = t2 * kHkWakeCap;
    hk2 = bl::clip(hk2, 1.0f, kHkWakeCap);
    theta_o[o + k + 1] = t2;
    dstar_o[o + k + 1] = d2;
    hk_o[o + k + 1] = hk2;
    t1 = t2;
    d1 = d2;
    a1 = a2;
  }
}

int grid_for(int lanes) { return (lanes + kThreads - 1) / kThreads; }

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
  march_side_kernel<<<grid_for(lanes), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      s, ue, x, nu, n_crit, x_forced, out, lanes, m);
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
  march_wake_kernel<<<grid_for(lanes), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      s, ue, nu, theta0, dstar0, ctau0, theta, dstar, hk, lanes, m);
  return cudaGetLastError();
}

const char* bl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
