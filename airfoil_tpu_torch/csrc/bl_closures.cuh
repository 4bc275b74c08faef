// Integral boundary-layer closures for Hopper (sm_90a), templated on the
// scalar type: `float`, or `D1`, a forward-mode dual number carrying one
// tangent. Evaluating a residual on D1 seeded in unknown k gives its value
// and its derivative in unknown k: one column of the Jacobian (the forward
// mode of jax.jacfwd, one direction per evaluation). The march kernel runs
// the three columns on three threads of a warp.
//
// Port of airfoil_tpu/viscous/closures.py; the plain torch version is
// airfoil_tpu_torch/viscous/closures.py, evaluated there on tensors or on
// numerics.Dual. Each function below follows the torch version operation by
// operation, in its order, so that, built with -fmad=false, the values are
// the ones torch computes on the card. The rules that matter:
//   - jnp.maximum/minimum/clip propagate NaN and split the derivative
//     0.5/0.5 at a tie (tmax/tmin/clip here);
//   - jnp.where selects, so a NaN in the branch not taken (e.g. (4-hk)^5.5
//     for hk > 4) reaches neither the value nor the tangent: here the
//     branch not taken is not evaluated at all;
//   - x**2 and x**3 are products (jnp's integer_pow, torch's pow special
//     cases), other powers powf;
//   - jnp.log10(x) is log(x) * 0.4342944920063019.
// A D1 tangent is the same expression as the tangent of the same direction
// in a dual with three tangents, so the Jacobian does not depend on how
// many columns one evaluation carries.
//
// Shared by the march kernel (bl_march.cu) and meant for the later Newton
// solver's kernel. cuda_build counts every csrc/*.cuh as a dependency of
// every library, so editing this header also rebuilds the LBM libraries.
#pragma once

#include <math.h>

namespace bl {

struct D1 {
  float v;  // value
  float t;  // tangent in the seeded direction
};

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(const D1& x) { return x.v; }

__device__ __forceinline__ D1 dual(float v, float t) { return D1{v, t}; }

template <class T>
__device__ __forceinline__ T constant(float c);
template <>
__device__ __forceinline__ float constant<float>(float c) { return c; }
template <>
__device__ __forceinline__ D1 constant<D1>(float c) { return dual(c, 0.0f); }

// ── D1 arithmetic (the rules of numerics.Dual) ─────────────────────────────
__device__ __forceinline__ D1 operator-(const D1& a) { return dual(-a.v, -a.t); }
__device__ __forceinline__ D1 operator+(const D1& a, const D1& b) {
  return dual(a.v + b.v, a.t + b.t);
}
__device__ __forceinline__ D1 operator+(const D1& a, float c) {
  return dual(a.v + c, a.t);
}
__device__ __forceinline__ D1 operator+(float c, const D1& a) {
  return dual(a.v + c, a.t);
}
__device__ __forceinline__ D1 operator-(const D1& a, const D1& b) {
  return dual(a.v - b.v, a.t + -b.t);
}
__device__ __forceinline__ D1 operator-(const D1& a, float c) {
  return dual(a.v - c, a.t);
}
__device__ __forceinline__ D1 operator-(float c, const D1& a) {
  return dual(c - a.v, -a.t);
}
__device__ __forceinline__ D1 operator*(const D1& a, const D1& b) {
  return dual(a.v * b.v, a.t * b.v + b.t * a.v);
}
__device__ __forceinline__ D1 operator*(const D1& a, float c) {
  return dual(a.v * c, a.t * c);
}
__device__ __forceinline__ D1 operator*(float c, const D1& a) { return a * c; }
__device__ __forceinline__ D1 operator/(const D1& a, const D1& b) {
  const float out = a.v / b.v;
  const float m = -out;
  return dual(out, (a.t + b.t * m) / b.v);
}
__device__ __forceinline__ D1 operator/(const D1& a, float c) {
  return dual(a.v / c, a.t / c);
}
__device__ __forceinline__ D1 operator/(float c, const D1& b) {
  const float out = c / b.v;
  const float m = -out;
  return dual(out, b.t * m / b.v);
}

// ── Elementary functions ───────────────────────────────────────────────────
__device__ __forceinline__ float texp(float x) { return expf(x); }
__device__ __forceinline__ D1 texp(const D1& x) {
  const float e = expf(x.v);
  return dual(e, x.t * e);
}
__device__ __forceinline__ float tlog(float x) { return logf(x); }
__device__ __forceinline__ D1 tlog(const D1& x) {
  return dual(logf(x.v), x.t / x.v);
}
__device__ __forceinline__ float tsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ D1 tsqrt(const D1& x) {
  const float s = sqrtf(x.v);
  const float d = 0.5f / s;
  return dual(s, x.t * d);
}
__device__ __forceinline__ float ttanh(float x) { return tanhf(x); }
__device__ __forceinline__ D1 ttanh(const D1& x) {
  const float th = tanhf(x.v);
  const float d = 1.0f - th * th;
  return dual(th, x.t * d);
}
template <class T>
__device__ __forceinline__ T tlog10(const T& x) {
  return tlog(x) * 0.4342944920063019f;
}

// x**2, x**3 (products, as torch's and jnp's integer powers), x**p (powf).
__device__ __forceinline__ float sq(float x) { return x * x; }
__device__ __forceinline__ D1 sq(const D1& x) {
  const float d = x.v * 2.0f;
  return dual(x.v * x.v, x.t * d);
}
__device__ __forceinline__ float cube(float x) { return x * x * x; }
__device__ __forceinline__ D1 cube(const D1& x) {
  const float d = 3.0f * (x.v * x.v);
  return dual(x.v * x.v * x.v, x.t * d);
}
__device__ __forceinline__ float tpow(float x, float p) { return powf(x, p); }
__device__ __forceinline__ D1 tpow(const D1& x, float p) {
  const float d = p * powf(x.v, p - 1.0f);
  return dual(powf(x.v, p), x.t * d);
}
// x**y with both dual (d/dy = log(x) x^y, log(1) at x = 0 as in JAX).
__device__ __forceinline__ D1 tpow(const D1& x, const D1& y) {
  const float out = powf(x.v, y.v);
  const float dx = y.v * powf(x.v, y.v - 1.0f);
  const float dy = logf(x.v == 0.0f ? 1.0f : x.v) * out;
  return dual(out, x.t * dx + y.t * dy);
}

// jnp.maximum / jnp.minimum: NaN if either operand is NaN; the tangent of
// the operand that wins, the mean of both at a tie.
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? NAN : (a > b ? a : b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? NAN : (a < b ? a : b);
}
__device__ __forceinline__ D1 pick(bool a_wins, bool b_wins, const D1& a,
                                   const D1& b, float out) {
  return dual(out, a_wins ? a.t : (b_wins ? b.t : 0.5f * (a.t + b.t)));
}
__device__ __forceinline__ D1 tmax(const D1& a, const D1& b) {
  return pick(a.v > b.v, b.v > a.v, a, b, tmax(a.v, b.v));
}
__device__ __forceinline__ D1 tmin(const D1& a, const D1& b) {
  return pick(a.v < b.v, b.v < a.v, a, b, tmin(a.v, b.v));
}
__device__ __forceinline__ D1 tmax(const D1& a, float c) {
  return tmax(a, dual(c, 0.0f));
}
__device__ __forceinline__ D1 tmin(const D1& a, float c) {
  return tmin(a, dual(c, 0.0f));
}

// jnp.clip(x, lo, hi) = minimum(hi, maximum(lo, x)).
template <class T>
__device__ __forceinline__ T clip(const T& x, float lo, float hi) {
  return tmin(tmax(x, lo), hi);
}
template <class T>
__device__ __forceinline__ T clip_lo(const T& x, float lo) {
  return tmax(x, lo);
}

// ── Closures (airfoil_tpu/viscous/closures.py) ─────────────────────────────
constexpr float kHkLamMax = 5.8f;
constexpr float kHkTurbMax = 4.0f;

template <class T>
__device__ __forceinline__ T clip_hk(const T& hk) {
  return clip(hk, 1.02f, 12.0f);
}

template <class T>
__device__ T lam_hstar(T hk) {
  hk = clip_hk(hk);
  if (val(hk) < 4.0f) return 1.515f + 0.076f * sq(4.0f - hk) / hk;
  return 1.515f + 0.040f * sq(hk - 4.0f) / hk;
}

template <class T>
__device__ T lam_cf(T hk, T ret) {
  hk = clip_hk(hk);
  ret = clip_lo(ret, 1.0f);
  T half_cf_ret;
  if (val(hk) < 7.4f)
    half_cf_ret = -0.067f + 0.01977f * sq(7.4f - hk) / (hk - 1.0f);
  else
    half_cf_ret = -0.067f + 0.022f * sq(1.0f - 1.4f / (hk - 6.0f));
  return 2.0f * half_cf_ret / ret;
}

template <class T>
__device__ T lam_diss(T hk, T ret, const T& hstar) {
  hk = clip_hk(hk);
  ret = clip_lo(ret, 1.0f);
  T two;
  if (val(hk) < 4.0f)
    two = 0.207f + 0.00205f * tpow(4.0f - hk, 5.5f);
  else
    two = 0.207f - 0.003f * sq(hk - 4.0f) / (1.0f + 0.02f * sq(hk - 4.0f));
  return 0.5f * two * hstar / ret;
}

template <class T>
__device__ T log10_ret_crit(const T& hk) {
  const T hk1 = clip_lo(clip(hk, 1.05f, 12.0f) - 1.0f, 0.1f);
  return (1.415f / hk1 - 0.489f) * ttanh(20.0f / hk1 - 12.9f) + 3.295f / hk1
         + 0.44f;
}

// jnp.interp(hk, knots, values) on the six-knot H-modulation table. The
// segment's knots are picked by an unrolled compare chain, so the table
// stays in registers (an array indexed at run time would go to local
// memory).
template <class T>
__device__ T amp_h_mod(const T& hk) {
  constexpr float xp[6] = {2.55f, 2.90f, 3.20f, 3.60f, 4.20f, 5.20f};
  constexpr float fp[6] = {1.00f, 0.70f, 0.62f, 0.60f, 0.65f, 0.70f};
  const float x = val(hk);
  // Outside the table the value is clamped and the tangent is 0.
  if (x < xp[0]) return constant<T>(fp[0]);
  if (x > xp[5]) return constant<T>(fp[5]);
  // The segment [xp[i-1], xp[i]] with i the number of knots <= x, clamped
  // to 1..5: the right-hand segment at a knot, as jnp.interp.
  float x0 = xp[0], x1 = xp[1], f0 = fp[0], f1 = fp[1];
#pragma unroll
  for (int k = 2; k < 6; ++k) {
    if (xp[k - 1] <= x) {
      x0 = xp[k - 1];
      x1 = xp[k];
      f0 = fp[k - 1];
      f1 = fp[k];
    }
  }
  const float dx = x1 - x0;
  return f0 + ((hk - x0) / dx) * (f1 - f0);
}

template <class T>
__device__ T sep_boost(const T& hk) {
  const T s = clip((hk - 4.6f) / 0.9f, 0.0f, 1.0f);
  return 60.0f * s * s * (3.0f - 2.0f * s);
}

template <class T>
__device__ T amplification_rate(T hk, T theta, T ret) {
  hk = clip(hk, 2.1f, 12.0f);
  theta = clip_lo(theta, 1e-12f);
  ret = clip_lo(ret, 1.0f);
  const T hk1 = clip_lo(hk - 1.0f, 0.1f);
  const T log10_retc = log10_ret_crit(hk);
  const T dn_dret =
      0.01f * tsqrt(sq(2.4f * hk - 3.7f + 2.5f * ttanh(1.5f * hk - 4.65f))
                    + 0.25f);
  const T ell = (6.54f * hk - 14.07f) / sq(hk);
  const T m = (0.058f * sq(hk - 4.0f) / hk1 - 0.068f) / ell;
  const T rate = dn_dret * 0.5f * (m + 1.0f) * ell / theta;
  const T s = clip((tlog10(ret) - log10_retc) / 0.16f, 0.0f, 1.0f);
  const T gate = s * s * (3.0f - 2.0f * s);
  return rate * gate * amp_h_mod(hk) + sep_boost(hk);
}

template <class T>
__device__ T turb_hstar(T hk, T ret) {
  hk = clip_hk(hk);
  ret = clip_lo(ret, 400.0f);
  const T h0 = 3.0f + 400.0f / ret;
  const T base = 1.505f + 4.0f / ret;
  if (val(hk) < val(h0))
    return base + (0.165f - 1.6f / tsqrt(ret)) * tpow(h0 - hk, 1.6f) / hk;
  const T lnret = tlog(ret);
  return base + sq(hk - h0) * (0.04f / hk + 0.007f * lnret
                               / sq(hk - h0 + 4.0f / lnret));
}

template <class T>
__device__ T turb_cf(T hk, T ret) {
  hk = clip_hk(hk);
  ret = clip_lo(ret, 50.0f);
  const T log10_ret = tlog10(ret);
  return 0.3f * texp(-1.33f * hk) * tpow(log10_ret, -1.74f - 0.31f * hk)
         + 0.00011f * (ttanh(4.0f - hk / 0.875f) - 1.0f);
}

template <class T>
__device__ T turb_us(T hk, const T& hstar) {
  hk = clip_hk(hk);
  const T us = 0.5f * hstar * (1.0f - 4.0f * (hk - 1.0f) / (3.0f * hk));
  return clip(us, 0.0f, 0.98f);
}

template <class T>
__device__ T turb_cteq(T hk, const T& ret, const T& hstar) {
  hk = clip_hk(hk);
  const T us = turb_us(hk, hstar);
  const T cteq = hstar * 0.015f * cube(hk - 1.0f) / ((1.0f - us) * cube(hk));
  return clip(cteq, 1e-7f, 0.3f);
}

template <class T>
__device__ T delta_thickness(const T& theta, const T& dstar, T hk) {
  hk = clip_hk(hk);
  return theta * (3.15f + 1.72f / (hk - 1.0f)) + dstar;
}

}  // namespace bl
