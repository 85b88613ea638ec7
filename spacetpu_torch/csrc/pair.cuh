// What the kernels of direct.cu and tree.cu share: the packed source
// layout, the rounding helpers, the per-pair weights of the pair-list
// kernels (the direct law and the TreePM short-range law) and the two
// per-pair terms (a softened point mass, and a monopole + quadrupole
// cluster summary).
//
// Rounding: rsqrtf/rsqrt, sqrtf/sqrt and IEEE division, no fast-math flags;
// rsqrt_ftz (the MUFU rsqrt alone) in PolyLean, DirectLean and quad_term.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Law : int { PLUMMER = 0, REF = 1 };

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T x, y, z, w;
};

__device__ __forceinline__ float rsqrt_(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_(double v) { return rsqrt(v); }
__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}

// The MUFU reciprocal square root alone (rsqrt.approx.ftz): for a normal
// argument it gives rsqrtf's result, without rsqrtf's rescaling of a
// subnormal one (a subnormal argument counts as 0: the result is +inf).
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// float64 has no such form: rsqrt.
__device__ __forceinline__ double rsqrt_ftz(double x) { return rsqrt(x); }

// The direct law's pair weight w = g m * r^-3 (plummer: (r^2 + eps^2)^-3/2;
// ref: 1 / (r^3 + eps)), the factor of (x_s - x_i) in a target's sum.
// MASK (eps == 0): drop the pair whose softened distance term is 0, the
// self pair, as the TPU kernels do; otherwise it would be 0 * inf = NaN.
template <typename T, int LAW, bool MASK>
struct DirectWeight {
  T eps, eps2;
  __device__ __forceinline__ T operator()(T gm, T r2) const {
    if (LAW == PLUMMER) {
      const T d2 = r2 + eps2;
      const T inv = rsqrt_(d2);
      T w = gm * (inv * inv * inv);
      if (MASK) w = d2 > T(0) ? w : T(0);
      return w;
    }
    const T denom = r2 * sqrt_(r2) + eps;
    T w = gm / denom;
    if (MASK) w = denom > T(0) ? w : T(0);
    return w;
  }
};

// DirectWeight<float, PLUMMER, false> with the MUFU rsqrt alone, for an
// eps whose float32 square is normal (the host's choice: eps^2 >=
// FLT_MIN). Then d2 = r2 + eps2 >= eps2 is never subnormal (rounding is
// monotone), so rsqrt_ftz gives rsqrtf's bits without rsqrtf's guard (a
// compare and two predicated multiplies): the same weight, bit for bit, in
// 3 fewer instructions a pair.
template <typename T>
struct DirectLean {
  T eps2;
  __device__ __forceinline__ T operator()(T gm, T r2) const {
    const T inv = rsqrt_ftz(r2 + eps2);
    return gm * (inv * inv * inv);
  }
};

// One source s = (x, y, z, g*m) on the target (xi, yi, zi):
//   (tx, ty, tz) += w(r) * (g m) * (x_s - x_i).
template <typename T, int LAW, bool MASK>
__device__ __forceinline__ void pair_term(const Vec4<T> s, T xi, T yi, T zi,
                                          T eps, T eps2, T& tx, T& ty, T& tz) {
  const T dx = s.x - xi;
  const T dy = s.y - yi;
  const T dz = s.z - zi;
  const T r2 = dx * dx + dy * dy + dz * dz;
  const T w = DirectWeight<T, LAW, MASK>{eps, eps2}(s.w, r2);
  tx += w * dx;
  ty += w * dy;
  tz += w * dz;
}

// The TreePM short-range law (spacetpu/ops/treepm.py:_w_short_tile): the
// softened pair weight minus the long-range weight that the mesh carries.
enum Split : int { POLY = 0, GAUSS = 1 };

// The gauss split's long-range bracket h(v) = [erf(u) - (2/sqrt(pi)) u
// e^(-u^2)] / u^3, v = u^2, as a degree-15 Chebyshev series on
// [0, HLONG_VMAX] at x = 2 v / HLONG_VMAX - 1 (Clenshaw; the coefficients of
// treepm._HLONG_CHEB, which ops/cuda_tree.py holds as HLONG_CHEB).
constexpr double HLONG_VMAX = 12.25;

template <typename T>
__device__ __forceinline__ T h_long_cheb(T x) {
  const T two_x = T(2) * x;
  T b1 = T(0), b2 = T(0), t;
#define SPACETPU_CLENSHAW(c) \
  t = two_x * b1 - b2 + T(c);  \
  b2 = b1;                     \
  b1 = t;
  SPACETPU_CLENSHAW(-1.0951542449936198e-08)
  SPACETPU_CLENSHAW(6.023877228414106e-08)
  SPACETPU_CLENSHAW(-3.1826850806844793e-07)
  SPACETPU_CLENSHAW(1.5567925396196247e-06)
  SPACETPU_CLENSHAW(-7.143091319246147e-06)
  SPACETPU_CLENSHAW(3.059320288310997e-05)
  SPACETPU_CLENSHAW(-0.00012184889023613674)
  SPACETPU_CLENSHAW(0.00044916418572923115)
  SPACETPU_CLENSHAW(-0.001524426605379348)
  SPACETPU_CLENSHAW(0.0047356367163482625)
  SPACETPU_CLENSHAW(-0.013376761116476876)
  SPACETPU_CLENSHAW(0.03409713282293515)
  SPACETPU_CLENSHAW(-0.07770857221021463)
  SPACETPU_CLENSHAW(0.1563599597336091)
  SPACETPU_CLENSHAW(-0.2717257282102824)
#undef SPACETPU_CLENSHAW
  return x * b1 - b2 + T(0.192113856961219);
}

// w = g m * (w_pair(r) - w_long(r)), where
//   w_pair: plummer (r^2 + eps^2)^-3/2, 0 where r^2 + eps^2 = 0; ref
//           1 / (r^3 + eps), 0 where r^3 + eps = 0;
//   POLY:   w_long = G(y) / r^3, G(y) = y^3 (10 - 15 y + 6 y^2), y =
//           min(r^2 / r_cut^2, 1), and w = 0 where r^2 >= r_cut^2;
//   GAUSS:  w_long = h(v) / (8 rs^3) for v = r^2 / (4 rs^2) <= HLONG_VMAX,
//           else 1 / r^3, with the Clenshaw argument clamped to <= 1 (an
//           out-of-range v would overflow the recurrence);
// and 1 / r = 0 at r = 0. A massless source (the pseudo slot) adds 0.
// Flops a call, step by step: w_pair 5 (plummer: add, rsqrt, 2 mul, select;
// ref: sqrt, mul, add, div, select), 1/r^3 5 (select, max, rsqrt, 2 mul),
// then POLY 13 (y 2, G 7, G / r^3 1, difference 1, select 1, g m 1; the
// compare is the select's) or GAUSS 57 (v 1, x 3, Clenshaw 15 x 3 + 3,
// scale 1, select 2, difference 1, g m 1).
template <typename T, int LAW, int SPLIT>
struct ShortWeight {
  T eps, eps2;
  T inv_rc2;     // POLY: 1 / r_cut^2
  T inv4rs2;     // GAUSS: 1 / (4 rs^2)
  T w_in_scale;  // GAUSS: 1 / (8 rs^3), as inv4rs2 * (0.5 / rs)
  __device__ __forceinline__ T operator()(T gm, T r2) const {
    T w_pair;
    if (LAW == PLUMMER) {
      const T d2 = r2 + eps2;
      const T inv = rsqrt_(d2);
      w_pair = d2 > T(0) ? inv * inv * inv : T(0);
    } else {
      const T denom = r2 * sqrt_(r2) + eps;
      w_pair = denom > T(0) ? T(1) / denom : T(0);
    }
    const T inv_r = r2 > T(0) ? rsqrt_(max_(r2, T(1e-38))) : T(0);
    const T inv_r3 = inv_r * inv_r * inv_r;
    if (SPLIT == POLY) {
      const T yc = r2 * inv_rc2;
      const T y = min_(yc, T(1));
      const T gp = y * y * y * (T(10) + y * (T(-15) + T(6) * y));
      return yc < T(1) ? gm * (w_pair - gp * inv_r3) : T(0);
    }
    const T v = r2 * inv4rs2;
    const T x = min_(v * T(2.0 / HLONG_VMAX) - T(1), T(1));
    const T w_in = h_long_cheb(x) * w_in_scale;
    const T w_long = v <= T(HLONG_VMAX) ? w_in : inv_r3;
    return gm * (w_pair - w_long);
  }
};

// ShortWeight<T, PLUMMER, POLY> at eps = 0 (TreePM's default) in one rsqrt:
// there w_pair = 1 / r^3 is the long-range weight's 1 / r^3, so
//   w = g m (1 - G(y)) / r^3,  y = min(r^2 / r_cut^2, 1),
// G by Horner as FMAs. At y = 1, G(1) = 1 exactly, so 1 - G = 0 and the
// weight is exactly 0 at and beyond the cutoff without a select. The r^2 > 0
// guard gives the self pair (and a massless slot on a target) 0; a
// subnormal r^2 overflows 1 / r^3 here as in ShortWeight. Flops a call: y 2,
// rsqrt 1, 1 / r^3 2, 1 - G 5, g m 2, guard 1: 13 (ShortWeight: 23).
template <typename T>
struct PolyLean {
  T inv_rc2;
  __device__ __forceinline__ T operator()(T gm, T r2) const {
    const T y = min_(r2 * inv_rc2, T(1));
    const T inv = rsqrt_ftz(r2);
    const T p = fma_(fma_(T(6), y, T(-15)), y, T(10));
    const T one_minus_g = fma_(-(y * y * y), p, T(1));
    const T w = gm * one_minus_g * (inv * inv * inv);
    return r2 > T(0) ? w : T(0);
  }
};

// One cluster summary: centre of mass and g*M, then the traceless g*Q.
template <typename T>
struct Summary {
  Vec4<T> a;  // x, y, z, g*M
  Vec4<T> b;  // g*Qxx, g*Qyy, g*Qzz, g*Qxy
  Vec4<T> c;  // g*Qxz, g*Qyz, unused, unused
};

// Column j of a (16, S) summary table with row stride ld (rows 0-9 used).
template <typename T>
__device__ __forceinline__ Summary<T> load_summary(const T* __restrict__ summ,
                                                   int64_t ld, int64_t j) {
  Summary<T> s;
  s.a = Vec4<T>{summ[j], summ[ld + j], summ[2 * ld + j], summ[3 * ld + j]};
  s.b = Vec4<T>{summ[4 * ld + j], summ[5 * ld + j], summ[6 * ld + j],
                summ[7 * ld + j]};
  s.c = Vec4<T>{summ[8 * ld + j], summ[9 * ld + j], T(0), T(0)};
  return s;
}

template <typename T>
__device__ __forceinline__ Summary<T> zero_summary() {
  const Vec4<T> z{T(0), T(0), T(0), T(0)};
  return Summary<T>{z, z, z};
}

// Monopole + quadrupole of one summary on the target (plummer softening),
// with rel = COM - target and d2 = |rel|^2 + eps^2:
//   a += gM rel d2^-3/2 - (gQ rel) d2^-5/2 + 2.5 (rel.gQ.rel) rel d2^-7/2
// in the unit-vector form  inv^4 (2.5 (n.Q.n) n - Q n),  n = rel * inv:
// the rel-vector form needs inv^7, which overflows float32 for close pairs,
// and the infinities would break the cancellation between the far field
// and the near subtraction. Pairs with d2 <= 1e-18 count as coincident and
// add 0. Every quadrupole kernel calls this one function, and its FMAs are
// written out (fma_), so that no kernel's compiler contracts the products
// and sums its own way: a summary and its negation give terms that are
// exact negatives of each other in every kernel (rounding is symmetric).
// The select keeps the rsqrt's argument above 1e-18, a normal number, so
// float32 takes the MUFU rsqrt alone (rsqrt_ftz), whose result on a normal
// argument is rsqrtf's. 58 floating-point operations: 3 differences, 6 for
// d2, 2 for the guarded rsqrt (compare-select, rsqrt), 3 powers, 3 for n,
// 15 for Q n, 5 for n.Q.n, 1 + 2 for the two weights, 15 for the three
// components, 3 sums.
template <typename T>
__device__ __forceinline__ void quad_term(const Summary<T>& s, T xi, T yi,
                                          T zi, T eps2, T& tx, T& ty, T& tz) {
  const T dx = s.a.x - xi;
  const T dy = s.a.y - yi;
  const T dz = s.a.z - zi;
  const T d2 = fma_(dz, dz, fma_(dy, dy, dx * dx)) + eps2;
  const T inv = d2 > T(1e-18) ? rsqrt_ftz(d2) : T(0);
  const T inv2 = inv * inv;
  const T inv3 = inv2 * inv;
  const T inv4 = inv2 * inv2;
  const T nx = dx * inv;
  const T ny = dy * inv;
  const T nz = dz * inv;
  const T qn_x = fma_(s.c.x, nz, fma_(s.b.w, ny, s.b.x * nx));
  const T qn_y = fma_(s.c.y, nz, fma_(s.b.y, ny, s.b.w * nx));
  const T qn_z = fma_(s.b.z, nz, fma_(s.c.y, ny, s.c.x * nx));
  const T sc = fma_(nz, qn_z, fma_(ny, qn_y, nx * qn_x));
  const T wm = s.a.w * inv3;
  const T t2 = T(2.5) * sc * inv4;
  tx += fma_(-qn_x, inv4, fma_(t2, nx, wm * dx));
  ty += fma_(-qn_y, inv4, fma_(t2, ny, wm * dy));
  tz += fma_(-qn_z, inv4, fma_(t2, nz, wm * dz));
}

}  // namespace
