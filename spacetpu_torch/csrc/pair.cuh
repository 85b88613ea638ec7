// What the kernels of direct.cu and tree.cu share: the packed source
// layout, the rounding helpers and the two per-pair terms (a softened
// point mass, and a monopole + quadrupole cluster summary).
//
// Rounding: rsqrtf/rsqrt, sqrtf/sqrt and IEEE division, no fast-math flags.

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

// One source s = (x, y, z, g*m) on the target (xi, yi, zi):
//   (tx, ty, tz) += w(r) * (g m) * (x_s - x_i).
// MASK (eps == 0): drop the pair whose softened distance term is 0, the
// self pair, as the TPU kernels do; otherwise it would be 0 * inf = NaN.
template <typename T, int LAW, bool MASK>
__device__ __forceinline__ void pair_term(const Vec4<T> s, T xi, T yi, T zi,
                                          T eps, T eps2, T& tx, T& ty, T& tz) {
  const T dx = s.x - xi;
  const T dy = s.y - yi;
  const T dz = s.z - zi;
  const T r2 = dx * dx + dy * dy + dz * dz;
  T w;
  if (LAW == PLUMMER) {
    const T d2 = r2 + eps2;
    const T inv = rsqrt_(d2);
    w = s.w * (inv * inv * inv);
    if (MASK) w = d2 > T(0) ? w : T(0);
  } else {
    const T denom = r2 * sqrt_(r2) + eps;
    w = s.w / denom;
    if (MASK) w = denom > T(0) ? w : T(0);
  }
  tx += w * dx;
  ty += w * dy;
  tz += w * dz;
}

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
// add 0. Both quadrupole kernels call this one function, so a summary and
// its negation give terms that are exact negatives of each other.
// 59 floating-point operations: 3 differences, 6 for d2, 3 for the guarded
// rsqrt (compare-select, max, rsqrt), 3 powers, 3 for n, 15 for Q n, 5 for
// n.Q.n, 1 + 2 for the two weights, 15 for the three components, 3 sums.
template <typename T>
__device__ __forceinline__ void quad_term(const Summary<T>& s, T xi, T yi,
                                          T zi, T eps2, T& tx, T& ty, T& tz) {
  const T dx = s.a.x - xi;
  const T dy = s.a.y - yi;
  const T dz = s.a.z - zi;
  const T d2 = dx * dx + dy * dy + dz * dz + eps2;
  const T inv = d2 > T(1e-18) ? rsqrt_(max_(d2, T(1e-30))) : T(0);
  const T inv2 = inv * inv;
  const T inv3 = inv2 * inv;
  const T inv4 = inv2 * inv2;
  const T nx = dx * inv;
  const T ny = dy * inv;
  const T nz = dz * inv;
  const T qn_x = s.b.x * nx + s.b.w * ny + s.c.x * nz;
  const T qn_y = s.b.w * nx + s.b.y * ny + s.c.y * nz;
  const T qn_z = s.c.x * nx + s.c.y * ny + s.b.z * nz;
  const T sc = nx * qn_x + ny * qn_y + nz * qn_z;
  const T wm = s.a.w * inv3;
  const T t2 = T(2.5) * sc * inv4;
  tx += wm * dx + t2 * nx - qn_x * inv4;
  ty += wm * dy + t2 * ny - qn_y * inv4;
  tz += wm * dz + t2 * nz - qn_z * inv4;
}

}  // namespace
