// All-pairs softened gravity on Hopper (sm_90a), with a plain C interface
// for ctypes (spacetpu_torch/ops/cuda_direct.py binds and wraps it).
//
// direct_vpu replaces spacetpu/ops/pallas_direct.py:_kernel, and
// direct_mxu replaces spacetpu/ops/pallas_direct.py:_kernel_mxu.
//
// Both compute, for every target i,  a_i = sum_j w(r_ij) * (g m_j) * (x_j - x_i).
// The work is M*K pairs of ~22 flops and one reciprocal square root, against
// O(M + K) bytes of input and output, so the card's arithmetic rate bounds
// them, not its memory. Design:
//   - one thread per target, 256 threads a block; the target's sums stay in
//     registers for the whole source sweep;
//   - the source axis is swept inside the block (the TPU kernel's sequential
//     j grid axis), one 256-source tile at a time staged in shared memory;
//     every thread of a warp reads the same tile entry, a broadcast, so the
//     inner loop issues no global loads;
//   - the ragged end of the source axis is a zero-filled tile load: a
//     zero-mass source at the origin adds exactly zero (its distance term is
//     masked or its weight is 0 * finite);
//   - direct_vpu sums each tile's contribution apart and then adds it to the
//     total, which keeps the rounding of long sums close to a blocked sum;
//   - direct_mxu's sums are dominated by the self pair (weight g m / eps^3
//     times x_i) that the rank-1 correction later cancels, so small terms
//     added after it would lose their low bits: its four sums are
//     Kahan-compensated (3 more adds a sum and pair).
// Rounding: rsqrtf/rsqrt, sqrtf/sqrt and IEEE division, no fast-math flags.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK = 256;

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

// Products and sums rounded one at a time, never fused into an FMA: the
// expanded-form distance below is a difference of nearly equal terms, and
// these keep it bit-identical to the same steps done by PyTorch elementwise.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// sum += term, with the rounding error carried in comp (Kahan).
template <typename T>
__device__ __forceinline__ void kahan_add(T& sum, T& comp, T term) {
  const T y = term - comp;
  const T t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

// tgt: (M, 3) targets. src: (K) packed (x, y, z, g*m). out: (M, 3).
// MASK (eps == 0): drop the pair whose softened distance term is 0, the
// self pair, as the TPU kernel does; otherwise it would be 0 * inf = NaN.
template <typename T, int LAW, bool MASK>
__global__ void __launch_bounds__(BLOCK)
direct_vpu_kernel(const T* __restrict__ tgt, const Vec4<T>* __restrict__ src,
                  T* __restrict__ out, int64_t m, int64_t k, T eps, T eps2) {
  __shared__ Vec4<T> tile[BLOCK];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  const bool live = i < m;
  const T xi = live ? tgt[3 * i] : T(0);
  const T yi = live ? tgt[3 * i + 1] : T(0);
  const T zi = live ? tgt[3 * i + 2] : T(0);
  T ax = T(0), ay = T(0), az = T(0);
  for (int64_t j0 = 0; j0 < k; j0 += BLOCK) {
    const int64_t j = j0 + threadIdx.x;
    tile[threadIdx.x] = j < k ? src[j] : Vec4<T>{T(0), T(0), T(0), T(0)};
    __syncthreads();
    T tx = T(0), ty = T(0), tz = T(0);
#pragma unroll 8
    for (int jj = 0; jj < BLOCK; ++jj) {
      const Vec4<T> s = tile[jj];
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
    ax += tx;
    ay += ty;
    az += tz;
    __syncthreads();
  }
  if (live) {
    out[3 * i] = ax;
    out[3 * i + 1] = ay;
    out[3 * i + 2] = az;
  }
}

// Expanded form (plummer, eps > 0):
//   d2 = max((|x_i|^2 + eps^2) + (|x_j|^2 - 2 x_i.x_j), eps^2)
//   w  = g m_j rsqrt(d2)^3,  out_i = [sum_j w x_j, sum_j w]
// tgt: (M) packed (x, y, z, |x|^2). src: (K) packed (x, y, z, g*m).
// sq: (K) |x_j|^2. out: (M) packed. The caller subtracts out.w * x_i.
template <typename T>
__global__ void __launch_bounds__(BLOCK)
direct_mxu_kernel(const Vec4<T>* __restrict__ tgt,
                  const Vec4<T>* __restrict__ src, const T* __restrict__ sq,
                  Vec4<T>* __restrict__ out, int64_t m, int64_t k, T eps2) {
  __shared__ Vec4<T> tile[BLOCK];
  __shared__ T tile_sq[BLOCK];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  const bool live = i < m;
  const Vec4<T> t = live ? tgt[i] : Vec4<T>{T(0), T(0), T(0), T(0)};
  const T sqi = add_rn(t.w, eps2);
  T sx = T(0), sy = T(0), sz = T(0), sw = T(0);
  T cx = T(0), cy = T(0), cz = T(0), cw = T(0);
  for (int64_t j0 = 0; j0 < k; j0 += BLOCK) {
    const int64_t j = j0 + threadIdx.x;
    tile[threadIdx.x] = j < k ? src[j] : Vec4<T>{T(0), T(0), T(0), T(0)};
    tile_sq[threadIdx.x] = j < k ? sq[j] : T(0);
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < BLOCK; ++jj) {
      const Vec4<T> s = tile[jj];
      const T p = add_rn(add_rn(mul_rn(t.x, s.x), mul_rn(t.y, s.y)),
                         mul_rn(t.z, s.z));
      T d2 = add_rn(sqi, sub_rn(tile_sq[jj], mul_rn(T(2), p)));
      d2 = max_(d2, eps2);
      const T inv = rsqrt_(d2);
      const T w = s.w * (inv * inv * inv);
      kahan_add(sx, cx, w * s.x);
      kahan_add(sy, cy, w * s.y);
      kahan_add(sz, cz, w * s.z);
      kahan_add(sw, cw, w);
    }
    __syncthreads();
  }
  if (live) out[i] = Vec4<T>{sx - cx, sy - cy, sz - cz, sw - cw};
}

unsigned blocks_for(int64_t m) {
  return static_cast<unsigned>((m + BLOCK - 1) / BLOCK);
}

template <typename T, int LAW, bool MASK>
cudaError_t launch_vpu(const void* tgt, const void* src, void* out, int64_t m,
                       int64_t k, double eps, cudaStream_t stream) {
  direct_vpu_kernel<T, LAW, MASK><<<blocks_for(m), BLOCK, 0, stream>>>(
      static_cast<const T*>(tgt), static_cast<const Vec4<T>*>(src),
      static_cast<T*>(out), m, k, static_cast<T>(eps),
      static_cast<T>(eps * eps));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vpu_law(int law, const void* tgt, const void* src,
                           void* out, int64_t m, int64_t k, double eps,
                           cudaStream_t stream) {
  const bool mask = eps == 0.0;
  if (law == PLUMMER)
    return mask ? launch_vpu<T, PLUMMER, true>(tgt, src, out, m, k, eps, stream)
                : launch_vpu<T, PLUMMER, false>(tgt, src, out, m, k, eps, stream);
  if (law == REF)
    return mask ? launch_vpu<T, REF, true>(tgt, src, out, m, k, eps, stream)
                : launch_vpu<T, REF, false>(tgt, src, out, m, k, eps, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_mxu(const void* tgt, const void* src, const void* sq,
                       void* out, int64_t m, int64_t k, double eps,
                       cudaStream_t stream) {
  direct_mxu_kernel<T><<<blocks_for(m), BLOCK, 0, stream>>>(
      static_cast<const Vec4<T>*>(tgt), static_cast<const Vec4<T>*>(src),
      static_cast<const T*>(sq), static_cast<Vec4<T>*>(out), m, k,
      static_cast<T>(eps * eps));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. law: 0 = plummer, 1 = ref.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int spacetpu_direct_vpu(int dtype, int law, const void* tgt,
                                   const void* src, void* out, long long m,
                                   long long k, double eps, void* stream) {
  if (m <= 0 || k < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_vpu_law<float>(law, tgt, src, out, m, k, eps, s);
  if (dtype == 1) return launch_vpu_law<double>(law, tgt, src, out, m, k, eps, s);
  return cudaErrorInvalidValue;
}

extern "C" int spacetpu_direct_mxu(int dtype, const void* tgt, const void* src,
                                   const void* sq, void* out, long long m,
                                   long long k, double eps, void* stream) {
  if (m <= 0 || k < 0 || !(eps > 0.0)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_mxu<float>(tgt, src, sq, out, m, k, eps, s);
  if (dtype == 1) return launch_mxu<double>(tgt, src, sq, out, m, k, eps, s);
  return cudaErrorInvalidValue;
}
