// Nearest neighbours on Hopper (sm_90a), with a plain C interface for
// ctypes (spacetpu_torch/ops/encounters.py binds and wraps it).
//
// nearest_neighbor replaces no TPU kernel: it is the O(N^2) pass of
// spacetpu/ops/encounters.py:nearest_neighbor (a jitted j-chunked scan that
// the JAX package leaves to XLA), which the encounter report and every
// collision check run (spacetpu/ops/collisions.py: merge_closest).
//
// For every body i: the least r^2 = |x_j - x_i|^2 over the live bodies
// j != i, and the first j (in index order) that reaches it; (+inf, 0) where
// no live j exists.
//   - What bounds it: arithmetic over N (live - 1) ordered pairs (3
//     differences, 3 squares, 2 sums, a compare; the bytes are O(N)).
//   - What the design does: direct_vpu's layout (csrc/direct.cu). A thread
//     owns NN_TARGETS targets and keeps each one's least r^2 and its index
//     in registers; a block of NN_BLOCK threads stages 256 bodies at a time
//     in shared memory, read by broadcast, each staged body read once for
//     the thread's targets. A dead body (alive[j] == 0) and the ragged end
//     are staged at +inf, so their r^2 is +inf and never taken: no mask
//     test in the pair loop. The self pair is dropped by index, not by
//     r^2 = 0 (two live bodies at one point are each other's neighbour at
//     distance 0), and only in the two tiles that hold the block's own
//     targets (a second instance of the tile loop).
//   - Ties: a candidate replaces the best only when its r^2 is strictly
//     smaller, within a tile in index order and then tile after tile, so
//     the lowest index wins, as the plain version's argmin (first
//     occurrence) and its strict < across chunks have it.
//   - Rounding: r^2 = (dx dx + dy dy) + dz dz, each product and sum rounded
//     on its own (no FMA), as the plain version's elementwise steps round
//     it: the same r^2 bits, so the same neighbours.

#include "pair.cuh"

#include <cmath>

namespace {

constexpr int NN_BLOCK = 256;
constexpr int NN_TARGETS = 2;

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__device__ __forceinline__ T inf_() {
  return static_cast<T>(INFINITY);
}

// One staged tile (bodies j0 .. j0 + NN_BLOCK - 1) against a thread's NT
// targets p; best/arg the targets' least r^2 and its index so far. SELF:
// the tile holds some of the block's targets; own[q] is target q's place
// in the tile (outside 0 .. NN_BLOCK - 1 where it is not in it).
template <typename T, int NT, bool SELF>
__device__ __forceinline__ void nn_tile(const Vec4<T>* tile, const T (&p)[NT][3],
                                        const int (&own)[NT], int j0,
                                        T (&best)[NT], int (&arg)[NT]) {
  T tb[NT];
  int tj[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    tb[q] = inf_<T>();
    tj[q] = 0;
  }
#pragma unroll 8
  for (int jj = 0; jj < NN_BLOCK; ++jj) {
    const Vec4<T> s = tile[jj];
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const T dx = sub_rn(s.x, p[q][0]);
      const T dy = sub_rn(s.y, p[q][1]);
      const T dz = sub_rn(s.z, p[q][2]);
      T r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
      if (SELF && jj == own[q]) r2 = inf_<T>();
      const bool take = r2 < tb[q];
      tb[q] = take ? r2 : tb[q];
      tj[q] = take ? jj : tj[q];
    }
  }
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    if (tb[q] < best[q]) {
      best[q] = tb[q];
      arg[q] = j0 + tj[q];
    }
  }
}

// pos: (N, 3). alive: (N) 0/1, or null (all live). best_r2: (N) the least
// r^2, idx: (N) its body. Thread t of block b owns the targets
// b NT NN_BLOCK + t + q NN_BLOCK, q < NT, those below n live.
template <typename T, int NT>
__global__ void __launch_bounds__(NN_BLOCK)
nearest_neighbor_kernel(const T* __restrict__ pos,
                        const uint8_t* __restrict__ alive,
                        T* __restrict__ best_r2, int64_t* __restrict__ idx,
                        int n) {
  __shared__ Vec4<T> tile[NN_BLOCK];
  const int t = threadIdx.x;
  const int b = blockIdx.x * NT * NN_BLOCK;
  T p[NT][3], best[NT];
  int arg[NT], own[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int i = b + t + q * NN_BLOCK;
#pragma unroll
    for (int c = 0; c < 3; ++c) p[q][c] = i < n ? pos[3 * static_cast<int64_t>(i) + c] : T(0);
    best[q] = inf_<T>();
    arg[q] = 0;
    own[q] = -1;
  }
  for (int j0 = 0; j0 < n; j0 += NN_BLOCK) {
    const int j = j0 + t;
    if (j < n && (alive == nullptr || alive[j] != 0)) {
      const int64_t r = 3 * static_cast<int64_t>(j);
      tile[t] = Vec4<T>{pos[r], pos[r + 1], pos[r + 2], T(0)};
    } else {
      tile[t] = Vec4<T>{inf_<T>(), inf_<T>(), inf_<T>(), T(0)};
    }
    __syncthreads();
    if (j0 >= b && j0 < b + NT * NN_BLOCK) {
#pragma unroll
      for (int q = 0; q < NT; ++q) own[q] = b + t + q * NN_BLOCK - j0;
      nn_tile<T, NT, true>(tile, p, own, j0, best, arg);
    } else {
      nn_tile<T, NT, false>(tile, p, own, j0, best, arg);
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int i = b + t + q * NN_BLOCK;
    if (i < n) {
      best_r2[i] = best[q];
      idx[i] = arg[q];
    }
  }
}

template <typename T>
cudaError_t launch_nearest(const void* pos, const void* alive, void* best_r2,
                           void* idx, int n, cudaStream_t stream) {
  constexpr int per_block = NN_TARGETS * NN_BLOCK;
  nearest_neighbor_kernel<T, NN_TARGETS>
      <<<(n + per_block - 1) / per_block, NN_BLOCK, 0, stream>>>(
          static_cast<const T*>(pos), static_cast<const uint8_t*>(alive),
          static_cast<T*>(best_r2), static_cast<int64_t*>(idx), n);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. pos: (n, 3) of the dtype. alive: (n)
// uint8 0/1, or null where every body is live. best_r2: (n) of the dtype;
// idx: (n) int64. Returns the CUDA error code of the launch (0 on success).
extern "C" int spacetpu_nearest_neighbor(int dtype, const void* pos,
                                         const void* alive, void* best_r2,
                                         void* idx, long long n,
                                         void* stream) {
  if (n <= 0 || n > (1LL << 31) - 1 - 2 * NN_TARGETS * NN_BLOCK)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(n);
  if (dtype == 0) return launch_nearest<float>(pos, alive, best_r2, idx, m, s);
  if (dtype == 1) return launch_nearest<double>(pos, alive, best_r2, idx, m, s);
  return cudaErrorInvalidValue;
}
