// The Barnes-Hut tree's kernels on Hopper (sm_90a), with a plain C
// interface for ctypes (spacetpu_torch/ops/cuda_tree.py binds and wraps it).
//
// quad_dense   replaces spacetpu/ops/pallas_direct.py:_kernel_quad as
//              acc_cross_quad launches it: every target against every
//              cluster summary (monopole + quadrupole far field).
// quad_masked  replaces the same _kernel_quad as
//              spacetpu/ops/tree.py:_superfar_dense_masked launches it: the
//              3-level far field's dense pass, every target against every
//              SUPER-cluster summary with the g*M and g*Q of its own super's
//              near supers zeroed.
// pairs_direct replaces spacetpu/ops/tree.py:_kernel_pairs with its
//              launcher _near_pairs_call: the pair-list near correction,
//              exact pairwise forces of the near clusters' bodies (the
//              source table may embed a -M pseudo-body per cluster, so one
//              sweep gives direct minus monopole).
// pairs_quad   replaces spacetpu/ops/tree.py:_kernel_quad_pairs with the
//              same launcher: the pair-list multipole evaluation, used with
//              negated summaries to take the near clusters' far-field term
//              back out.
// pairs_quad_shared  the same kernel body as mid_far_eval launches it
//              (_near_pairs_call with tile_src): tile k reads its source ids
//              from the source tile tile_src[k], a strip shared by the
//              member clusters of one super (the M1 and M2 passes).
// pairs_hybrid replaces spacetpu/ops/tree.py:_kernel_pairs_hybrid
//              (pairs_accum="mxu"): pairs_direct's weights, summed in the
//              centred rank-1 form sum w (x_s - c) - (sum w)(x_i - c).
// pairs_short  replaces spacetpu/ops/treepm.py:_kernel_pairs_short
//              (_near_pairs_short_pallas through _near_pairs_call): the
//              TreePM short-range pass, the softened law minus the
//              long-range weight the mesh carries (poly or gauss split).
// pairs_short_hybrid  replaces spacetpu/ops/treepm.py:
//              _kernel_pairs_short_hybrid: pairs_short's weights summed as
//              pairs_hybrid sums.
// The four pair-list kernels of bodies are one templated body
// (pairs_kernel) over the pair weight (pair.cuh: DirectWeight, ShortWeight)
// and the accumulation (plain sums, or the centred rank-1 form).
//
// What bounds them: arithmetic, against a few bytes per target and source,
// all of which a block reads once into registers or shared memory. A
// (target, summary) pair costs 59 flops and a (target, body) pair 22
// (plummer) or 23 (ref) in pairs_direct. Counted step by step:
// pairs_hybrid 21 (plummer, eps > 0: differences 3, r^2 5, weight 5, the
// r^2 = 0 mask 1, sums 7 as 3 FMAs and an add); pairs_short 37 with the
// poly split and 81 with the gauss split (differences 3, r^2 5, pair.cuh's
// ShortWeight 23 or 67, sums 6); pairs_short_hybrid 2 more (39, 83). The
// TPU's hybrid kernels move the sums onto the matrix unit; here they stay
// on the CUDA cores (a tensor-core form is later work). Design:
//   - one thread owns one target for its whole sweep and keeps the three
//     sums in registers; sources are staged in shared memory and read by
//     broadcast, so the inner loops issue no global loads;
//   - quad_dense walks all summaries in 256-column tiles; the ragged last
//     tile is zero-filled (a summary with g*M = 0 and g*Q = 0 adds exactly 0);
//   - quad_masked is quad_dense with a (n2, G2) keep mask (built by the
//     wrapper with one scatter, not as the TPU's (n2, 16, G2) tables): a
//     block's targets all lie in one target super, because one super holds
//     SUPER * leaf targets (16,320 at leaf 255), no multiple of 256, so the
//     grid is n2 x ceil(rows / 256) and the block applies its super's mask
//     row while staging each summary tile;
//   - the TPU pair kernels lean on a grid that runs in order: an output
//     block stays resident while its tiles go by and is flushed once. Here
//     nothing carries between blocks. The tile list is ordered by target, so
//     a target cluster owns one contiguous range of tiles: one block per
//     target cluster walks its own range (tile_start, computed on the device
//     by the wrapper), reads its own source ids from the list and gathers
//     the source clusters straight from the packed table. No atomics, a
//     deterministic result, no dummy target block, and list capacity beyond
//     the live tiles costs nothing;
//   - null ids (>= n_src) are skipped (the body kernels) or staged as zero
//     summaries (pairs_quad).
// Near counts are skewed across target clusters, so the blocks of the two
// pair kernels finish unevenly; nothing here balances that.

#include "pair.cuh"

namespace {

constexpr int QBLOCK = 256;

// tgt: (M, 3). summ: (16, S) with row stride ld. out: (M, 3).
template <typename T>
__global__ void __launch_bounds__(QBLOCK)
quad_dense_kernel(const T* __restrict__ tgt, const T* __restrict__ summ,
                  int64_t ld, T* __restrict__ out, int64_t m, int64_t s,
                  T eps2) {
  __shared__ Summary<T> tile[QBLOCK];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * QBLOCK + threadIdx.x;
  const bool live = i < m;
  const T xi = live ? tgt[3 * i] : T(0);
  const T yi = live ? tgt[3 * i + 1] : T(0);
  const T zi = live ? tgt[3 * i + 2] : T(0);
  T ax = T(0), ay = T(0), az = T(0);
  for (int64_t j0 = 0; j0 < s; j0 += QBLOCK) {
    const int64_t j = j0 + threadIdx.x;
    tile[threadIdx.x] = j < s ? load_summary(summ, ld, j) : zero_summary<T>();
    __syncthreads();
    T tx = T(0), ty = T(0), tz = T(0);
#pragma unroll 4
    for (int jj = 0; jj < QBLOCK; ++jj) {
      quad_term(tile[jj], xi, yi, zi, eps2, tx, ty, tz);
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

// One block per target cluster a; thread t < leaf owns target (a, t).
// tgt: (G, leaf, 3). srows: rows 0-3 of an (8, (n_src + 1) * block) table,
// row stride ld, cluster c in columns [c * block, (c + 1) * block), block =
// leaf + 1. flat_src: (T * pj) source cluster ids, tile k in
// [k * pj, (k + 1) * pj). tile_start: (G + 1), cluster a owns the tiles
// [tile_start[a], tile_start[a + 1]). out: (G, leaf, 3).
// W is the pair weight w(g m, r^2) (pair.cuh). Without HYBRID each target
// sums w (x_s - x_i). With HYBRID it sums w (x_s - c) and w, with c the
// cluster's first target and pairs at r^2 = 0 masked, and subtracts
// (sum w) (x_i - c) at the end: the centred rank-1 split of the TPU's
// hybrid kernels, whose self weight would otherwise ride both terms and
// cancel. The sources' x_s - c are staged once a block beside x_s.
template <typename T, class W, bool HYBRID>
__global__ void pairs_kernel(const T* __restrict__ tgt,
                             const T* __restrict__ srows, int64_t ld,
                             const int64_t* __restrict__ flat_src,
                             const int64_t* __restrict__ tile_start,
                             T* __restrict__ out, int leaf, int pj,
                             int64_t n_src, const W weight) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  Vec4<T>* tile = reinterpret_cast<Vec4<T>*>(smem_raw);
  const int block = leaf + 1;
  Vec4<T>* cen = tile + block;  // HYBRID only
  const int t = threadIdx.x;
  const int64_t a = blockIdx.x;
  const bool live = t < leaf;
  const int64_t at = 3 * (a * leaf + t);
  const T xi = live ? tgt[at] : T(0);
  const T yi = live ? tgt[at + 1] : T(0);
  const T zi = live ? tgt[at + 2] : T(0);
  const int64_t a0 = 3 * a * leaf;
  const T cx = HYBRID ? tgt[a0] : T(0);
  const T cy = HYBRID ? tgt[a0 + 1] : T(0);
  const T cz = HYBRID ? tgt[a0 + 2] : T(0);
  T ax = T(0), ay = T(0), az = T(0), aw = T(0);
  const int64_t k1 = tile_start[a + 1];
  for (int64_t k = tile_start[a]; k < k1; ++k) {
    for (int sj = 0; sj < pj; ++sj) {
      const int64_t c = flat_src[k * pj + sj];
      if (c < 0 || c >= n_src) continue;  // the same for every thread
      const T* col = srows + c * block;
      for (int e = t; e < block; e += blockDim.x) {
        const Vec4<T> s{col[e], col[ld + e], col[2 * ld + e], col[3 * ld + e]};
        tile[e] = s;
        if constexpr (HYBRID)
          cen[e] = Vec4<T>{s.x - cx, s.y - cy, s.z - cz, T(0)};
      }
      __syncthreads();
      T tx = T(0), ty = T(0), tz = T(0), tw = T(0);
#pragma unroll 8
      for (int jj = 0; jj < block; ++jj) {
        const Vec4<T> s = tile[jj];
        const T dx = s.x - xi;
        const T dy = s.y - yi;
        const T dz = s.z - zi;
        const T r2 = dx * dx + dy * dy + dz * dz;
        T w = weight(s.w, r2);
        if constexpr (HYBRID) {
          w = r2 > T(0) ? w : T(0);
          const Vec4<T> u = cen[jj];
          tx += w * u.x;
          ty += w * u.y;
          tz += w * u.z;
          tw += w;
        } else {
          tx += w * dx;
          ty += w * dy;
          tz += w * dz;
        }
      }
      ax += tx;
      ay += ty;
      az += tz;
      aw += tw;
      __syncthreads();
    }
  }
  if constexpr (HYBRID) {
    ax -= aw * (xi - cx);
    ay -= aw * (yi - cy);
    az -= aw * (zi - cz);
  }
  if (live) {
    out[at] = ax;
    out[at + 1] = ay;
    out[at + 2] = az;
  }
}

// The same walk over a tile list of summary columns: flat_src holds column
// ids of the (16, n_src + 1) table summ, pj columns a tile. SHARED: tile k
// reads the source tile tile_src[k] instead of its own, so the member
// clusters of one super share one strip (without it tile_src is unused).
template <typename T, bool SHARED>
__global__ void pairs_quad_kernel(
    const T* __restrict__ tgt, const T* __restrict__ summ, int64_t ld,
    const int64_t* __restrict__ flat_src,
    const int64_t* __restrict__ tile_src,
    const int64_t* __restrict__ tile_start, T* __restrict__ out, int leaf,
    int pj, int64_t n_src, T eps2) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  Summary<T>* tile = reinterpret_cast<Summary<T>*>(smem_raw);
  const int t = threadIdx.x;
  const int64_t a = blockIdx.x;
  const bool live = t < leaf;
  const int64_t at = 3 * (a * leaf + t);
  const T xi = live ? tgt[at] : T(0);
  const T yi = live ? tgt[at + 1] : T(0);
  const T zi = live ? tgt[at + 2] : T(0);
  T ax = T(0), ay = T(0), az = T(0);
  const int64_t k1 = tile_start[a + 1];
  for (int64_t k = tile_start[a]; k < k1; ++k) {
    const int64_t* ids = flat_src + (SHARED ? tile_src[k] : k) * pj;
    for (int e = t; e < pj; e += blockDim.x) {
      const int64_t c = ids[e];
      tile[e] = (c >= 0 && c < n_src) ? load_summary(summ, ld, c)
                                      : zero_summary<T>();
    }
    __syncthreads();
    T tx = T(0), ty = T(0), tz = T(0);
#pragma unroll 4
    for (int jj = 0; jj < pj; ++jj) {
      quad_term(tile[jj], xi, yi, zi, eps2, tx, ty, tz);
    }
    ax += tx;
    ay += ty;
    az += tz;
    __syncthreads();
  }
  if (live) {
    out[at] = ax;
    out[at + 1] = ay;
    out[at + 2] = az;
  }
}

// quad_dense with a per-target-super keep mask. tgt: (n2 * rows, 3), super
// a in rows [a * rows, (a + 1) * rows). keep: (n2, G2) bytes, 0 where the
// summary column is one of super a's near supers: its g*M and g*Q are
// staged as 0 (the centre of mass is kept), which adds exactly 0. Grid:
// (blocks_per_super, n2), so no block straddles two supers.
template <typename T>
__global__ void __launch_bounds__(QBLOCK)
quad_masked_kernel(const T* __restrict__ tgt, const T* __restrict__ summ,
                   int64_t ld, const unsigned char* __restrict__ keep,
                   T* __restrict__ out, int64_t rows, int64_t s, T eps2) {
  __shared__ Summary<T> tile[QBLOCK];
  const int64_t a = blockIdx.y;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * QBLOCK + threadIdx.x;
  const bool live = r < rows;
  const int64_t i = a * rows + r;
  const unsigned char* keep_a = keep + a * s;
  const T xi = live ? tgt[3 * i] : T(0);
  const T yi = live ? tgt[3 * i + 1] : T(0);
  const T zi = live ? tgt[3 * i + 2] : T(0);
  T ax = T(0), ay = T(0), az = T(0);
  for (int64_t j0 = 0; j0 < s; j0 += QBLOCK) {
    const int64_t j = j0 + threadIdx.x;
    Summary<T> sj = j < s ? load_summary(summ, ld, j) : zero_summary<T>();
    if (j < s && !keep_a[j]) {
      const Vec4<T> z{T(0), T(0), T(0), T(0)};
      sj.a.w = T(0);
      sj.b = z;
      sj.c = z;
    }
    tile[threadIdx.x] = sj;
    __syncthreads();
    T tx = T(0), ty = T(0), tz = T(0);
#pragma unroll 4
    for (int jj = 0; jj < QBLOCK; ++jj) {
      quad_term(tile[jj], xi, yi, zi, eps2, tx, ty, tz);
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

// Threads of a pair-kernel block: one per slot of a cluster block, in whole
// warps.
unsigned pair_threads(int leaf) {
  return static_cast<unsigned>((leaf + 1 + 31) / 32 * 32);
}

template <typename T>
cudaError_t launch_quad_dense(const void* tgt, const void* summ, int64_t ld,
                              void* out, int64_t m, int64_t s, double eps,
                              cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((m + QBLOCK - 1) / QBLOCK);
  quad_dense_kernel<T><<<blocks, QBLOCK, 0, stream>>>(
      static_cast<const T*>(tgt), static_cast<const T*>(summ), ld,
      static_cast<T*>(out), m, s, static_cast<T>(eps * eps));
  return cudaGetLastError();
}

template <typename T, class W, bool HYBRID>
cudaError_t launch_pairs(const void* tgt, const void* srows, int64_t ld,
                         const int64_t* flat_src, const int64_t* tile_start,
                         void* out, int64_t g, int leaf, int pj, int64_t n_src,
                         const W weight, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(leaf + 1) * sizeof(Vec4<T>) * (HYBRID ? 2 : 1);
  pairs_kernel<T, W, HYBRID>
      <<<static_cast<unsigned>(g), pair_threads(leaf), smem, stream>>>(
          static_cast<const T*>(tgt), static_cast<const T*>(srows), ld,
          flat_src, tile_start, static_cast<T*>(out), leaf, pj, n_src, weight);
  return cudaGetLastError();
}

// The direct law (pairs_direct, and pairs_hybrid with HYBRID).
template <typename T, bool HYBRID>
cudaError_t launch_pairs_direct_law(int law, const void* tgt,
                                    const void* srows, int64_t ld,
                                    const int64_t* flat_src,
                                    const int64_t* tile_start, void* out,
                                    int64_t g, int leaf, int pj,
                                    int64_t n_src, double eps,
                                    cudaStream_t stream) {
  const T e = static_cast<T>(eps), e2 = static_cast<T>(eps * eps);
  const bool mask = eps == 0.0;
#define SPACETPU_PAIRS(LAW, MASK)                                          \
  launch_pairs<T, DirectWeight<T, LAW, MASK>, HYBRID>(                      \
      tgt, srows, ld, flat_src, tile_start, out, g, leaf, pj, n_src,        \
      DirectWeight<T, LAW, MASK>{e, e2}, stream)
  if (law == PLUMMER)
    return mask ? SPACETPU_PAIRS(PLUMMER, true)
                : SPACETPU_PAIRS(PLUMMER, false);
  if (law == REF)
    return mask ? SPACETPU_PAIRS(REF, true) : SPACETPU_PAIRS(REF, false);
#undef SPACETPU_PAIRS
  return cudaErrorInvalidValue;
}

// The TreePM short-range law (pairs_short, and pairs_short_hybrid with
// HYBRID). rcut is used by POLY, rs by GAUSS.
template <typename T, bool HYBRID>
cudaError_t launch_pairs_short_law(int law, int split, const void* tgt,
                                   const void* srows, int64_t ld,
                                   const int64_t* flat_src,
                                   const int64_t* tile_start, void* out,
                                   int64_t g, int leaf, int pj, int64_t n_src,
                                   double eps, double rs, double rcut,
                                   cudaStream_t stream) {
  const double inv_rc2 = split == POLY ? 1.0 / (rcut * rcut) : 0.0;
  const double inv4rs2 = split == GAUSS ? 1.0 / (4.0 * rs * rs) : 0.0;
  const double w_in_scale = split == GAUSS ? inv4rs2 * (0.5 / rs) : 0.0;
#define SPACETPU_PAIRS(LAW, SPLIT)                                            \
  launch_pairs<T, ShortWeight<T, LAW, SPLIT>, HYBRID>(                         \
      tgt, srows, ld, flat_src, tile_start, out, g, leaf, pj, n_src,           \
      ShortWeight<T, LAW, SPLIT>{static_cast<T>(eps),                          \
                                 static_cast<T>(eps * eps),                    \
                                 static_cast<T>(inv_rc2),                      \
                                 static_cast<T>(inv4rs2),                      \
                                 static_cast<T>(w_in_scale)},                  \
      stream)
  if (law == PLUMMER && split == POLY) return SPACETPU_PAIRS(PLUMMER, POLY);
  if (law == PLUMMER && split == GAUSS) return SPACETPU_PAIRS(PLUMMER, GAUSS);
  if (law == REF && split == POLY) return SPACETPU_PAIRS(REF, POLY);
  if (law == REF && split == GAUSS) return SPACETPU_PAIRS(REF, GAUSS);
#undef SPACETPU_PAIRS
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_quad_masked(const void* tgt, const void* summ, int64_t ld,
                               const unsigned char* keep, void* out,
                               int64_t n2, int64_t rows, int64_t s,
                               double eps, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((rows + QBLOCK - 1) / QBLOCK),
                  static_cast<unsigned>(n2));
  quad_masked_kernel<T><<<grid, QBLOCK, 0, stream>>>(
      static_cast<const T*>(tgt), static_cast<const T*>(summ), ld, keep,
      static_cast<T*>(out), rows, s, static_cast<T>(eps * eps));
  return cudaGetLastError();
}

template <typename T, bool SHARED>
cudaError_t launch_pairs_quad(const void* tgt, const void* summ, int64_t ld,
                              const int64_t* flat_src,
                              const int64_t* tile_src,
                              const int64_t* tile_start, void* out, int64_t g,
                              int leaf, int pj, int64_t n_src, double eps,
                              cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(pj) * sizeof(Summary<T>);
  pairs_quad_kernel<T, SHARED>
      <<<static_cast<unsigned>(g), pair_threads(leaf), smem, stream>>>(
          static_cast<const T*>(tgt), static_cast<const T*>(summ), ld,
          flat_src, tile_src, tile_start, static_cast<T*>(out), leaf, pj,
          n_src, static_cast<T>(eps * eps));
  return cudaGetLastError();
}

// A pair kernel's block is one cluster block (at most 1024 threads) and its
// shared memory stays inside the 48 KB a kernel gets without opting in.
bool pair_shape_ok(int64_t g, int leaf, int pj, size_t smem) {
  return g > 0 && leaf > 0 && leaf < 1024 && pj > 0 && smem <= 48 * 1024;
}

// The four pair-list kernels of the direct and the short-range law.
// law: 0 = plummer, 1 = ref. split: 0 = poly, 1 = gauss.
template <bool HYBRID>
int pairs_direct_entry(int dtype, int law, const void* tgt, const void* srows,
                       long long ld, const void* flat_src,
                       const void* tile_start, void* out, long long g,
                       int leaf, int pj, long long n_src, double eps,
                       void* stream) {
  const size_t elem = dtype == 1 ? sizeof(double) : sizeof(float);
  const size_t smem =
      static_cast<size_t>(leaf + 1) * 4 * elem * (HYBRID ? 2 : 1);
  if (!pair_shape_ok(g, leaf, pj, smem)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* fs = static_cast<const int64_t*>(flat_src);
  const int64_t* ts = static_cast<const int64_t*>(tile_start);
  if (dtype == 0)
    return launch_pairs_direct_law<float, HYBRID>(law, tgt, srows, ld, fs, ts,
                                                  out, g, leaf, pj, n_src, eps,
                                                  st);
  if (dtype == 1)
    return launch_pairs_direct_law<double, HYBRID>(law, tgt, srows, ld, fs, ts,
                                                   out, g, leaf, pj, n_src,
                                                   eps, st);
  return cudaErrorInvalidValue;
}

template <bool HYBRID>
int pairs_short_entry(int dtype, int law, int split, const void* tgt,
                      const void* srows, long long ld, const void* flat_src,
                      const void* tile_start, void* out, long long g,
                      int leaf, int pj, long long n_src, double eps,
                      double rs, double rcut, void* stream) {
  const size_t elem = dtype == 1 ? sizeof(double) : sizeof(float);
  const size_t smem =
      static_cast<size_t>(leaf + 1) * 4 * elem * (HYBRID ? 2 : 1);
  if (!pair_shape_ok(g, leaf, pj, smem)) return cudaErrorInvalidValue;
  if ((split == POLY && !(rcut > 0.0)) || (split == GAUSS && !(rs > 0.0)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* fs = static_cast<const int64_t*>(flat_src);
  const int64_t* ts = static_cast<const int64_t*>(tile_start);
  if (dtype == 0)
    return launch_pairs_short_law<float, HYBRID>(law, split, tgt, srows, ld,
                                                 fs, ts, out, g, leaf, pj,
                                                 n_src, eps, rs, rcut, st);
  if (dtype == 1)
    return launch_pairs_short_law<double, HYBRID>(law, split, tgt, srows, ld,
                                                  fs, ts, out, g, leaf, pj,
                                                  n_src, eps, rs, rcut, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = float64. law: 0 = plummer, 1 = ref.
// Each returns the CUDA error code of the launch (0 on success).
extern "C" int spacetpu_quad_dense(int dtype, const void* tgt,
                                   const void* summ, long long ld, void* out,
                                   long long m, long long s, double eps,
                                   void* stream) {
  if (m <= 0 || s < 0 || ld < s) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_quad_dense<float>(tgt, summ, ld, out, m, s, eps, st);
  if (dtype == 1)
    return launch_quad_dense<double>(tgt, summ, ld, out, m, s, eps, st);
  return cudaErrorInvalidValue;
}

extern "C" int spacetpu_pairs_direct(int dtype, int law, const void* tgt,
                                     const void* srows, long long ld,
                                     const void* flat_src,
                                     const void* tile_start, void* out,
                                     long long g, int leaf, int pj,
                                     long long n_src, double eps,
                                     void* stream) {
  return pairs_direct_entry<false>(dtype, law, tgt, srows, ld, flat_src,
                                   tile_start, out, g, leaf, pj, n_src, eps,
                                   stream);
}

extern "C" int spacetpu_pairs_hybrid(int dtype, int law, const void* tgt,
                                     const void* srows, long long ld,
                                     const void* flat_src,
                                     const void* tile_start, void* out,
                                     long long g, int leaf, int pj,
                                     long long n_src, double eps,
                                     void* stream) {
  return pairs_direct_entry<true>(dtype, law, tgt, srows, ld, flat_src,
                                  tile_start, out, g, leaf, pj, n_src, eps,
                                  stream);
}

extern "C" int spacetpu_pairs_short(int dtype, int law, int split,
                                    const void* tgt, const void* srows,
                                    long long ld, const void* flat_src,
                                    const void* tile_start, void* out,
                                    long long g, int leaf, int pj,
                                    long long n_src, double eps, double rs,
                                    double rcut, void* stream) {
  return pairs_short_entry<false>(dtype, law, split, tgt, srows, ld, flat_src,
                                  tile_start, out, g, leaf, pj, n_src, eps,
                                  rs, rcut, stream);
}

extern "C" int spacetpu_pairs_short_hybrid(int dtype, int law, int split,
                                           const void* tgt, const void* srows,
                                           long long ld, const void* flat_src,
                                           const void* tile_start, void* out,
                                           long long g, int leaf, int pj,
                                           long long n_src, double eps,
                                           double rs, double rcut,
                                           void* stream) {
  return pairs_short_entry<true>(dtype, law, split, tgt, srows, ld, flat_src,
                                 tile_start, out, g, leaf, pj, n_src, eps, rs,
                                 rcut, stream);
}

extern "C" int spacetpu_pairs_quad(int dtype, const void* tgt,
                                   const void* summ, long long ld,
                                   const void* flat_src,
                                   const void* tile_start, void* out,
                                   long long g, int leaf, int pj,
                                   long long n_src, double eps, void* stream) {
  const size_t elem = dtype == 1 ? sizeof(double) : sizeof(float);
  if (!pair_shape_ok(g, leaf, pj, static_cast<size_t>(pj) * 12 * elem))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* fs = static_cast<const int64_t*>(flat_src);
  const int64_t* ts = static_cast<const int64_t*>(tile_start);
  if (dtype == 0)
    return launch_pairs_quad<float, false>(tgt, summ, ld, fs, nullptr, ts,
                                           out, g, leaf, pj, n_src, eps, st);
  if (dtype == 1)
    return launch_pairs_quad<double, false>(tgt, summ, ld, fs, nullptr, ts,
                                            out, g, leaf, pj, n_src, eps, st);
  return cudaErrorInvalidValue;
}

extern "C" int spacetpu_quad_masked(int dtype, const void* tgt,
                                    const void* summ, long long ld,
                                    const void* keep, void* out, long long n2,
                                    long long rows, long long s, double eps,
                                    void* stream) {
  if (n2 <= 0 || n2 > 65535 || rows <= 0 || s < 0 || ld < s)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* kp = static_cast<const unsigned char*>(keep);
  if (dtype == 0)
    return launch_quad_masked<float>(tgt, summ, ld, kp, out, n2, rows, s, eps,
                                     st);
  if (dtype == 1)
    return launch_quad_masked<double>(tgt, summ, ld, kp, out, n2, rows, s,
                                      eps, st);
  return cudaErrorInvalidValue;
}

extern "C" int spacetpu_pairs_quad_shared(int dtype, const void* tgt,
                                          const void* summ, long long ld,
                                          const void* flat_src,
                                          const void* tile_src,
                                          const void* tile_start, void* out,
                                          long long g, int leaf, int pj,
                                          long long n_src, double eps,
                                          void* stream) {
  const size_t elem = dtype == 1 ? sizeof(double) : sizeof(float);
  if (!pair_shape_ok(g, leaf, pj, static_cast<size_t>(pj) * 12 * elem))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* fs = static_cast<const int64_t*>(flat_src);
  const int64_t* tsrc = static_cast<const int64_t*>(tile_src);
  const int64_t* ts = static_cast<const int64_t*>(tile_start);
  if (dtype == 0)
    return launch_pairs_quad<float, true>(tgt, summ, ld, fs, tsrc, ts, out, g,
                                          leaf, pj, n_src, eps, st);
  if (dtype == 1)
    return launch_pairs_quad<double, true>(tgt, summ, ld, fs, tsrc, ts, out,
                                           g, leaf, pj, n_src, eps, st);
  return cudaErrorInvalidValue;
}
