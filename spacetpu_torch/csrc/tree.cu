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
//              near supers zeroed. Both are one kernel (quad_two_kernel),
//              two targets a thread, that stages only the live columns.
// pairs_direct replaces spacetpu/ops/tree.py:_kernel_pairs with its
//              launcher _near_pairs_call: the pair-list near correction,
//              exact pairwise forces of the near clusters' bodies (the
//              source table may embed a -M pseudo-body per cluster, so one
//              sweep gives direct minus monopole), two targets a thread
//              (pairs_two_kernel).
// pairs_quad   replaces spacetpu/ops/tree.py:_kernel_quad_pairs with the
//              same launcher (_near_pairs_quad_pallas): the pair-list
//              multipole evaluation, used with negated summaries to take the
//              near clusters' far-field term back out. It and quad_strip are
//              one kernel (quad_list_kernel): a walk over a target cluster's
//              range of a flat id list that stages only the live summaries,
//              two targets a thread.
// pairs_quad_shared  the same kernel body as mid_far_eval launches it
//              (_near_pairs_call with tile_src): tile k reads its source ids
//              from the source tile tile_src[k], a strip shared by the
//              member clusters of one super (the M1 and M2 passes). Two
//              member clusters a block (pairs_quad_shared_kernel): each
//              strip is staged once for both, its live columns packed.
// pairs_hybrid replaces spacetpu/ops/tree.py:_kernel_pairs_hybrid
//              (pairs_accum="mxu"): pairs_direct's weights, summed in the
//              centred rank-1 form sum w (x_s - c) - (sum w)(x_i - c), two
//              targets a thread (pairs_two_kernel with HYBRID).
// pairs_short  replaces spacetpu/ops/treepm.py:_kernel_pairs_short
//              (_near_pairs_short_pallas through _near_pairs_call): the
//              TreePM short-range pass, the softened law minus the
//              long-range weight the mesh carries (poly or gauss split).
//              Both splits take one walk (pairs_cut_kernel), which skips,
//              warp by warp, each chunk of 32 staged sources that lies
//              beyond the weight's exact zero for the warp's targets (poly:
//              r_cut; gauss at plummer eps^2 = 0: u = r / (2 rs) = 3.5),
//              where every pair would add exactly 0.
// pairs_short_hybrid  replaces spacetpu/ops/treepm.py:
//              _kernel_pairs_short_hybrid: pairs_short's weights summed as
//              pairs_hybrid sums, on pairs_short's walk (pairs_cut_kernel
//              with HYBRID), which skips the same chunks: each adds exactly
//              0 to the centred sums too.
// near_strip   replaces spacetpu/ops/tree.py:_near_correction_chunk (the
//              _kernel of pallas_direct.py launched over gathered strips):
//              strip mode's near correction, each target cluster against
//              the bodies of the K clusters of its near list, read from the
//              source pool through the list (never gathered), with the
//              pseudo-body at each cluster's centre of mass (-g M, or 0),
//              two targets a thread.
// quad_strip   replaces spacetpu/ops/tree.py:_near_multipole_sub_pallas
//              (_kernel_quad over gathered summaries): strip mode's
//              multipole subtraction, each target cluster against the
//              negated summaries of its near list (quad_list_kernel, its
//              range a row of the list).
// quad_refine  replaces spacetpu/ops/tree.py:_superfar_refine_pallas
//              (_kernel_quad on the 3-D grid): the strip refinement of the
//              3-level far field, each cluster against its super's strip of
//              member-cluster summaries.
// The four pair-list kernels of bodies are two templated bodies over the
// pair weight (pair.cuh: DirectWeight, DirectLean, ShortWeight, PolyLean,
// GaussLean): pairs_two_kernel, the direct law two targets a thread
// (pairs_direct's plain sums, or with HYBRID pairs_hybrid's centred rank-1
// form), and pairs_cut_kernel, the short-range law's walk (pairs_short and
// pairs_short_hybrid), one target a thread. The two-target kernels of the
// direct law (near_strip, pairs_direct, pairs_hybrid) take DirectLean, the
// MUFU rsqrt alone, for float32 plummer where eps^2 is a normal float32: the
// same bits as rsqrtf, 3 fewer instructions a pair. A float32 eps^2 below
// that counts as 0 there, with the eps == 0 mask (pair.cuh: flushed_eps2).
//
// What bounds them: arithmetic, against a few bytes per target and source, all
// of which a block reads once into registers or shared memory. A (target,
// summary) pair costs 58 flops (pairs_quad, quad_strip and quad_refine: a live
// summary) and a (target, body) pair 22 (plummer) or 23 (ref) in pairs_direct
// and near_strip (a live source cluster's block rows). Counted step by step:
// pairs_hybrid 21 (plummer, eps > 0: differences 3, r^2 5, weight 5, the
// r^2 = 0 mask 1, sums 7 as 3 FMAs and an add); pairs_short 37 with the
// poly split and 63 with the gauss split (differences 3, r^2 5, pair.cuh's
// ShortWeight 23 or 49, sums 6), and at plummer eps 0 27 with the poly
// split and 56 with the gauss split, whose functions are PolyLean's (13)
// and GaussLean's (42); pairs_short_hybrid 2 more (39, 65, 29, 58). The
// TPU's hybrid kernels move the sums onto the matrix unit; here they stay
// on the CUDA cores (the weight is 27 of the 29 flops a pair, and after
// the skip the evaluated pairs come in scattered 32-source chunks, not
// dense tiles; a tensor-core form is later work). pairs_short and
// pairs_short_hybrid need only the pairs where the weight is not exactly
// 0: with the poly split those inside r_cut (about 5% of the listed ones at
// treepm-1M), with the gauss split at plummer eps 0 those at u <= 3.5.
// Their walk (pairs_cut_kernel) evaluates the chunks that may hold one,
// with one rsqrt a pair at eps = 0 (PolyLean, GaussLean). Design:
//   - one thread owns one target (two in near_strip, pairs_direct,
//     pairs_hybrid, quad_refine, pairs_quad_shared, quad_dense,
//     quad_masked, pairs_quad and quad_strip, which read each staged source
//     once for both) for its whole sweep and keeps its sums in registers;
//     sources are staged in shared memory and read by broadcast, so the
//     inner loops issue no global loads;
//   - quad_dense walks all summaries in 256-column tiles and stages the
//     columns inside S; quad_masked is the same kernel with a (n2, G2) keep
//     mask (built by the wrapper with one scatter, not as the TPU's (n2, 16,
//     G2) tables), which stages only the columns its super's mask row keeps
//     (about half at far3-4M): a block's targets all lie in one target
//     super, because one super holds SUPER * leaf targets (16,320 at leaf
//     255), no multiple of a block's, so the grid is n2 x blocks a super. A
//     column left out would add exactly 0 (g*M = 0 and g*Q = 0);
//   - the TPU pair kernels lean on a grid that runs in order: an output
//     block stays resident while its tiles go by and is flushed once. Here
//     nothing carries between blocks. The tile list is ordered by target, so
//     a target cluster owns one contiguous range of tiles: one block per
//     target cluster walks its own range (tile_start, computed on the device
//     by the wrapper), reads its own source ids from the list and gathers
//     the source clusters straight from the packed table. No atomics, a
//     deterministic result, no dummy target block, and list capacity beyond
//     the live tiles costs nothing;
//   - null ids (>= n_src) are skipped: the body kernels at once,
//     pairs_quad_shared by packing a tile's live columns to its front, and
//     pairs_quad and quad_strip by packing the live ids of a window of 512
//     slots (several tiles, or most of a near-list row) behind one barrier,
//     so that a typical range costs two barriers and one sweep;
//   - the strip kernels take the place of a TPU grid that runs in order
//     over gathered copies: the TPU gathers every target cluster's K near
//     clusters into one (8, G K block) strip (16 GB at 1M bodies and K = 496)
//     and sweeps it; here one block a target cluster (near_strip, quad_strip)
//     or two member clusters of a super (quad_refine) reads its sources
//     through the list, a cluster, a tile or a window of summaries at a time,
//     and keeps its sums in registers from the first source to the last, so no
//     sum is zeroed twice or never (the TPU refine's round-3 fault zeroed on
//     the wrong grid axis). near_strip skips a null slot (id = pool size) at
//     once; quad_strip packs the live ids of its windows and quad_refine the
//     live columns of each staged tile to the front (ballots, in column
//     order), so null slots and the all-zero columns of the refinement strips,
//     which add exactly 0, cost nothing in the sweep.
// Near counts are skewed across target clusters, so the blocks of the pair
// and strip kernels finish unevenly. near_strip, pairs_direct and
// pairs_hybrid, whose two-target blocks run twice as long, take their
// clusters in an order the host gives (heaviest first:
// cuda_tree.heavy_first), so that the longest blocks start first; the
// others take them in cluster order.

#include <cfloat>
#include <type_traits>

#include "pair.cuh"

namespace {

// pairs_short and pairs_short_hybrid: one walk (pairs_cut_kernel) for both
// splits. Its arguments: tgt (G, leaf, 3); srows rows 0-3 of an (8,
// (n_src + 1) * block) table, row stride ld, cluster c in columns
// [c * block, (c + 1) * block), block = leaf + 1; flat_src (T * pj) source
// cluster ids, tile k in [k * pj, (k + 1) * pj); tile_start (G + 1),
// cluster a owns the tiles [tile_start[a], tile_start[a + 1]); out (G,
// leaf, 3); cap, the clusters of a stage (cap * block entries fit
// CUT_STAGE_BYTES). W is the pair weight w(g m, r^2) (pair.cuh: PolyLean,
// GaussLean or ShortWeight). Without HYBRID (pairs_short) each target sums
// w (x_s - x_i).
//
// Where the weight is exactly 0 beyond a distance (W::SKIPS), most listed
// pairs add 0: the cutoff lists accept a whole source cluster where its
// centre lies within r_cut + r_i + r_j. The poly split's weight is 0 where
// r^2 / r_cut^2 >= 1 (about 95% of the listed pairs at treepm-1M); the
// gauss split's, at plummer eps^2 = 0 (GaussLean), where v = r^2 / (4 rs^2)
// > HLONG_VMAX, u = r / (2 rs) > 3.5, 7 rs against r_cut's 4.5 rs. The walk
// skips them chunk by chunk:
//   - One block per target cluster a, thread t < leaf owns target (a, t).
//     Each tile's live source clusters are staged together, behind one
//     barrier, as a flat run of entries (cluster after cluster, block
//     entries each), at most `cap` clusters (32 KB) a stage.
//   - A chunk is 32 consecutive entries of a stage. Entry f is staged by
//     thread f % blockDim.x, so a chunk is staged by one warp, which then
//     reduces its bounding box by shuffles (lo and hi of x, y, z) into
//     shared memory. The last chunk's unfilled tail gets massless copies of
//     the stage's last entry: they add 0 and leave the box as it is.
//   - Each warp holds the box of its live targets. It skips a chunk where
//     W::zero_beyond(gap^2), gap the per-axis distance between the boxes,
//     gx = max(lo_s - hi_t, lo_t - hi_s, 0), squared and summed as r^2 is:
//     poly gap^2 / r_cut^2 >= 1, gauss gap^2 / (4 rs^2) > HLONG_VMAX
//     (strictly: v <= HLONG_VMAX takes the series' branch). For s.x in
//     [lo_s, hi_s] and x_i in [lo_t, hi_t], s.x - x_i >= lo_s - hi_t, and
//     rounding is monotone, so |dx| >= gx after rounding too; the squares,
//     their FMA sums and the product by a positive constant keep the order,
//     so every pair of a skipped chunk has r^2 >= gap^2 and is beyond the
//     weight's zero: it would add exactly 0, and the skip changes nothing
//     but the order in which zeros are added. The branch is the same for
//     the whole warp. With the ref law or eps^2 > 0 the gauss weight has no
//     exact zero (ShortWeight: SKIPS false) and the walk sweeps every chunk.
//   - A live chunk is 32 pairs, unrolled; its sums join the stage's, and the
//     stage's the target's.
// Two targets a thread, as pairs_two_kernel takes them, lost on the card
// for the gauss split (PERF.md §6): a warp's box of 64 targets skips fewer
// chunks than one of 32, which costs more than the shared loads save.
// HYBRID (pairs_short_hybrid, the same walk): each target sums w (x_s - c)
// and w, c the cluster's first target, and subtracts (sum w)(x_i - c) at
// the end: the centred rank-1 split of the TPU's hybrid kernels, whose self
// weight would otherwise ride both terms and cancel. w comes from the exact
// difference x_s - x_i, as in pairs_short. The skip stays exact: the boxes
// are boxes of x_s and the gap test is pairs_short's, so every pair of a
// skipped chunk has w exactly 0, and w (x_s - c) and w add exactly 0 to the
// four sums. The r^2 = 0 pair (the target itself) is masked: w = 0 there
// (PolyLean and GaussLean return 0 at r^2 = 0 by themselves, W::GUARDED).
// x_s - c is staged once a block beside x_s, a second run of the stage's
// size (computed a pair it costs 3 FADD where the staged copy costs one
// LDS), so the stage opts in above the 48 KB a block gets by default.
template <typename T>
struct Box {
  Vec4<T> lo, hi;  // x, y, z, unused
};

constexpr int CUT_CHUNK = 32;
// bytes of staged sources a stage (entries: 2048 float32, 1024 float64)
constexpr int CUT_STAGE_BYTES = 32 * 1024;

template <typename T>
__device__ __forceinline__ T inf_() {
  return T(__int_as_float(0x7f800000));
}

template <typename T>
__device__ __forceinline__ void warp_box(T& lo, T& hi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min_(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max_(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// The sums of one target over a walk: (ax, ay, az) and, in the hybrid
// form, aw = sum w.
template <typename T>
struct CutSums {
  T ax, ay, az, aw;
};

// Boxes, then the sweep, of the n staged clusters of a stage; ends with a
// barrier after which the stage may be staged again. cen: the staged x_s - c
// (HYBRID only).
template <typename T, class W, bool HYBRID>
__device__ __forceinline__ void cut_stage(
    Vec4<T>* tile, Vec4<T>* cen, Box<T>* boxes, int entries,
    const Box<T>& own, T xi, T yi, T zi, const W& weight, CutSums<T>& acc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = static_cast<int>(blockDim.x >> 5);
  const int chunks = (entries + CUT_CHUNK - 1) / CUT_CHUNK;
  __syncwarp();
  for (int q = warp; q < chunks; q += warps) {
    const int f = q * CUT_CHUNK + lane;
    Vec4<T> v = tile[f < entries ? f : entries - 1];
    if (f >= entries) {
      v.w = T(0);
      tile[f] = v;
      if constexpr (HYBRID) cen[f] = cen[entries - 1];
    }
    if constexpr (W::SKIPS) {
      T lx = v.x, hx = v.x, ly = v.y, hy = v.y, lz = v.z, hz = v.z;
      warp_box(lx, hx);
      warp_box(ly, hy);
      warp_box(lz, hz);
      if (lane == 0)
        boxes[q] =
            Box<T>{Vec4<T>{lx, ly, lz, T(0)}, Vec4<T>{hx, hy, hz, T(0)}};
    }
  }
  __syncthreads();
  T sx = T(0), sy = T(0), sz = T(0), sw = T(0);
  for (int q = 0; q < chunks; ++q) {
    if constexpr (W::SKIPS) {
      const Box<T> b = boxes[q];
      const T gx = max_(max_(b.lo.x - own.hi.x, own.lo.x - b.hi.x), T(0));
      const T gy = max_(max_(b.lo.y - own.hi.y, own.lo.y - b.hi.y), T(0));
      const T gz = max_(max_(b.lo.z - own.hi.z, own.lo.z - b.hi.z), T(0));
      if (weight.zero_beyond(fma_(gz, gz, fma_(gy, gy, gx * gx)))) continue;
    }
    const Vec4<T>* src = tile + q * CUT_CHUNK;
    T tx = T(0), ty = T(0), tz = T(0), tw = T(0);
#pragma unroll
    for (int jj = 0; jj < CUT_CHUNK; ++jj) {
      const Vec4<T> s = src[jj];
      const T dx = s.x - xi;
      const T dy = s.y - yi;
      const T dz = s.z - zi;
      const T r2 = fma_(dz, dz, fma_(dy, dy, dx * dx));
      T w = weight(s.w, r2);
      if constexpr (!HYBRID) {
        tx = fma_(w, dx, tx);
        ty = fma_(w, dy, ty);
        tz = fma_(w, dz, tz);
      } else {
        if constexpr (!W::GUARDED) w = r2 > T(0) ? w : T(0);
        const Vec4<T> u = cen[q * CUT_CHUNK + jj];
        tx = fma_(w, u.x, tx);
        ty = fma_(w, u.y, ty);
        tz = fma_(w, u.z, tz);
        tw += w;
      }
    }
    sx += tx;
    sy += ty;
    sz += tz;
    sw += tw;
  }
  acc.ax += sx;
  acc.ay += sy;
  acc.az += sz;
  acc.aw += sw;
  __syncthreads();
}

template <typename T, class W, bool HYBRID>
__global__ void pairs_cut_kernel(const T* __restrict__ tgt,
                                 const T* __restrict__ srows, int64_t ld,
                                 const int64_t* __restrict__ flat_src,
                                 const int64_t* __restrict__ tile_start,
                                 T* __restrict__ out, int leaf, int pj,
                                 int64_t n_src, int cap, const W weight) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  const int block = leaf + 1;
  const int padded = (cap * block + CUT_CHUNK - 1) / CUT_CHUNK * CUT_CHUNK;
  Vec4<T>* tile = reinterpret_cast<Vec4<T>*>(smem_raw);
  Vec4<T>* cen = tile + padded;  // HYBRID only
  Box<T>* boxes = reinterpret_cast<Box<T>*>(cen + (HYBRID ? padded : 0));
  const int t = threadIdx.x;
  const int threads = static_cast<int>(blockDim.x);
  const int64_t a = blockIdx.x;
  const bool live = t < leaf;
  const int64_t at = 3 * (a * leaf + t);
  const T xi = live ? tgt[at] : T(0);
  const T yi = live ? tgt[at + 1] : T(0);
  const T zi = live ? tgt[at + 2] : T(0);
  const int64_t a0 = 3 * a * leaf;
  const Vec4<T> c = HYBRID
                        ? Vec4<T>{tgt[a0], tgt[a0 + 1], tgt[a0 + 2], T(0)}
                        : Vec4<T>{T(0), T(0), T(0), T(0)};
  // this warp's live targets' box (empty where the warp has none: then
  // every gap is infinite)
  const T inf = inf_<T>();
  Box<T> own{Vec4<T>{live ? xi : inf, live ? yi : inf, live ? zi : inf, T(0)},
             Vec4<T>{live ? xi : -inf, live ? yi : -inf, live ? zi : -inf,
                     T(0)}};
  if constexpr (W::SKIPS) {
    warp_box(own.lo.x, own.hi.x);
    warp_box(own.lo.y, own.hi.y);
    warp_box(own.lo.z, own.hi.z);
  }
  CutSums<T> acc{T(0), T(0), T(0), T(0)};
  const int64_t k1 = tile_start[a + 1];
  for (int64_t k = tile_start[a]; k < k1; ++k) {
    int n = 0;  // clusters in the stage
    int f = t;  // this thread's next entry of the stage
    for (int sj = 0; sj < pj; ++sj) {
      const int64_t cs = flat_src[k * pj + sj];
      if (cs < 0 || cs >= n_src) continue;  // the same for every thread
      const int64_t base = cs * block - static_cast<int64_t>(n) * block;
      for (; f < (n + 1) * block; f += threads) {
        const int64_t j = base + f;
        const Vec4<T> s{srows[j], srows[ld + j], srows[2 * ld + j],
                        srows[3 * ld + j]};
        tile[f] = s;
        if constexpr (HYBRID)
          cen[f] = Vec4<T>{s.x - c.x, s.y - c.y, s.z - c.z, T(0)};
      }
      if (++n == cap) {
        cut_stage<T, W, HYBRID>(tile, cen, boxes, n * block, own, xi, yi, zi,
                                weight, acc);
        n = 0;
        f = t;
      }
    }
    if (n > 0)
      cut_stage<T, W, HYBRID>(tile, cen, boxes, n * block, own, xi, yi, zi,
                              weight, acc);
  }
  if constexpr (HYBRID) {
    acc.ax -= acc.aw * (xi - c.x);
    acc.ay -= acc.aw * (yi - c.y);
    acc.az -= acc.aw * (zi - c.z);
  }
  if (live) {
    out[at] = acc.ax;
    out[at + 1] = acc.ay;
    out[at + 2] = acc.az;
  }
}

// The same source in the centred rank-1 form: w as body_term's, 0 at r^2 =
// 0 where MASK, then (tx, ty, tz) += w (x_s - c) from the staged u = x_s - c,
// and tw += w.
template <bool MASK, typename T, class W>
__device__ __forceinline__ void hybrid_term(const Vec4<T>& s,
                                            const Vec4<T>& u, T xi, T yi,
                                            T zi, const W& weight, T& tx,
                                            T& ty, T& tz, T& tw) {
  const T dx = s.x - xi;
  const T dy = s.y - yi;
  const T dz = s.z - zi;
  const T r2 = fma_(dz, dz, fma_(dx, dx, dy * dy));
  // a select after the weight (asked for inside the branch, the compiler
  // predicates the weight's instructions and zeroes w apart)
  T w = weight(s.w, r2);
  if (MASK) w = r2 > T(0) ? w : T(0);
  tx = fma_(w, u.x, tx);
  ty = fma_(w, u.y, ty);
  tz = fma_(w, u.z, tz);
  tw += w;
}

// The two-target kernels of the direct law (near_strip, and
// pairs_two_kernel: pairs_direct, pairs_hybrid): one block per target
// cluster a = order[blockIdx.x] (order: a permutation of the clusters, the
// host's), blockDim.x >= ceil(leaf / 2) threads (the host's choice,
// cuda_tree.two_target_threads), and thread t owns targets t and
// t + blockDim.x of the cluster, those below leaf live. Each staged source
// is read from shared memory once for both (one LDS.128 serves two pairs),
// and each target keeps its own sums, source cluster by source cluster, in
// the order a thread of one target would.

// The plain sums of a thread's two targets (p: x, y, z of each) over the
// n staged sources, body_term a pair, added to acc (x, y, z of each, at 0-2
// and 4-6) once the sweep is done.
template <typename T, class W>
__device__ __forceinline__ void direct_sweep(const Vec4<T>* tile, int n,
                                             const T (&p)[6], const W& weight,
                                             T (&acc)[8]) {
  T t[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
#pragma unroll 8
  for (int jj = 0; jj < n; ++jj) {
    const Vec4<T> s = tile[jj];
    body_term(s, p[0], p[1], p[2], weight, t[0], t[1], t[2]);
    body_term(s, p[3], p[4], p[5], weight, t[3], t[4], t[5]);
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    acc[q] += t[q];
    acc[q + 4] += t[q + 3];
  }
}

// tgt: (G_t, leaf, 3). The pool of P source clusters: pool_pos (P, leaf, 3),
// pool_mass (P, leaf), pool_com (P, 3), pool_mtot (P). idx: (G_t, k) pool
// ids; P is the null cluster, skipped. Source cluster c is staged as its
// leaf bodies (g m) and one pseudo-body at its centre of mass carrying
// -g M_c (PSEUDO) or 0: block = leaf + 1 rows, as the pair kernels'
// packed table holds them. W is the pair weight (pair.cuh: DirectWeight,
// or DirectLean where the host chose the MUFU rsqrt alone). Two targets a
// thread.
template <typename T, class W, bool PSEUDO>
__global__ void near_strip_kernel(
    const T* __restrict__ tgt, const T* __restrict__ pool_pos,
    const T* __restrict__ pool_mass, const T* __restrict__ pool_com,
    const T* __restrict__ pool_mtot, const int64_t* __restrict__ idx,
    const int64_t* __restrict__ order, T* __restrict__ out, int leaf,
    int64_t k, int64_t p, T g, const W weight) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  Vec4<T>* tile = reinterpret_cast<Vec4<T>*>(smem_raw);
  const int block = leaf + 1;
  const int threads = static_cast<int>(blockDim.x);
  const int t = threadIdx.x;
  const int64_t a = order[blockIdx.x];
  const bool live0 = t < leaf, live1 = t + threads < leaf;
  const int64_t at0 = 3 * (a * leaf + t);
  const int64_t at1 = at0 + 3 * static_cast<int64_t>(threads);
  const T pt[6] = {live0 ? tgt[at0] : T(0),     live0 ? tgt[at0 + 1] : T(0),
                   live0 ? tgt[at0 + 2] : T(0), live1 ? tgt[at1] : T(0),
                   live1 ? tgt[at1 + 1] : T(0), live1 ? tgt[at1 + 2] : T(0)};
  T acc[8] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  const int64_t* row = idx + a * k;
  for (int64_t s = 0; s < k; ++s) {
    const int64_t c = row[s];
    if (c < 0 || c >= p) continue;  // the null cluster; the same for all
    for (int e = t; e < block; e += threads) {
      Vec4<T> v;
      if (e < leaf) {
        const int64_t b = c * leaf + e;
        v = Vec4<T>{pool_pos[3 * b], pool_pos[3 * b + 1], pool_pos[3 * b + 2],
                    pool_mass[b] * g};
      } else {
        v = Vec4<T>{pool_com[3 * c], pool_com[3 * c + 1], pool_com[3 * c + 2],
                    PSEUDO ? -pool_mtot[c] * g : T(0)};
      }
      tile[e] = v;
    }
    __syncthreads();
    direct_sweep(tile, block, pt, weight, acc);
    __syncthreads();
  }
  if (live0) {
    out[at0] = acc[0];
    out[at0 + 1] = acc[1];
    out[at0 + 2] = acc[2];
  }
  if (live1) {
    out[at1] = acc[4];
    out[at1 + 1] = acc[5];
    out[at1 + 2] = acc[6];
  }
}

// The centred sums of a thread's two targets (p: x, y, z of each) over the
// n staged sources, added to acc (x, y, z, w of each) once the sweep is
// done; the r^2 = 0 mask where MASK.
template <bool MASK, typename T, class W>
__device__ __forceinline__ void hybrid_sweep(const Vec4<T>* tile,
                                             const Vec4<T>* cen, int n,
                                             const T (&p)[6], const W& weight,
                                             T (&acc)[8]) {
  T t[8] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
#pragma unroll 8
  for (int jj = 0; jj < n; ++jj) {
    const Vec4<T> s = tile[jj];
    const Vec4<T> u = cen[jj];
    hybrid_term<MASK>(s, u, p[0], p[1], p[2], weight, t[0], t[1], t[2], t[3]);
    hybrid_term<MASK>(s, u, p[3], p[4], p[5], weight, t[4], t[5], t[6], t[7]);
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] += t[q];
}

template <typename T>
__device__ __forceinline__ Box<T> empty_box() {
  const T inf = inf_<T>();
  return Box<T>{Vec4<T>{inf, inf, inf, T(0)}, Vec4<T>{-inf, -inf, -inf, T(0)}};
}

template <typename T>
__device__ __forceinline__ void box_add(Box<T>& b, T x, T y, T z) {
  b.lo.x = min_(b.lo.x, x);
  b.lo.y = min_(b.lo.y, y);
  b.lo.z = min_(b.lo.z, z);
  b.hi.x = max_(b.hi.x, x);
  b.hi.y = max_(b.hi.y, y);
  b.hi.z = max_(b.hi.z, z);
}

// pairs_direct and pairs_hybrid: pairs_cut_kernel's arguments (but cap)
// and the block order, the direct law's weight W, two targets a thread.
// Each staged source cluster is read from shared memory once for both
// targets, and each target sums it apart, then adds that sum to its total.
// Without HYBRID (pairs_direct) a target sums w (x_s - x_i): one LDS.128 for
// two pairs. With HYBRID (pairs_hybrid) it sums them in the centred rank-1
// form (pairs_cut_kernel's HYBRID): x_s and x_s - c (c the cluster's first
// target) staged, two LDS.128 for two pairs. The r^2 = 0 mask (a compare
// and a select a pair) matters only where a pair can have r^2 = 0: each warp
// holds the box of its live targets, and the block reduces the box of each
// source cluster while staging it. Where the two boxes are apart, gap^2 > 0
// with gap the per-axis distance between them, squared and summed as r^2
// is, every pair of the warp with that cluster has r^2 >= gap^2 > 0
// (rounding is monotone): the mask would keep every weight, so the warp
// sweeps that cluster without it, to the same bits. The branch is the same
// for the whole warp.
template <typename T, class W, bool HYBRID>
__global__ void pairs_two_kernel(const T* __restrict__ tgt,
                                 const T* __restrict__ srows, int64_t ld,
                                 const int64_t* __restrict__ flat_src,
                                 const int64_t* __restrict__ tile_start,
                                 const int64_t* __restrict__ order,
                                 T* __restrict__ out, int leaf, int pj,
                                 int64_t n_src, const W weight) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  __shared__ Box<T> warp_boxes[HYBRID ? 32 : 1];
  const int block = leaf + 1;
  Vec4<T>* tile = reinterpret_cast<Vec4<T>*>(smem_raw);
  Vec4<T>* cen = tile + block;  // HYBRID only
  const int threads = static_cast<int>(blockDim.x);
  const int t = threadIdx.x;
  const int64_t a = order[blockIdx.x];
  const bool live0 = t < leaf, live1 = t + threads < leaf;
  const int64_t at0 = 3 * (a * leaf + t);
  const int64_t at1 = at0 + 3 * static_cast<int64_t>(threads);
  const T p[6] = {live0 ? tgt[at0] : T(0),     live0 ? tgt[at0 + 1] : T(0),
                  live0 ? tgt[at0 + 2] : T(0), live1 ? tgt[at1] : T(0),
                  live1 ? tgt[at1 + 1] : T(0), live1 ? tgt[at1 + 2] : T(0)};
  const int64_t a0 = 3 * a * leaf;
  const T cx = HYBRID ? tgt[a0] : T(0);
  const T cy = HYBRID ? tgt[a0 + 1] : T(0);
  const T cz = HYBRID ? tgt[a0 + 2] : T(0);
  // this warp's live targets' box (empty where it has none: then every
  // source cluster is apart)
  Box<T> own = empty_box<T>();
  if constexpr (HYBRID) {
    if (live0) box_add(own, p[0], p[1], p[2]);
    if (live1) box_add(own, p[3], p[4], p[5]);
    warp_box(own.lo.x, own.hi.x);
    warp_box(own.lo.y, own.hi.y);
    warp_box(own.lo.z, own.hi.z);
  }
  T acc[8] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  const int64_t k1 = tile_start[a + 1];
  for (int64_t k = tile_start[a]; k < k1; ++k) {
    for (int sj = 0; sj < pj; ++sj) {
      const int64_t c = flat_src[k * pj + sj];
      if (c < 0 || c >= n_src) continue;  // the same for every thread
      const T* col = srows + c * block;
      Box<T> src = empty_box<T>();
      for (int e = t; e < block; e += threads) {
        const Vec4<T> s{col[e], col[ld + e], col[2 * ld + e], col[3 * ld + e]};
        tile[e] = s;
        if constexpr (HYBRID) {
          cen[e] = Vec4<T>{s.x - cx, s.y - cy, s.z - cz, T(0)};
          box_add(src, s.x, s.y, s.z);
        }
      }
      if constexpr (HYBRID) {
        warp_box(src.lo.x, src.hi.x);
        warp_box(src.lo.y, src.hi.y);
        warp_box(src.lo.z, src.hi.z);
        if ((t & 31) == 0) warp_boxes[t >> 5] = src;
      }
      __syncthreads();
      if constexpr (HYBRID) {
        for (int w = 0; w < (threads >> 5); ++w) {
          const Box<T> b = warp_boxes[w];
          box_add(src, b.lo.x, b.lo.y, b.lo.z);
          box_add(src, b.hi.x, b.hi.y, b.hi.z);
        }
        const T gx =
            max_(max_(src.lo.x - own.hi.x, own.lo.x - src.hi.x), T(0));
        const T gy =
            max_(max_(src.lo.y - own.hi.y, own.lo.y - src.hi.y), T(0));
        const T gz =
            max_(max_(src.lo.z - own.hi.z, own.lo.z - src.hi.z), T(0));
        if (fma_(gz, gz, fma_(gx, gx, gy * gy)) > T(0))
          hybrid_sweep<false>(tile, cen, block, p, weight, acc);
        else
          hybrid_sweep<true>(tile, cen, block, p, weight, acc);
      } else {
        direct_sweep(tile, block, p, weight, acc);
      }
      __syncthreads();
    }
  }
  if (live0) {
    out[at0] = HYBRID ? acc[0] - acc[3] * (p[0] - cx) : acc[0];
    out[at0 + 1] = HYBRID ? acc[1] - acc[3] * (p[1] - cy) : acc[1];
    out[at0 + 2] = HYBRID ? acc[2] - acc[3] * (p[2] - cz) : acc[2];
  }
  if (live1) {
    out[at1] = HYBRID ? acc[4] - acc[7] * (p[3] - cx) : acc[4];
    out[at1 + 1] = HYBRID ? acc[5] - acc[7] * (p[4] - cy) : acc[5];
    out[at1 + 2] = HYBRID ? acc[6] - acc[7] * (p[5] - cz) : acc[6];
  }
}

// The rank of this thread's slot among the block's live slots (in thread
// order), and their number in `total`: a ballot a warp, then the warps'
// counts through shared memory. blockDim.x is a whole number of warps.
// Ends with a barrier, after which `counts` may be written again only past
// the next barrier.
__device__ __forceinline__ int live_rank(bool live, int* counts, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0;
  total = 0;
  const int warps = static_cast<int>(blockDim.x >> 5);
  for (int w = 0; w < warps; ++w) {
    const int n = counts[w];
    before += w < warp ? n : 0;
    total += n;
  }
  return before + __popc(ballot & ((1u << lane) - 1u));
}

// pairs_quad and quad_strip: one block per target cluster a walks a
// contiguous range of slots of a flat id list, [starts[a] * unit,
// starts[a + 1] * unit) (pairs_quad: its tiles, unit = pj) or [a * unit,
// (a + 1) * unit) where starts is null (quad_strip: its near-list row,
// unit = K). An id outside [0, n_src) is null and is never staged. The
// targets a thread, the slots a window and the pair loop's unroll (16
// pairs a trip) were chosen on the card (PERF.md §6,
// tools/quad_list_layouts.py). At 512 slots nearly every
// range at tree-1M and strip-1M is one window, so no window's gather is
// overlapped with the sweep before it; the blocks take their clusters in
// cluster order (heaviest first ran no faster there).
constexpr int QL_TARGETS = 2;
constexpr int QL_WINDOW = 512;
constexpr int QL_GROUPS = QL_WINDOW / 32;
static_assert(QL_WINDOW % 32 == 0 && QL_GROUPS <= 32,
              "a window is at most 32 groups of 32 slots");

// The live slots of a window before its slot p (0 <= p <= QL_WINDOW), from
// the lanes' group ballots gb (lane g: group g's) and their inclusive
// prefix counts incl. Every lane of the warp calls it with the same p.
__device__ __forceinline__ int live_before(int p, unsigned gb, int incl) {
  const int g = p >> 5, r = p & 31;
  const int whole = __shfl_sync(0xffffffffu, incl, g > 0 ? g - 1 : 0);
  const unsigned part = __shfl_sync(0xffffffffu, gb, g < 31 ? g : 31);
  return (g > 0 ? whole : 0) + (r ? __popc(part & ((1u << r) - 1u)) : 0);
}

// Thread t owns targets t + q blockDim.x of the cluster, q < NT, those below
// leaf live (blockDim.x: ceil(leaf / NT) in whole warps). tgt: (G, leaf,
// 3); summ: the (16, n_src + 1) table with row stride ld. The block takes
// its range in windows of QL_WINDOW slots. A window costs two barriers:
// each warp ballots the live slots of its 32-slot groups into shared
// memory; after the first barrier every warp scans the groups' counts with
// shuffles and the threads gather the live summaries into the buffer at
// their ranks, so in slot order; after the second it sweeps the buffer
// (quad_term, the term of every quadrupole kernel, each staged summary read
// once for the NT targets). The next window's ballot needs no third
// barrier: every warp has read the ballots before the second. A target's
// partial sum restarts every `chunk` slots of the range (pairs_quad: pj, a
// tile; quad_strip: pair_threads(leaf), the passes of the one-target
// kernel it replaces) and is added to its total there and at the range's
// end, so the sums are taken in that kernel's order. A null slot there
// added a zero summary's term, exactly +-0, to a partial sum that starts at
// +0 and so is never -0: dropping it leaves every bit, for finite targets.
template <typename T, int NT>
__global__ void quad_list_kernel(const T* __restrict__ tgt,
                                 const T* __restrict__ summ, int64_t ld,
                                 const int64_t* __restrict__ ids,
                                 const int64_t* __restrict__ starts,
                                 int64_t unit, int chunk, T* __restrict__ out,
                                 int leaf, int64_t n_src, T eps2) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  Summary<T>* buf = reinterpret_cast<Summary<T>*>(smem_raw);
  __shared__ unsigned bits[QL_GROUPS];
  const unsigned full = 0xffffffffu;
  const int threads = static_cast<int>(blockDim.x);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int warps = threads >> 5;
  const int64_t a = blockIdx.x;
  const int64_t lo = starts ? starts[a] * unit : a * unit;
  const int64_t hi = starts ? starts[a + 1] * unit : lo + unit;
  T x[NT], y[NT], z[NT], ax[NT], ay[NT], az[NT], tx[NT], ty[NT], tz[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int r = t + q * threads;
    const bool live = r < leaf;
    const int64_t i = 3 * (a * leaf + r);
    x[q] = live ? tgt[i] : T(0);
    y[q] = live ? tgt[i + 1] : T(0);
    z[q] = live ? tgt[i + 2] : T(0);
    ax[q] = ay[q] = az[q] = tx[q] = ty[q] = tz[q] = T(0);
  }
  for (int64_t w0 = lo; w0 < hi; w0 += QL_WINDOW) {
    for (int g = warp; g < QL_GROUPS; g += warps) {
      const int64_t s = w0 + 32 * g + lane;
      const int64_t id = s < hi ? ids[s] : -1;
      const unsigned b = __ballot_sync(full, id >= 0 && id < n_src);
      if (lane == 0) bits[g] = b;
    }
    __syncthreads();
    const unsigned gb = lane < QL_GROUPS ? bits[lane] : 0u;
    int incl = __popc(gb);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(full, incl, o);
      incl += lane >= o ? v : 0;
    }
    const int n = __shfl_sync(full, incl, 31);
    for (int g = warp; g < QL_GROUPS; g += warps) {
      const unsigned b = __shfl_sync(full, gb, g);
      const int first = __shfl_sync(full, incl, g) - __popc(b);
      if (b >> lane & 1u) {
        const int rank = first + __popc(b & ((1u << lane) - 1u));
        buf[rank] = load_summary(summ, ld, ids[w0 + 32 * g + lane]);
      }
    }
    __syncthreads();
    // the chunk ends inside the window (a window may hold several, or none)
    int e = 0;
    for (int64_t p = chunk - (w0 - lo) % chunk;; p += chunk) {
      const bool ends = p <= QL_WINDOW;
      const int stop = ends ? live_before(static_cast<int>(p), gb, incl) : n;
#pragma unroll (16 / NT)
      for (int jj = e; jj < stop; ++jj) {
        const Summary<T> sm = buf[jj];
#pragma unroll
        for (int q = 0; q < NT; ++q)
          quad_term(sm, x[q], y[q], z[q], eps2, tx[q], ty[q], tz[q]);
      }
      e = stop;
      if (!ends) break;
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        ax[q] += tx[q];
        ay[q] += ty[q];
        az[q] += tz[q];
        tx[q] = ty[q] = tz[q] = T(0);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int r = t + q * threads;
    if (r < leaf) {
      const int64_t i = 3 * (a * leaf + r);
      out[i] = ax[q] + tx[q];
      out[i + 1] = ay[q] + ty[q];
      out[i + 2] = az[q] + tz[q];
    }
  }
}

// Two clusters a block: c = 2 blockIdx.x and c + 1, members of one super
// (group is even; the group member clusters of super b are b * group ...);
// thread t < leaf owns target t of each. strips: (16, G2 * s_pad), row
// stride ld; super b's strip is columns [b * s_pad, (b + 1) * s_pad). A
// column with g*M = 0 and g*Q = 0 (null padding) adds exactly 0 and is not
// staged. The block stages each tile of its super's strip once for both
// clusters, and each staged summary is read from shared memory once for
// two targets (quad_term, the term of every quadrupole kernel). Each
// thread sums its two targets over the whole strip in registers and writes
// them once.
template <typename T>
__global__ void quad_refine_kernel(const T* __restrict__ tgt,
                                   const T* __restrict__ strips, int64_t ld,
                                   T* __restrict__ out, int leaf, int group,
                                   int64_t s_pad, T eps2) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  Summary<T>* tile = reinterpret_cast<Summary<T>*>(smem_raw);
  __shared__ int counts[32];
  const int t = threadIdx.x;
  const int64_t c = 2 * static_cast<int64_t>(blockIdx.x);
  const bool live = t < leaf;
  const int64_t at0 = 3 * (c * leaf + t);
  const int64_t at1 = at0 + 3 * static_cast<int64_t>(leaf);
  const T x0 = live ? tgt[at0] : T(0);
  const T y0 = live ? tgt[at0 + 1] : T(0);
  const T z0 = live ? tgt[at0 + 2] : T(0);
  const T x1 = live ? tgt[at1] : T(0);
  const T y1 = live ? tgt[at1 + 1] : T(0);
  const T z1 = live ? tgt[at1 + 2] : T(0);
  T ax0 = T(0), ay0 = T(0), az0 = T(0), ax1 = T(0), ay1 = T(0), az1 = T(0);
  const T* strip = strips + (c / group) * s_pad;
  for (int64_t j0 = 0; j0 < s_pad; j0 += blockDim.x) {
    const int64_t j = j0 + t;
    Summary<T> sj = zero_summary<T>();
    bool use = false;
    if (j < s_pad) {
      sj = load_summary(strip, ld, j);
      use = sj.a.w != T(0) || sj.b.x != T(0) || sj.b.y != T(0) ||
            sj.b.z != T(0) || sj.b.w != T(0) || sj.c.x != T(0) ||
            sj.c.y != T(0);
    }
    int n;
    const int r = live_rank(use, counts, n);
    if (use) tile[r] = sj;
    __syncthreads();
    T tx0 = T(0), ty0 = T(0), tz0 = T(0), tx1 = T(0), ty1 = T(0), tz1 = T(0);
#pragma unroll 8
    for (int jj = 0; jj < n; ++jj) {
      const Summary<T> s = tile[jj];
      quad_term(s, x0, y0, z0, eps2, tx0, ty0, tz0);
      quad_term(s, x1, y1, z1, eps2, tx1, ty1, tz1);
    }
    ax0 += tx0;
    ay0 += ty0;
    az0 += tz0;
    ax1 += tx1;
    ay1 += ty1;
    az1 += tz1;
    __syncthreads();
  }
  if (live) {
    out[at0] = ax0;
    out[at0 + 1] = ay0;
    out[at0 + 2] = az0;
    out[at1] = ax1;
    out[at1 + 1] = ay1;
    out[at1 + 2] = az1;
  }
}

// quad_dense and quad_masked: QTILE summary columns a pass; a target sums
// each tile's terms apart, so its bits depend on where the tiles start.
// The targets a thread and the threads a block were chosen on the card
// (PERF.md §6).
constexpr int QTILE = 256;
constexpr int QUAD_TARGETS = 2;
constexpr int QUAD_THREADS = 256;
static_assert(QTILE % QUAD_THREADS == 0, "a tile is whole passes");

// quad_dense (MASKED false) and quad_masked. tgt: (n2 * rows, 3), target
// super a in rows [a * rows, (a + 1) * rows) (quad_dense: n2 = 1, rows =
// M). summ: (16, S) with row stride ld. keep (MASKED): (n2, S) bytes, 0
// where column j is one of super a's near supers. out: (n2 * rows, 3).
// Grid: (ceil(rows / (NT blockDim.x)), n2), so no block straddles two
// supers; thread t owns rows r0 + t + q blockDim.x, q < NT. Each pass takes
// the next QTILE columns and stages the live ones (inside S and, MASKED,
// kept by super a's row: the same for every warp of the block), packed to
// the tile's front in column order (live_rank). A masked column (g*M = 0
// and g*Q = 0) would add exactly +-0 to a sum that starts at +0, so
// dropping it leaves every bit. Each staged summary is read
// from shared memory once for the thread's NT targets (quad_term, the term
// of every quadrupole kernel), and each target sums a tile's terms in column
// order apart, then adds that sum to its total.
template <typename T, bool MASKED, int NT>
__global__ void quad_two_kernel(const T* __restrict__ tgt,
                                const T* __restrict__ summ, int64_t ld,
                                const unsigned char* __restrict__ keep,
                                T* __restrict__ out, int64_t rows, int64_t s,
                                T eps2) {
  __shared__ Summary<T> tile[QTILE];
  __shared__ int counts[32];
  const int threads = static_cast<int>(blockDim.x);
  const int t = threadIdx.x;
  const int64_t a = blockIdx.y;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * NT * threads + t;
  const unsigned char* keep_a = MASKED ? keep + a * s : nullptr;
  T x[NT], y[NT], z[NT], ax[NT], ay[NT], az[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int64_t r = r0 + static_cast<int64_t>(q) * threads;
    const int64_t i = 3 * (a * rows + r);
    const bool live = r < rows;
    x[q] = live ? tgt[i] : T(0);
    y[q] = live ? tgt[i + 1] : T(0);
    z[q] = live ? tgt[i + 2] : T(0);
    ax[q] = ay[q] = az[q] = T(0);
  }
  for (int64_t j0 = 0; j0 < s; j0 += QTILE) {
    int n = 0;
    for (int p = 0; p < QTILE; p += threads) {
      const int64_t j = j0 + p + t;
      const bool use = j < s && (!MASKED || keep_a[j]);
      int live;
      const int r = live_rank(use, counts, live);
      if (use) tile[n + r] = load_summary(summ, ld, j);
      n += live;
      __syncthreads();
    }
    T tx[NT], ty[NT], tz[NT];
#pragma unroll
    for (int q = 0; q < NT; ++q) tx[q] = ty[q] = tz[q] = T(0);
#pragma unroll (8 / NT)
    for (int jj = 0; jj < n; ++jj) {
      const Summary<T> sm = tile[jj];
#pragma unroll
      for (int q = 0; q < NT; ++q)
        quad_term(sm, x[q], y[q], z[q], eps2, tx[q], ty[q], tz[q]);
    }
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      ax[q] += tx[q];
      ay[q] += ty[q];
      az[q] += tz[q];
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int64_t r = r0 + static_cast<int64_t>(q) * threads;
    if (r < rows) {
      const int64_t i = 3 * (a * rows + r);
      out[i] = ax[q];
      out[i + 1] = ay[q];
      out[i + 2] = az[q];
    }
  }
}

// Clusters a pairs_quad_shared block. Four read each staged summary for
// more targets but need more registers, so fewer blocks fit an SM; they
// ran slower than two at far3-4M.
constexpr int QS_CLUSTERS = 2;

// pairs_quad_shared: NT consecutive clusters a block, c = NT blockIdx.x +
// j for j < NT (those at or past g are absent); thread t < leaf owns target
// t of each. tile_src: tile k reads its pj column ids from source tile
// tile_src[k] of flat_src; cluster c owns the tiles [tile_start[c],
// tile_start[c + 1]). In the MID lists (shared_pair_segments) the member
// clusters of one super own the same tile_src sequence, and a super's
// member count is a multiple of NT, so the block walks one sequence: step s
// of the walk stages its source tile once for all NT clusters, and each
// thread sweeps every staged summary for its NT targets (quad_term, the
// term of every quadrupole kernel), so a summary is gathered once a block
// and read from shared memory once for NT targets. Any other tile list is
// walked correctly too: at step s the block stages each distinct source
// tile among its clusters' s-th tiles once, sweeps it for all NT targets and
// adds the sums only to the clusters whose s-th tile it is (the branch is
// the same for the whole block). Each pass over a tile takes blockDim.x of
// its slots; the live ids (in [0, n_src)) are packed to the front in slot
// order (live_rank), so null slots (a strip's tail) cost nothing. Two
// barriers a pass: live_rank's, which also keeps the next pass from
// restaging before every warp has swept, and one before the sweep. The
// sweep is issue-bound; overlapping the next pass's gather with it (held in
// registers, or by cp.async into a second buffer) took more registers and
// gained nothing at far3-4M: the SM's other blocks hide the gather.
template <typename T, int NT>
__global__ void pairs_quad_shared_kernel(
    const T* __restrict__ tgt, const T* __restrict__ summ, int64_t ld,
    const int64_t* __restrict__ flat_src,
    const int64_t* __restrict__ tile_src,
    const int64_t* __restrict__ tile_start, T* __restrict__ out, int64_t g,
    int leaf, int pj, int64_t n_src, T eps2) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  Summary<T>* tile = reinterpret_cast<Summary<T>*>(smem_raw);
  __shared__ int counts[32];
  const int t = threadIdx.x;
  const int threads = static_cast<int>(blockDim.x);
  const int64_t c0 = static_cast<int64_t>(NT) * blockIdx.x;
  T x[NT], y[NT], z[NT], ax[NT], ay[NT], az[NT];
  int64_t k0[NT];
  int nt[NT];
  int steps = 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int64_t c = c0 + j;
    const bool has = c < g;
    const bool live = has && t < leaf;
    const int64_t at = 3 * (c * leaf + t);
    x[j] = live ? tgt[at] : T(0);
    y[j] = live ? tgt[at + 1] : T(0);
    z[j] = live ? tgt[at + 2] : T(0);
    ax[j] = ay[j] = az[j] = T(0);
    k0[j] = has ? tile_start[c] : 0;
    nt[j] = has ? static_cast<int>(tile_start[c + 1] - k0[j]) : 0;
    steps = nt[j] > steps ? nt[j] : steps;
  }
  for (int s = 0; s < steps; ++s) {
    int64_t src[NT];
    unsigned pending = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      src[j] = s < nt[j] ? tile_src[k0[j] + s] : 0;
      pending |= s < nt[j] ? 1u << j : 0u;
    }
    while (pending) {
      // the first pending cluster's source tile, and every pending cluster
      // whose s-th tile it is
      int64_t cur = 0;
      bool found = false;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (!found && (pending >> j & 1u)) {
          cur = src[j];
          found = true;
        }
      }
      unsigned mask = 0;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mask |= (pending >> j & 1u) && src[j] == cur ? 1u << j : 0u;
      pending &= ~mask;
      const int64_t* ids = flat_src + cur * pj;
      T tx[NT], ty[NT], tz[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) tx[j] = ty[j] = tz[j] = T(0);
      for (int e0 = 0; e0 < pj; e0 += threads) {
        const int64_t id = e0 + t < pj ? ids[e0 + t] : -1;
        const bool use = id >= 0 && id < n_src;
        int n;
        const int r = live_rank(use, counts, n);
        if (use) tile[r] = load_summary(summ, ld, id);
        __syncthreads();
#pragma unroll 8
        for (int jj = 0; jj < n; ++jj) {
          const Summary<T> sm = tile[jj];
#pragma unroll
          for (int j = 0; j < NT; ++j)
            quad_term(sm, x[j], y[j], z[j], eps2, tx[j], ty[j], tz[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (mask >> j & 1u) {
          ax[j] += tx[j];
          ay[j] += ty[j];
          az[j] += tz[j];
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int64_t c = c0 + j;
    if (c < g && t < leaf) {
      const int64_t at = 3 * (c * leaf + t);
      out[at] = ax[j];
      out[at + 1] = ay[j];
      out[at + 2] = az[j];
    }
  }
}

// Threads of a pair-kernel block: one per slot of a cluster block, in whole
// warps.
unsigned pair_threads(int leaf) {
  return static_cast<unsigned>((leaf + 1 + 31) / 32 * 32);
}

// The direct law's weight for `launch` (a generic callable taking the
// weight): DirectLean where LEAN and the host chose the MUFU rsqrt alone
// (lean: float32, plummer, eps^2 >= FLT_MIN, checked by the entry), else
// DirectWeight<T, law, MASK>, MASK where eps == 0 or, under the plummer
// law, where the float32 eps^2 is flushed to 0 (flushed_eps2; then eps2 is
// 0).
template <typename T, bool LEAN, class F>
cudaError_t with_direct_weight(int law, bool lean, double eps, F&& launch) {
  const T e = static_cast<T>(eps), e2 = static_cast<T>(eps * eps);
  if constexpr (LEAN && std::is_same_v<T, float>) {
    if (lean) return launch(DirectLean<float>{e2});
  }
  if (law == PLUMMER) {
    if (eps == 0.0 || flushed_eps2<T>(eps))
      return launch(DirectWeight<T, PLUMMER, true>{e, T(0)});
    return launch(DirectWeight<T, PLUMMER, false>{e, e2});
  }
  if (law == REF)
    return eps == 0.0 ? launch(DirectWeight<T, REF, true>{e, e2})
                      : launch(DirectWeight<T, REF, false>{e, e2});
  return cudaErrorInvalidValue;
}

// pairs_direct (HYBRID false) and pairs_hybrid: pairs_two_kernel, `threads`
// a block (two targets a thread).
template <typename T, bool HYBRID>
cudaError_t launch_pairs_two(int law, bool lean, const void* tgt,
                             const void* srows, int64_t ld,
                             const int64_t* flat_src,
                             const int64_t* tile_start, const int64_t* order,
                             void* out, int64_t g, int leaf, int pj,
                             int64_t n_src, double eps, int threads,
                             cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(leaf + 1) * sizeof(Vec4<T>) * (HYBRID ? 2 : 1);
  return with_direct_weight<T, true>(law, lean, eps, [&](auto weight) {
    pairs_two_kernel<T, decltype(weight), HYBRID>
        <<<static_cast<unsigned>(g), static_cast<unsigned>(threads), smem,
           stream>>>(static_cast<const T*>(tgt),
                     static_cast<const T*>(srows), ld, flat_src, tile_start,
                     order, static_cast<T*>(out), leaf, pj, n_src, weight);
    return cudaGetLastError();
  });
}

// Clusters of a pairs_cut_kernel stage, and its shared memory: the staged
// entries (padded to whole chunks; with HYBRID twice, x_s and x_s - c) and
// a box a chunk. Float32 at leaf 255: 8 clusters, 33 KB (HYBRID 66 KB).
template <typename T>
int cut_cap(int leaf) {
  const int entries = CUT_STAGE_BYTES / static_cast<int>(sizeof(Vec4<T>));
  return entries / (leaf + 1) > 1 ? entries / (leaf + 1) : 1;
}

template <typename T, bool HYBRID>
size_t cut_smem(int leaf) {
  const size_t padded =
      (static_cast<size_t>(cut_cap<T>(leaf)) * (leaf + 1) + CUT_CHUNK - 1) /
      CUT_CHUNK * CUT_CHUNK;
  return padded * sizeof(Vec4<T>) * (HYBRID ? 2 : 1) +
         padded / CUT_CHUNK * sizeof(Box<T>);
}

template <typename T, bool HYBRID, class W>
cudaError_t launch_pairs_cut(const void* tgt, const void* srows, int64_t ld,
                             const int64_t* flat_src,
                             const int64_t* tile_start, void* out, int64_t g,
                             int leaf, int pj, int64_t n_src, const W weight,
                             cudaStream_t stream) {
  const size_t smem = cut_smem<T, HYBRID>(leaf);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pairs_cut_kernel<T, W, HYBRID>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  pairs_cut_kernel<T, W, HYBRID>
      <<<static_cast<unsigned>(g), pair_threads(leaf), smem, stream>>>(
          static_cast<const T*>(tgt), static_cast<const T*>(srows), ld,
          flat_src, tile_start, static_cast<T*>(out), leaf, pj, n_src,
          cut_cap<T>(leaf), weight);
  return cudaGetLastError();
}

// The TreePM short-range law (pairs_short, and pairs_short_hybrid with
// HYBRID), both splits on the walk. rcut is used by POLY, rs by GAUSS. The
// poly split takes PolyLean for plummer at eps = 0; the gauss split takes
// GaussLean where the plummer eps^2 is 0 in T, the one case whose weight
// has an exact zero (beyond HLONG_VMAX) for the walk to skip; elsewhere
// ShortWeight, every gauss chunk swept.
template <typename T, bool HYBRID>
cudaError_t launch_pairs_short_law(int law, int split, const void* tgt,
                                   const void* srows, int64_t ld,
                                   const int64_t* flat_src,
                                   const int64_t* tile_start, void* out,
                                   int64_t g, int leaf, int pj, int64_t n_src,
                                   double eps, double rs, double rcut,
                                   cudaStream_t stream) {
  const T e = static_cast<T>(eps), e2 = static_cast<T>(eps * eps);
#define SPACETPU_CUT(W, ...)                                                 \
  launch_pairs_cut<T, HYBRID>(tgt, srows, ld, flat_src, tile_start, out, g,  \
                              leaf, pj, n_src, W{__VA_ARGS__}, stream)
  if (split == POLY) {
    const T inv_rc2 = static_cast<T>(1.0 / (rcut * rcut));
    using Plummer = ShortWeight<T, PLUMMER, POLY>;
    using Ref = ShortWeight<T, REF, POLY>;
    if (law == PLUMMER && eps == 0.0)
      return SPACETPU_CUT(PolyLean<T>, inv_rc2);
    if (law == PLUMMER)
      return SPACETPU_CUT(Plummer, e, e2, inv_rc2, T(0), T(0));
    if (law == REF) return SPACETPU_CUT(Ref, e, e2, inv_rc2, T(0), T(0));
    return cudaErrorInvalidValue;
  }
  const double inv4rs2 = 1.0 / (4.0 * rs * rs);
  const T v_scale = static_cast<T>(inv4rs2);
  const T w_in_scale = static_cast<T>(inv4rs2 * (0.5 / rs));
  using Plummer = ShortWeight<T, PLUMMER, GAUSS>;
  using Ref = ShortWeight<T, REF, GAUSS>;
  if (split == GAUSS && law == PLUMMER && e2 == T(0))
    return SPACETPU_CUT(GaussLean<T>, v_scale, w_in_scale);
  if (split == GAUSS && law == PLUMMER)
    return SPACETPU_CUT(Plummer, e, e2, T(0), v_scale, w_in_scale);
  if (split == GAUSS && law == REF)
    return SPACETPU_CUT(Ref, e, e2, T(0), v_scale, w_in_scale);
#undef SPACETPU_CUT
  return cudaErrorInvalidValue;
}

// quad_dense (keep null, n2 = 1) and quad_masked: QUAD_TARGETS targets a
// thread in QUAD_THREADS-thread blocks.
template <typename T, bool MASKED>
cudaError_t launch_quad_two(const void* tgt, const void* summ, int64_t ld,
                            const unsigned char* keep, void* out, int64_t n2,
                            int64_t rows, int64_t s, double eps,
                            cudaStream_t stream) {
  constexpr int64_t per_block =
      static_cast<int64_t>(QUAD_TARGETS) * QUAD_THREADS;
  const dim3 grid(static_cast<unsigned>((rows + per_block - 1) / per_block),
                  static_cast<unsigned>(n2));
  quad_two_kernel<T, MASKED, QUAD_TARGETS><<<grid, QUAD_THREADS, 0, stream>>>(
      static_cast<const T*>(tgt), static_cast<const T*>(summ), ld, keep,
      static_cast<T*>(out), rows, s, static_cast<T>(eps * eps));
  return cudaGetLastError();
}

// Threads of a quad_list_kernel block: ceil(leaf / QL_TARGETS) in whole
// warps (two_target_threads at QL_TARGETS = 2).
unsigned quad_list_threads(int leaf) {
  return static_cast<unsigned>((leaf + QL_TARGETS - 1) / QL_TARGETS + 31) /
         32 * 32;
}

// A quad_list_kernel block's staging buffer: one window of summaries
// (float32 24 KB; float64 48 KB, beside the ballots past the 48 KB a
// kernel gets without opting in).
template <typename T>
size_t quad_list_smem() {
  return static_cast<size_t>(QL_WINDOW) * sizeof(Summary<T>);
}

// pairs_quad (starts: the tile starts, unit = pj, chunk = pj) and
// quad_strip (starts null, unit = K, chunk = pair_threads(leaf)).
template <typename T>
cudaError_t launch_quad_list(const void* tgt, const void* summ, int64_t ld,
                             const int64_t* ids, const int64_t* starts,
                             int64_t unit, int chunk, void* out, int64_t g,
                             int leaf, int64_t n_src, double eps,
                             cudaStream_t stream) {
  const size_t smem = quad_list_smem<T>();
  if (smem + QL_GROUPS * sizeof(unsigned) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        quad_list_kernel<T, QL_TARGETS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  quad_list_kernel<T, QL_TARGETS>
      <<<static_cast<unsigned>(g), quad_list_threads(leaf), smem, stream>>>(
          static_cast<const T*>(tgt), static_cast<const T*>(summ), ld, ids,
          starts, unit, chunk, static_cast<T*>(out), leaf, n_src,
          static_cast<T>(eps * eps));
  return cudaGetLastError();
}

// The arguments of pairs_quad and quad_strip, dtype 0 (float32) or 1.
int quad_list_entry(int dtype, const void* tgt, const void* summ,
                    long long ld, const int64_t* ids, const int64_t* starts,
                    long long unit, int chunk, void* out, long long g,
                    int leaf, long long n_src, double eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_quad_list<float>(tgt, summ, ld, ids, starts, unit, chunk,
                                   out, g, leaf, n_src, eps, st);
  if (dtype == 1)
    return launch_quad_list<double>(tgt, summ, ld, ids, starts, unit, chunk,
                                    out, g, leaf, n_src, eps, st);
  return cudaErrorInvalidValue;
}

// The staged summaries of a pairs_quad_shared pass: one a thread, at most
// pj.
size_t quad_shared_smem(int dtype, int leaf, int pj) {
  const size_t elem = dtype == 1 ? sizeof(double) : sizeof(float);
  const size_t slots = pair_threads(leaf) < static_cast<unsigned>(pj)
                           ? pair_threads(leaf)
                           : static_cast<unsigned>(pj);
  return slots * 12 * elem;
}

template <typename T>
cudaError_t launch_pairs_quad_shared(const void* tgt, const void* summ,
                                     int64_t ld, const int64_t* flat_src,
                                     const int64_t* tile_src,
                                     const int64_t* tile_start, void* out,
                                     int64_t g, int leaf, int pj,
                                     int64_t n_src, double eps,
                                     cudaStream_t stream) {
  const int dtype = sizeof(T) == sizeof(double) ? 1 : 0;
  const unsigned blocks =
      static_cast<unsigned>((g + QS_CLUSTERS - 1) / QS_CLUSTERS);
  pairs_quad_shared_kernel<T, QS_CLUSTERS>
      <<<blocks, pair_threads(leaf), quad_shared_smem(dtype, leaf, pj),
         stream>>>(
          static_cast<const T*>(tgt), static_cast<const T*>(summ), ld,
          flat_src, tile_src, tile_start, static_cast<T*>(out), g, leaf, pj,
          n_src, static_cast<T>(eps * eps));
  return cudaGetLastError();
}

// A pair kernel's block is one cluster block (at most 1024 threads) and its
// shared memory stays inside the 48 KB a kernel gets without opting in (or
// inside `limit`, where the launch opts in).
bool pair_shape_ok(int64_t g, int leaf, int pj, size_t smem,
                   size_t limit = 48 * 1024) {
  return g > 0 && leaf > 0 && leaf < 1024 && pj > 0 && smem <= limit;
}

template <typename T, bool PSEUDO>
cudaError_t launch_near_strip(int law, bool lean, const void* tgt,
                              const void* pool_pos, const void* pool_mass,
                              const void* pool_com, const void* pool_mtot,
                              const int64_t* idx, const int64_t* order,
                              void* out, int64_t g_t,
                              int leaf, int64_t k, int64_t p, double g,
                              double eps, int threads, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(leaf + 1) * sizeof(Vec4<T>);
  return with_direct_weight<T, true>(law, lean, eps, [&](auto weight) {
    near_strip_kernel<T, decltype(weight), PSEUDO>
        <<<static_cast<unsigned>(g_t), static_cast<unsigned>(threads), smem,
           stream>>>(
            static_cast<const T*>(tgt), static_cast<const T*>(pool_pos),
            static_cast<const T*>(pool_mass),
            static_cast<const T*>(pool_com),
            static_cast<const T*>(pool_mtot), idx, order, static_cast<T*>(out),
            leaf, k, p, static_cast<T>(g), weight);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_quad_refine(const void* tgt, const void* strips,
                               int64_t ld, void* out, int64_t gg, int leaf,
                               int group, int64_t s_pad, double eps,
                               cudaStream_t stream) {
  const unsigned threads = pair_threads(leaf);
  quad_refine_kernel<T><<<static_cast<unsigned>(gg / 2), threads,
                          threads * sizeof(Summary<T>), stream>>>(
      static_cast<const T*>(tgt), static_cast<const T*>(strips), ld,
      static_cast<T*>(out), leaf, group, s_pad, static_cast<T>(eps * eps));
  return cudaGetLastError();
}

// quad_refine's staged summary tile: one summary a thread of the block.
size_t summary_tile_bytes(int dtype, int leaf) {
  const size_t elem = dtype == 1 ? sizeof(double) : sizeof(float);
  return static_cast<size_t>(pair_threads(leaf)) * 12 * elem;
}

// The two-target kernels' launch arguments: `threads` covers the leaf
// targets two a thread in whole warps, and `lean` (the MUFU rsqrt alone)
// only where it gives rsqrtf's bits: float32, plummer, eps^2 a normal
// float32.
bool two_target_ok(int dtype, int law, int leaf, int threads, int lean,
                   double eps) {
  return threads > 0 && threads <= 1024 && threads % 32 == 0 &&
         2 * threads >= leaf && (!lean || lean_ok(dtype, law, eps));
}

// pairs_short and pairs_short_hybrid. split: 0 = poly, 1 = gauss.
template <bool HYBRID>
int pairs_short_entry(int dtype, int law, int split, const void* tgt,
                      const void* srows, long long ld, const void* flat_src,
                      const void* tile_start, void* out, long long g,
                      int leaf, int pj, long long n_src, double eps,
                      double rs, double rcut, void* stream) {
  size_t smem = 0;
  if (leaf > 0)
    smem = dtype == 1 ? cut_smem<double, HYBRID>(leaf)
                      : cut_smem<float, HYBRID>(leaf);
  if (!pair_shape_ok(g, leaf, pj, smem, 227 * 1024))
    return cudaErrorInvalidValue;
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

// pairs_direct and pairs_hybrid (HYBRID).
template <bool HYBRID>
int pairs_two_entry(int dtype, int law, int lean, const void* tgt,
                    const void* srows, long long ld, const void* flat_src,
                    const void* tile_start, const void* order, void* out,
                    long long g, int leaf, int pj, long long n_src,
                    double eps, int threads, void* stream) {
  const size_t elem = dtype == 1 ? sizeof(double) : sizeof(float);
  if (!pair_shape_ok(g, leaf, pj,
                     static_cast<size_t>(leaf + 1) * 4 * elem *
                         (HYBRID ? 2 : 1)) ||
      !two_target_ok(dtype, law, leaf, threads, lean, eps))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* fs = static_cast<const int64_t*>(flat_src);
  const int64_t* ts = static_cast<const int64_t*>(tile_start);
  const int64_t* od = static_cast<const int64_t*>(order);
  if (dtype == 0)
    return launch_pairs_two<float, HYBRID>(law, lean, tgt, srows, ld, fs, ts,
                                           od, out, g, leaf, pj, n_src, eps,
                                           threads, st);
  if (dtype == 1)
    return launch_pairs_two<double, HYBRID>(law, lean, tgt, srows, ld, fs, ts,
                                            od, out, g, leaf, pj, n_src, eps,
                                            threads, st);
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
    return launch_quad_two<float, false>(tgt, summ, ld, nullptr, out, 1, m, s,
                                         eps, st);
  if (dtype == 1)
    return launch_quad_two<double, false>(tgt, summ, ld, nullptr, out, 1, m,
                                          s, eps, st);
  return cudaErrorInvalidValue;
}

// lean: 1 = the MUFU rsqrt alone (two_target_ok); threads: a block's;
// order: (g,) int64, the target clusters in block order (a permutation).
extern "C" int spacetpu_pairs_direct(int dtype, int law, int lean,
                                     const void* tgt, const void* srows,
                                     long long ld, const void* flat_src,
                                     const void* tile_start,
                                     const void* order, void* out,
                                     long long g, int leaf, int pj,
                                     long long n_src, double eps,
                                     int threads, void* stream) {
  return pairs_two_entry<false>(dtype, law, lean, tgt, srows, ld, flat_src,
                                tile_start, order, out, g, leaf, pj, n_src,
                                eps, threads, stream);
}

// The arguments of spacetpu_pairs_direct.
extern "C" int spacetpu_pairs_hybrid(int dtype, int law, int lean,
                                     const void* tgt, const void* srows,
                                     long long ld, const void* flat_src,
                                     const void* tile_start,
                                     const void* order, void* out,
                                     long long g, int leaf, int pj,
                                     long long n_src, double eps,
                                     int threads, void* stream) {
  return pairs_two_entry<true>(dtype, law, lean, tgt, srows, ld, flat_src,
                               tile_start, order, out, g, leaf, pj, n_src,
                               eps, threads, stream);
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

// flat_src: (T * pj) int64 column ids of summ (16, n_src + 1), tile k in
// [k * pj, (k + 1) * pj); tile_start: (g + 1), cluster a owns the tiles
// [tile_start[a], tile_start[a + 1]).
extern "C" int spacetpu_pairs_quad(int dtype, const void* tgt,
                                   const void* summ, long long ld,
                                   const void* flat_src,
                                   const void* tile_start, void* out,
                                   long long g, int leaf, int pj,
                                   long long n_src, double eps, void* stream) {
  if (!pair_shape_ok(g, leaf, pj, 0) || n_src < 0 || ld <= n_src ||
      g > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  return quad_list_entry(dtype, tgt, summ, ld,
                         static_cast<const int64_t*>(flat_src),
                         static_cast<const int64_t*>(tile_start), pj, pj, out,
                         g, leaf, n_src, eps, stream);
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
    return launch_quad_two<float, true>(tgt, summ, ld, kp, out, n2, rows, s,
                                        eps, st);
  if (dtype == 1)
    return launch_quad_two<double, true>(tgt, summ, ld, kp, out, n2, rows, s,
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
  if (!pair_shape_ok(g, leaf, pj, quad_shared_smem(dtype, leaf, pj)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* fs = static_cast<const int64_t*>(flat_src);
  const int64_t* tsrc = static_cast<const int64_t*>(tile_src);
  const int64_t* ts = static_cast<const int64_t*>(tile_start);
  if (dtype == 0)
    return launch_pairs_quad_shared<float>(tgt, summ, ld, fs, tsrc, ts, out,
                                           g, leaf, pj, n_src, eps, st);
  if (dtype == 1)
    return launch_pairs_quad_shared<double>(tgt, summ, ld, fs, tsrc, ts, out,
                                            g, leaf, pj, n_src, eps, st);
  return cudaErrorInvalidValue;
}

// pseudo: 1 = the pseudo-body carries -g M (monopole far field), 0 = it
// carries nothing. idx: (g_t, k) int64 pool ids, p = the null cluster.
// lean, threads and order (g_t,) as for spacetpu_pairs_hybrid.
extern "C" int spacetpu_near_strip(int dtype, int law, int pseudo, int lean,
                                   const void* tgt, const void* pool_pos,
                                   const void* pool_mass,
                                   const void* pool_com,
                                   const void* pool_mtot, const void* idx,
                                   const void* order,
                                   void* out, long long g_t, int leaf,
                                   long long k, long long p, double g,
                                   double eps, int threads, void* stream) {
  const size_t elem = dtype == 1 ? sizeof(double) : sizeof(float);
  if (!pair_shape_ok(g_t, leaf, 1, static_cast<size_t>(leaf + 1) * 4 * elem)
      || !two_target_ok(dtype, law, leaf, threads, lean, eps) || k < 0 ||
      p < 0 || g_t > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* ix = static_cast<const int64_t*>(idx);
#define SPACETPU_STRIP_ENTRY(T, PSEUDO)                                       \
  launch_near_strip<T, PSEUDO>(law, lean, tgt, pool_pos, pool_mass, pool_com, \
                               pool_mtot, ix,                                 \
                               static_cast<const int64_t*>(order), out, g_t,  \
                               leaf, k, p, g, eps, threads, st)
  if (dtype == 0)
    return pseudo ? SPACETPU_STRIP_ENTRY(float, true)
                  : SPACETPU_STRIP_ENTRY(float, false);
  if (dtype == 1)
    return pseudo ? SPACETPU_STRIP_ENTRY(double, true)
                  : SPACETPU_STRIP_ENTRY(double, false);
#undef SPACETPU_STRIP_ENTRY
  return cudaErrorInvalidValue;
}

// summ: (16, n_src + 1) with row stride ld; idx: (g_t, k) int64 column ids,
// n_src = the null column.
extern "C" int spacetpu_quad_strip(int dtype, const void* tgt,
                                   const void* summ, long long ld,
                                   const void* idx, void* out, long long g_t,
                                   int leaf, long long k, long long n_src,
                                   double eps, void* stream) {
  if (!pair_shape_ok(g_t, leaf, 1, 0) || k < 0 || n_src < 0 ||
      ld <= n_src || g_t > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  return quad_list_entry(dtype, tgt, summ, ld,
                         static_cast<const int64_t*>(idx), nullptr, k,
                         static_cast<int>(pair_threads(leaf)), out, g_t, leaf,
                         n_src, eps, stream);
}

// strips: (16, (gg / group) * s_pad) with row stride ld; tgt and out: (gg,
// leaf, 3), gg a multiple of group, group even (two clusters a block).
extern "C" int spacetpu_quad_refine(int dtype, const void* tgt,
                                    const void* strips, long long ld,
                                    void* out, long long gg, int leaf,
                                    int group, long long s_pad, double eps,
                                    void* stream) {
  if (!pair_shape_ok(gg, leaf, 1, summary_tile_bytes(dtype, leaf)) ||
      group <= 0 || group % 2 || gg % group || s_pad < 0 ||
      ld < gg / group * s_pad ||
      gg > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_quad_refine<float>(tgt, strips, ld, out, gg, leaf, group,
                                     s_pad, eps, st);
  if (dtype == 1)
    return launch_quad_refine<double>(tgt, strips, ld, out, gg, leaf, group,
                                      s_pad, eps, st);
  return cudaErrorInvalidValue;
}
