// Nearest neighbours on Hopper (sm_90a), with a plain C interface for
// ctypes (spacetpu_torch/ops/encounters.py binds and wraps it).
//
// nearest_neighbor replaces no TPU kernel: it is the O(N^2) pass of
// spacetpu/ops/encounters.py:nearest_neighbor (a jitted j-chunked scan that
// the JAX package leaves to XLA), which the encounter report and every
// collision check run (spacetpu/ops/collisions.py: merge_closest).
//
// For every body i: the least r^2 = |x_j - x_i|^2 over the live bodies
// j != i, and the lowest j that reaches it; (+inf, 0) where no live j
// exists. That is the least (r^2, j) in lexicographic order, starting from
// (+inf, 0): a candidate at +inf is never taken, and the least does not
// depend on the order in which the candidates are met.
//   - What bounds it: arithmetic over the N (N - 1) / 2 unordered pairs
//     (r^2 of (i, j) and of (j, i) have the same bits: x_j - x_i rounds to
//     -(x_i - x_j) exactly, and the squares drop the sign): 3 differences,
//     3 squares, 2 sums and a compare for each of its two rows. The bytes
//     are O(N).
//   - What the design does: pair_potential's half ring (csrc/direct.cu).
//     The bodies fall into blocks of R = 32 P rows. Block I takes the tile
//     pairs (I, J = (I + d) mod B) for d = 1 .. B/2 (for an even B, d = B/2
//     only for I < B/2), in bands of at most `slots` offsets, one launch a
//     band; the diagonal tiles (I, I) are a kernel of their own, the only
//     one with the self pair's index test. A lane holds P rows in registers
//     (position, least r^2 and its index), every warp of a block the same
//     rows, and each warp sweeps its share of J's columns, staged 32 at a
//     time in shared memory and read by broadcast. One r^2 serves the row
//     (candidate (r^2, j)) and the column (candidate (r^2, i)).
//   - Order and ties: a lane meets its rows' candidates in increasing column
//     order (a band visits the wrapped tiles J < I first, then J > I), so a
//     strict < keeps the lowest index there; a lane's column candidates
//     come from rows in increasing order too. Everything else (the lanes of
//     a column, the warps of a row, the bands, the slots, the diagonal
//     tile) is joined by the lexicographic compare.
//   - The mask: a dead body (alive[j] == 0) is still a row and needs its
//     nearest live body, so the pair (i, j) feeds row i only where j is
//     live and row j only where i is live. A warp whose rows and staged
//     columns are all live (nearly every one) sweeps without a mask; the
//     others add +inf to a dead column's row candidates and take +inf for a
//     dead row's column candidates. Rows and columns past N are dead.
//   - Why the result has one value: a band's rows are written by their own
//     block only; a column's candidate from offset d goes to slot d - d_lo
//     (per band), which in one launch only block J - d writes; the join
//     takes the slots into the rows. A least is the same in any order.
//   - Rounding: r^2 = (dx dx + dy dy) + dz dz, each product and sum rounded
//     on its own (no FMA), as the plain version's elementwise steps round
//     it: the same r^2 bits, so the same neighbours.
//
// nearest_rows and nearest_update serve collisions.merge_all_overlapping,
// which keeps the table (least r^2, index) across its merges: a merge
// moves body i to the barycentre and kills body j, so only the rows R =
// {i, j} and those whose neighbour was i or j are searched again
// (nearest_rows: those rows against every live body, each block a slice of
// the sources, the slices joined by the lexicographic compare), and every
// other row compares the moved body with its least (nearest_update, which
// also lists R). Both are bound by reading the positions (O(N) bytes).

#include "pair.cuh"

#include <cmath>

namespace {

// Rows a lane of nn_band_kernel holds (NN_P) and warps a block (NN_WARPS),
// for float32; float64 holds twice the registers a row. A block owns 32
// NN_P rows, and each warp sweeps 32 NN_P / NN_WARPS columns of a tile pair.
constexpr int NN_P = 16;
constexpr int NN_WARPS = 16;
constexpr int NN_P64 = 8;
constexpr int NN_WARPS64 = 8;
// Columns a trip of the band kernel's column loop (its unroll). On an H100
// at 700 W, N = 1,000,000 (tools/nearest_layouts.py): 16x16 rows x warps
// with 2 columns a trip 280.3 ms, with 1, 3, 4, 8: 282.3, 304.9, 292.9,
// 314.7; 16x8x4 298.0, 8x8x4 307.6, 12x12x2 312.8, 16x4x2 442.2.
constexpr int NN_UNROLL = 2;
// Threads a block of the diagonal, join and update kernels.
constexpr int NN_THREADS = 256;
// nearest_rows: rows a block, threads a block and sources a slice.
constexpr int NR_ROWS = 16;
constexpr int NR_THREADS = 128;
constexpr int NR_SLICE = 4096;

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

// r^2 of the source s and the target (x, y, z), d = s - target, rounded
// step by step as the plain version rounds it.
template <typename T>
__device__ __forceinline__ T r2_of(T sx, T sy, T sz, T x, T y, T z) {
  const T dx = sub_rn(sx, x);
  const T dy = sub_rn(sy, y);
  const T dz = sub_rn(sz, z);
  return add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
}

// (v, a) < (bv, ba) in lexicographic order.
template <typename T, typename I, typename J>
__device__ __forceinline__ bool lex_less(T v, I a, T bv, J ba) {
  return v < bv || (v == bv && static_cast<int64_t>(a) < static_cast<int64_t>(ba));
}

// Body j staged: its position, and 0 where it is a live source, +inf where
// it is dead or past n (then at the origin).
template <typename T>
__device__ __forceinline__ Vec4<T> stage_body(const T* pos, const uint8_t* alive,
                                              int64_t j, int64_t n) {
  if (j >= n) return Vec4<T>{T(0), T(0), T(0), inf_<T>()};
  const int64_t r = 3 * j;
  const bool live = alive == nullptr || alive[j] != 0;
  return Vec4<T>{pos[r], pos[r + 1], pos[r + 2], live ? T(0) : inf_<T>()};
}

// The dynamic shared memory of nn_band_kernel<T, P, WARPS>: a warp's 32
// staged columns and its (column, lane) candidates (33 a column, so that
// neither the stores nor a lane's reads of a column meet a bank twice);
// reused at the end for the warps' row candidates.
template <typename T, int P, int WARPS>
constexpr size_t nn_smem_bytes() {
  constexpr size_t sweep =
      size_t(WARPS) * 32 * (sizeof(Vec4<T>) + 33 * (sizeof(T) + sizeof(int)));
  constexpr size_t rows = size_t(WARPS) * 32 * P * (sizeof(T) + sizeof(int));
  return sweep > rows ? sweep : rows;
}

// One 32-column chunk staged in `stage` (columns j0 .. j0 + 31) against a
// lane's P rows: each row's running least (rb, ra), strict < in increasing
// column order; each column's least over the lane's rows in increasing row
// order, written to (cv, ci)[33 jj + lane] with the row's place in the
// block (32 k + lane). MASKED: a dead column's row candidates get +inf
// (its staged w), a dead row's column candidates (bit k of dead) +inf.
template <typename T, int P, bool MASKED>
__device__ __forceinline__ void nn_chunk(const Vec4<T>* stage, const T (&x)[P],
                                         const T (&y)[P], const T (&z)[P],
                                         unsigned dead, int j0, int lane,
                                         T (&rb)[P], int (&ra)[P], T* cv,
                                         int* ci) {
#pragma unroll (NN_UNROLL)
  for (int jj = 0; jj < 32; ++jj) {
    const Vec4<T> s = stage[jj];
    const int jg = j0 + jj;
    T cb = inf_<T>();
    int ck = 0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const T r2 = r2_of(s.x, s.y, s.z, x[k], y[k], z[k]);
      const T rc = MASKED ? add_rn(r2, s.w) : r2;
      const bool take = rc < rb[k];
      rb[k] = take ? rc : rb[k];
      ra[k] = take ? jg : ra[k];
      const T cc = (MASKED && ((dead >> k) & 1u)) ? inf_<T>() : r2;
      if (k == 0) {
        cb = cc;
      } else {
        const bool tk = cc < cb;
        cb = tk ? cc : cb;
        ck = tk ? k : ck;
      }
    }
    cv[33 * jj + lane] = cb;
    ci[33 * jj + lane] = 32 * ck + lane;
  }
}

// One band of the half ring: block I takes the tile pairs (I, J), J = (I +
// d) mod nblk, for d_lo <= d <= d_hi (for an even nblk, d = nblk / 2 only
// for I < nblk / 2), the wrapped ones (J < I) first, so that J rises. Lane
// l of warp w holds rows I R + 32 k + l, k < P (R = 32 P), and sweeps
// columns J R + 32 (w CHUNKS + c) + jj. After a chunk, lane l takes column
// l's least over the warp's lanes and joins it into slot (d - d_lo) of the
// column; at the band's end the block joins each row's least over its warps
// into (best, idx), where the diagonal kernel and earlier bands left it.
template <typename T, int P, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
nn_band_kernel(const T* __restrict__ pos, const uint8_t* __restrict__ alive,
               T* __restrict__ best, int64_t* __restrict__ idx,
               T* __restrict__ slot_v, int* __restrict__ slot_i, int n,
               int nblk, int d_lo, int d_hi) {
  static_assert(P % WARPS == 0, "a warp sweeps whole 32-column chunks");
  constexpr int R = 32 * P;
  constexpr int CHUNKS = P / WARPS;
  extern __shared__ __align__(16) unsigned char nn_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Vec4<T>* stage = reinterpret_cast<Vec4<T>*>(nn_smem) + warp * 32;
  T* cv = reinterpret_cast<T*>(nn_smem + WARPS * 32 * sizeof(Vec4<T>)) +
          warp * 32 * 33;
  int* ci = reinterpret_cast<int*>(nn_smem + WARPS * 32 * sizeof(Vec4<T>) +
                                   WARPS * 32 * 33 * sizeof(T)) +
            warp * 32 * 33;
  const int blk = blockIdx.x;
  const int row0 = blk * R;
  T x[P], y[P], z[P], rb[P];
  int ra[P];
  unsigned dead = 0;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const Vec4<T> b = stage_body(pos, alive, row0 + 32 * k + lane, n);
    x[k] = b.x;
    y[k] = b.y;
    z[k] = b.z;
    dead |= (b.w != T(0) ? 1u : 0u) << k;
    rb[k] = inf_<T>();
    ra[k] = 0;
  }
  const bool rows_dead = __any_sync(0xFFFFFFFFu, dead != 0);
  const int width = d_hi - d_lo + 1;
  int unwrapped = nblk - blk - d_lo;  // offsets with I + d < nblk
  unwrapped = unwrapped < 0 ? 0 : (unwrapped > width ? width : unwrapped);
  const int wrapped = width - unwrapped;
  for (int t = 0; t < width; ++t) {
    const int d = t < wrapped ? d_lo + unwrapped + t : d_lo + t - wrapped;
    if (2 * d == nblk && blk >= d) continue;  // (I, I + B/2) is (J, J + B/2)
    const int J = blk + d < nblk ? blk + d : blk + d - nblk;
    T* sv = slot_v + static_cast<int64_t>(d - d_lo) * n;
    int* si = slot_i + static_cast<int64_t>(d - d_lo) * n;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int j0 = J * R + 32 * (warp * CHUNKS + c);
      const int j = j0 + lane;
      const Vec4<T> s = stage_body(pos, alive, j, n);
      stage[lane] = s;
      __syncwarp();
      if (rows_dead || __any_sync(0xFFFFFFFFu, s.w != T(0)))
        nn_chunk<T, P, true>(stage, x, y, z, dead, j0, lane, rb, ra, cv, ci);
      else
        nn_chunk<T, P, false>(stage, x, y, z, dead, j0, lane, rb, ra, cv, ci);
      __syncwarp();
      T v = cv[33 * lane];
      int r = ci[33 * lane];
#pragma unroll
      for (int g = 1; g < 32; ++g) {
        const T gv = cv[33 * lane + g];
        const int gr = ci[33 * lane + g];
        const bool take = lex_less(gv, gr, v, r);
        v = take ? gv : v;
        r = take ? gr : r;
      }
      if (j < n && lex_less(v, row0 + r, sv[j], si[j])) {
        sv[j] = v;
        si[j] = row0 + r;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  T* wv = reinterpret_cast<T*>(nn_smem);
  int* wi = reinterpret_cast<int*>(nn_smem + WARPS * R * sizeof(T));
#pragma unroll
  for (int k = 0; k < P; ++k) {
    wv[warp * R + 32 * k + lane] = rb[k];
    wi[warp * R + 32 * k + lane] = ra[k];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) {
    const int r = threadIdx.x + q * 32 * WARPS;
    const int64_t i = static_cast<int64_t>(row0) + r;
    if (i >= n) continue;
    T v = best[i];
    int64_t a = idx[i];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const T gv = wv[w * R + r];
      const int gi = wi[w * R + r];
      if (lex_less(gv, gi, v, a)) {
        v = gv;
        a = gi;
      }
    }
    best[i] = v;
    idx[i] = a;
  }
}

// The diagonal tile of block I: (best, idx) of each of its rows over the
// block's other bodies, every ordered pair in increasing column order, the
// self pair dropped by index, dead columns at +inf (R^2 pairs a block,
// under 1/B of the work). Also sets the rows' `slots` column slots to
// (+inf, 0).
template <typename T, int R>
__global__ void __launch_bounds__(NN_THREADS)
nn_diag_kernel(const T* __restrict__ pos, const uint8_t* __restrict__ alive,
               T* __restrict__ best, int64_t* __restrict__ idx,
               T* __restrict__ slot_v, int* __restrict__ slot_i, int n,
               int slots) {
  __shared__ Vec4<T> tile[R];
  const int i0 = blockIdx.x * R;
  const int cols = n - i0 < R ? n - i0 : R;
  for (int c = threadIdx.x; c < cols; c += NN_THREADS)
    tile[c] = stage_body(pos, alive, i0 + c, n);
  __syncthreads();
  for (int r = threadIdx.x; r < cols; r += NN_THREADS) {
    const Vec4<T> b = tile[r];
    T bv = inf_<T>();
    int ba = 0;
    for (int c = 0; c < cols; ++c) {
      const Vec4<T> s = tile[c];
      const T rc = c == r ? inf_<T>()
                          : add_rn(r2_of(s.x, s.y, s.z, b.x, b.y, b.z), s.w);
      if (rc < bv) {
        bv = rc;
        ba = i0 + c;
      }
    }
    best[i0 + r] = bv;
    idx[i0 + r] = ba;
    for (int s = 0; s < slots; ++s) {
      slot_v[static_cast<int64_t>(s) * n + i0 + r] = inf_<T>();
      slot_i[static_cast<int64_t>(s) * n + i0 + r] = 0;
    }
  }
}

// (best, idx)[j] := the least of itself and slots 0 .. nslots - 1 of j.
template <typename T>
__global__ void __launch_bounds__(NN_THREADS)
nn_join_kernel(T* __restrict__ best, int64_t* __restrict__ idx,
               const T* __restrict__ slot_v, const int* __restrict__ slot_i,
               int n, int nslots) {
  const int j = blockIdx.x * NN_THREADS + threadIdx.x;
  if (j >= n) return;
  T v = best[j];
  int64_t a = idx[j];
  for (int s = 0; s < nslots; ++s) {
    const T gv = slot_v[static_cast<int64_t>(s) * n + j];
    const int gi = slot_i[static_cast<int64_t>(s) * n + j];
    if (lex_less(gv, gi, v, a)) {
      v = gv;
      a = gi;
    }
  }
  best[j] = v;
  idx[j] = a;
}

// nearest_rows, one block: NR_ROWS rows of the list (rows g NR_ROWS ..)
// against the live sources of slice blockIdx.y (NR_SLICE bodies), thread t
// taking the sources t, t + NR_THREADS, ... in increasing order (strict <),
// the self pair dropped by index; the block's least of each row, joined
// over lanes and warps by the lexicographic compare, goes to (part_v,
// part_i)[slice][row].
template <typename T>
__global__ void __launch_bounds__(NR_THREADS)
nn_rows_kernel(const T* __restrict__ pos, const uint8_t* __restrict__ alive,
               const int64_t* __restrict__ rows, int nrows, int n,
               T* __restrict__ part_v, int* __restrict__ part_i) {
  __shared__ T wv[NR_THREADS / 32][NR_ROWS];
  __shared__ int wi[NR_THREADS / 32][NR_ROWS];
  const int g0 = blockIdx.x * NR_ROWS;
  T x[NR_ROWS], y[NR_ROWS], z[NR_ROWS], bv[NR_ROWS];
  int own[NR_ROWS], ba[NR_ROWS];
#pragma unroll
  for (int k = 0; k < NR_ROWS; ++k) {
    const int64_t i = g0 + k < nrows ? rows[g0 + k] : -1;
    own[k] = static_cast<int>(i);
    x[k] = i >= 0 ? pos[3 * i] : T(0);
    y[k] = i >= 0 ? pos[3 * i + 1] : T(0);
    z[k] = i >= 0 ? pos[3 * i + 2] : T(0);
    bv[k] = inf_<T>();
    ba[k] = 0;
  }
  const int j0 = blockIdx.y * NR_SLICE;
  const int j1 = n - j0 < NR_SLICE ? n : j0 + NR_SLICE;
  for (int j = j0 + threadIdx.x; j < j1; j += NR_THREADS) {
    if (alive != nullptr && alive[j] == 0) continue;
    const int64_t r = 3 * static_cast<int64_t>(j);
    const T sx = pos[r], sy = pos[r + 1], sz = pos[r + 2];
#pragma unroll
    for (int k = 0; k < NR_ROWS; ++k) {
      const T r2 = j == own[k] ? inf_<T>() : r2_of(sx, sy, sz, x[k], y[k], z[k]);
      const bool take = r2 < bv[k];
      bv[k] = take ? r2 : bv[k];
      ba[k] = take ? j : ba[k];
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NR_ROWS; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T ov = __shfl_down_sync(0xFFFFFFFFu, bv[k], off);
      const int oa = __shfl_down_sync(0xFFFFFFFFu, ba[k], off);
      if (lex_less(ov, oa, bv[k], ba[k])) {
        bv[k] = ov;
        ba[k] = oa;
      }
    }
    if (lane == 0) {
      wv[warp][k] = bv[k];
      wi[warp][k] = ba[k];
    }
  }
  __syncthreads();
  const int k = threadIdx.x;
  if (k < NR_ROWS && g0 + k < nrows) {
    T v = wv[0][k];
    int a = wi[0][k];
#pragma unroll
    for (int w = 1; w < NR_THREADS / 32; ++w) {
      if (lex_less(wv[w][k], wi[w][k], v, a)) {
        v = wv[w][k];
        a = wi[w][k];
      }
    }
    const int64_t at = static_cast<int64_t>(blockIdx.y) * nrows + g0 + k;
    part_v[at] = v;
    part_i[at] = a;
  }
}

// (best, idx)[rows[t]] := the least over the slices of row t.
template <typename T>
__global__ void __launch_bounds__(NN_THREADS)
nn_rows_join_kernel(const int64_t* __restrict__ rows, int nrows,
                    const T* __restrict__ part_v,
                    const int* __restrict__ part_i, int slices,
                    T* __restrict__ best, int64_t* __restrict__ idx) {
  const int t = blockIdx.x * NN_THREADS + threadIdx.x;
  if (t >= nrows) return;
  T v = inf_<T>();
  int a = 0;
  for (int s = 0; s < slices; ++s) {
    const T gv = part_v[static_cast<int64_t>(s) * nrows + t];
    const int gi = part_i[static_cast<int64_t>(s) * nrows + t];
    if (lex_less(gv, gi, v, a)) {
      v = gv;
      a = gi;
    }
  }
  best[rows[t]] = v;
  idx[rows[t]] = a;
}

// nearest_update: body *ip moved and body *jp died. Row k lists itself in
// rows (at an atomic place; the list is a set) where k is one of them or
// its neighbour was; any other row takes (r^2 of k and i, i) where that is
// less than its own and i is live.
template <typename T>
__global__ void __launch_bounds__(NN_THREADS)
nn_update_kernel(const T* __restrict__ pos, const uint8_t* __restrict__ alive,
                 T* __restrict__ best, int64_t* __restrict__ idx, int n,
                 const int64_t* __restrict__ ip,
                 const int64_t* __restrict__ jp, int64_t* __restrict__ rows,
                 int* __restrict__ count) {
  const int k = blockIdx.x * NN_THREADS + threadIdx.x;
  if (k >= n) return;
  const int64_t i = *ip, j = *jp;
  const int64_t a = idx[k];
  if (k == i || k == j || a == i || a == j) {
    rows[atomicAdd(count, 1)] = k;
    return;
  }
  if (alive != nullptr && alive[i] == 0) return;
  const int64_t r = 3 * static_cast<int64_t>(k);
  const T r2 = r2_of(pos[3 * i], pos[3 * i + 1], pos[3 * i + 2], pos[r],
                     pos[r + 1], pos[r + 2]);
  if (lex_less(r2, i, best[k], a)) {
    best[k] = r2;
    idx[k] = i;
  }
}

// The half ring of nn_band_kernel<T, P, WARPS>, after the diagonal tiles
// and before the join (the note at the top of this file): bands holds
// nbands (d_lo, d_hi) pairs that cover the offsets 1 .. B/2 in order, each
// at most `slots` wide; work_v, work_i: (slots, n) scratch, set by the
// diagonal kernel.
template <typename T, int P, int WARPS>
cudaError_t launch_nearest(const void* pos_v, const void* alive_v,
                           void* best_v, void* idx_v, int n, void* work_v,
                           void* work_i, int slots, const long long* bands,
                           int nbands, int* launched, cudaStream_t stream) {
  constexpr int R = 32 * P;
  const int nblk = (n + R - 1) / R;
  long long next = 1;
  for (int b = 0; b < nbands; ++b) {
    const long long lo = bands[2 * b], hi = bands[2 * b + 1];
    if (lo != next || hi < lo || hi - lo >= slots) return cudaErrorInvalidValue;
    next = hi + 1;
  }
  if (next != nblk / 2 + 1 ||
      (nbands > 0 && (work_v == nullptr || work_i == nullptr)))
    return cudaErrorInvalidValue;
  const auto* pos = static_cast<const T*>(pos_v);
  const auto* alive = static_cast<const uint8_t*>(alive_v);
  T* best = static_cast<T*>(best_v);
  auto* idx = static_cast<int64_t*>(idx_v);
  T* sv = static_cast<T*>(work_v);
  int* si = static_cast<int*>(work_i);
  nn_diag_kernel<T, R><<<nblk, NN_THREADS, 0, stream>>>(
      pos, alive, best, idx, sv, si, n, nbands > 0 ? slots : 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  if (nbands == 0) return err;
  constexpr size_t smem = nn_smem_bytes<T, P, WARPS>();
  err = cudaFuncSetAttribute(nn_band_kernel<T, P, WARPS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  for (int b = 0; b < nbands; ++b) {
    nn_band_kernel<T, P, WARPS><<<nblk, 32 * WARPS, smem, stream>>>(
        pos, alive, best, idx, sv, si, n, nblk, static_cast<int>(bands[2 * b]),
        static_cast<int>(bands[2 * b + 1]));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  nn_join_kernel<T><<<(n + NN_THREADS - 1) / NN_THREADS, NN_THREADS, 0,
                      stream>>>(best, idx, sv, si, n, slots);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

template <typename T>
cudaError_t launch_rows(const void* pos, const void* alive, const void* rows_v,
                        int nrows, int n, void* best, void* idx, void* work_v,
                        void* work_i, int* launched, cudaStream_t stream) {
  const auto* rows = static_cast<const int64_t*>(rows_v);
  const int slices = (n + NR_SLICE - 1) / NR_SLICE;
  nn_rows_kernel<T><<<dim3((nrows + NR_ROWS - 1) / NR_ROWS, slices),
                      NR_THREADS, 0, stream>>>(
      static_cast<const T*>(pos), static_cast<const uint8_t*>(alive), rows,
      nrows, n, static_cast<T*>(work_v), static_cast<int*>(work_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  nn_rows_join_kernel<T><<<(nrows + NN_THREADS - 1) / NN_THREADS, NN_THREADS,
                           0, stream>>>(
      rows, nrows, static_cast<const T*>(work_v),
      static_cast<const int*>(work_i), slices, static_cast<T*>(best),
      static_cast<int64_t*>(idx));
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

// The largest n the entries take: indices and offsets stay in int.
constexpr long long NN_MAX = (1LL << 31) - 1 - 2 * 32 * NN_P;

}  // namespace

// The rows a block of nearest_neighbor's band and diagonal kernels takes in
// dtype, by which the caller cuts its band schedule
// (energy.potential_bands); 0 for an unknown dtype.
extern "C" int spacetpu_nearest_neighbor_rows(int dtype) {
  return dtype == 0 ? 32 * NN_P : dtype == 1 ? 32 * NN_P64 : 0;
}

// dtype: 0 = float32, 1 = float64. pos: (n, 3) of the dtype. alive: (n)
// uint8 0/1, or null where every body is live. best: (n) of the dtype; idx:
// (n) int64. work_v, work_i: (slots, n) scratch of the dtype and of int32;
// bands: nbands (d_lo, d_hi) pairs on the host, which cover the half ring's
// offsets 1 .. B/2 in order, each at most `slots` wide, for B blocks of
// spacetpu_nearest_neighbor_rows(dtype) rows. Launches the diagonal tiles,
// one kernel a band and the join, in that order, on the stream, and sets
// *launched to the kernels it launched; returns the first CUDA error (0 on
// success).
extern "C" int spacetpu_nearest_neighbor(int dtype, const void* pos,
                                         const void* alive, void* best,
                                         void* idx, long long n, void* work_v,
                                         void* work_i, int slots,
                                         const long long* bands, int nbands,
                                         int* launched, void* stream) {
  if (launched == nullptr) return cudaErrorInvalidValue;
  *launched = 0;
  if (n <= 0 || n > NN_MAX || slots < 0 || nbands < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(n);
  if (dtype == 0)
    return launch_nearest<float, NN_P, NN_WARPS>(pos, alive, best, idx, m,
                                                 work_v, work_i, slots, bands,
                                                 nbands, launched, s);
  if (dtype == 1)
    return launch_nearest<double, NN_P64, NN_WARPS64>(
        pos, alive, best, idx, m, work_v, work_i, slots, bands, nbands,
        launched, s);
  return cudaErrorInvalidValue;
}

// The source slices of a nearest_rows call over n bodies, which the caller
// sizes the (slices, nrows) scratch by.
extern "C" long long spacetpu_nearest_rows_slices(long long n) {
  return n <= 0 ? 0 : (n + NR_SLICE - 1) / NR_SLICE;
}

// nearest_rows: (best, idx) of the rows listed in `rows` ((nrows) int64,
// each in 0 .. n - 1) against every live body, written into best and idx
// at those rows; work_v, work_i: (slices, nrows) scratch of the dtype and
// of int32 (spacetpu_nearest_rows_slices). Launches the slices' kernel and
// the join; *launched, the return as above.
extern "C" int spacetpu_nearest_rows(int dtype, const void* pos,
                                     const void* alive, const void* rows,
                                     long long nrows, void* best, void* idx,
                                     long long n, void* work_v, void* work_i,
                                     int* launched, void* stream) {
  if (launched == nullptr) return cudaErrorInvalidValue;
  *launched = 0;
  if (n <= 0 || n > NN_MAX || nrows <= 0 || nrows > n ||
      work_v == nullptr || work_i == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(n), r = static_cast<int>(nrows);
  if (dtype == 0)
    return launch_rows<float>(pos, alive, rows, r, m, best, idx, work_v,
                              work_i, launched, s);
  if (dtype == 1)
    return launch_rows<double>(pos, alive, rows, r, m, best, idx, work_v,
                               work_i, launched, s);
  return cudaErrorInvalidValue;
}

// nearest_update: i, j: 0-dim int64 on the card (the merged pair: i moved,
// j died; pos and alive as they are after the merge); best, idx: the table
// before the merge, updated in place; rows: (n) int64, where the rows to
// search again are listed; count: one int32, zeroed here, their number.
extern "C" int spacetpu_nearest_update(int dtype, const void* pos,
                                       const void* alive, void* best,
                                       void* idx, long long n, const void* i,
                                       const void* j, void* rows, void* count,
                                       void* stream) {
  if (n <= 0 || n > NN_MAX || i == nullptr || j == nullptr ||
      rows == nullptr || count == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  const int m = static_cast<int>(n);
  const unsigned blocks = (m + NN_THREADS - 1) / NN_THREADS;
  const auto* ip = static_cast<const int64_t*>(i);
  const auto* jp = static_cast<const int64_t*>(j);
  if (dtype == 0) {
    nn_update_kernel<float><<<blocks, NN_THREADS, 0, s>>>(
        static_cast<const float*>(pos), static_cast<const uint8_t*>(alive),
        static_cast<float*>(best), static_cast<int64_t*>(idx), m, ip, jp,
        static_cast<int64_t*>(rows), static_cast<int*>(count));
  } else if (dtype == 1) {
    nn_update_kernel<double><<<blocks, NN_THREADS, 0, s>>>(
        static_cast<const double*>(pos), static_cast<const uint8_t*>(alive),
        static_cast<double*>(best), static_cast<int64_t*>(idx), m, ip, jp,
        static_cast<int64_t*>(rows), static_cast<int*>(count));
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
