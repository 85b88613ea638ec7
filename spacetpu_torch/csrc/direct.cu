// All-pairs softened gravity on Hopper (sm_90a), with a plain C interface
// for ctypes (spacetpu_torch/ops/cuda_direct.py binds and wraps it), and the
// pair sum of the potential energy (spacetpu_torch/ops/energy.py).
//
// direct_vpu replaces spacetpu/ops/pallas_direct.py:_kernel, and
// direct_mxu replaces spacetpu/ops/pallas_direct.py:_kernel_mxu.
//
// Both compute, for every target i,  a_i = sum_j w(r_ij) * (g m_j) * (x_j - x_i).
// The work is M*K pairs against O(M + K) bytes of input and output, so the
// card's arithmetic, not its memory, bounds them.
//
// direct_vpu (both dtypes) and direct_mxu in float64, on the CUDA cores:
//   - the targets' sums stay in registers for the whole source sweep;
//     direct_vpu_kernel and direct_mxu_kernel take one target a thread, 256
//     threads a block;
//   - direct_vpu in float32 plummer where eps^2 is a normal float32 (the
//     entry's choice, pair.cuh: lean_ok; bench.py's eps 1e-2 and the main
//     path) runs direct_vpu_lean_kernel: LEAN_TARGETS targets a thread and
//     256 threads a block (512 blocks at N = 262,144 over 132 SMs), each
//     staged source read from shared memory once for all of them (one
//     LDS.128 serves two pairs), and the weight DirectLean, the MUFU rsqrt
//     alone without rsqrtf's guard for a subnormal argument (pair.cuh). Each
//     pair is body_term, the FMAs of direct_vpu_kernel's compiled loop, and
//     each target sums each tile apart as direct_vpu_kernel does: the same
//     bits. float64, the ref law, eps = 0 and a subnormal float32 eps^2
//     keep direct_vpu_kernel;
//   - the source axis is swept inside the block (the TPU kernel's sequential
//     j grid axis), one 256-source tile at a time staged in shared memory;
//     every thread of a warp reads the same tile entry, a broadcast, so the
//     inner loop issues no global loads;
//   - the ragged end of the source axis is a zero-filled tile load: a
//     zero-mass source at the origin adds exactly zero (its distance term is
//     masked or its weight is 0 * finite);
//   - direct_vpu sums each tile's contribution apart and then adds it to the
//     total, which keeps the rounding of long sums close to a blocked sum;
//   - float32 plummer with eps^2 < FLT_MIN takes eps^2 = 0 and the eps == 0
//     mask (pair.cuh: flushed_eps2), as spacetpu's XLA path does;
//   - direct_mxu in float64 (held to 1e-11 of its term scale, which TF32
//     cannot meet) rounds its expanded form one step at a time and
//     Kahan-compensates its four sums a pair: they are dominated by the self
//     pair (weight g m / eps^3 times x_i) that the rank-1 correction later
//     cancels.
//
// direct_mxu in float32 (direct_mxu_tc_kernel): the TPU kernel's two
// matrix-unit products at Precision.HIGHEST, on the tensor cores in TF32
// with a three-term split (a_hi b_hi + a_hi b_lo + a_lo b_hi, hi = a rounded
// to TF32, lo = a - hi), the Hopper counterpart of HIGHEST:
//   - product 1 gives d2 directly: [x_i, y_i, z_i, |x_i|^2 + eps^2] .
//     [-2x_j, -2y_j, -2z_j, 1] + |x_j|^2, the last term exact in the
//     accumulator's initial value. The four features take the three terms
//     in 12 k-slots: one m16n8k8 (A = [hi | lo], B = [hi ; hi]) and one
//     m16n8k4 (hi . lo). The staged operands' lo parts are rounded to TF32
//     too, not left to the tensor core's truncation;
//   - product 2 is W @ [g m x_j, g m y_j, g m z_j, g m_j] with W = d2^-3/2
//     and the mass in the B operand, so a pair costs two multiplies for W.
//     B's 8 columns hold the hi parts (0-3) and the lo parts (4-7), so two
//     m16n8k8 (A = W_hi, then W_lo) give all three terms; the two column
//     groups are added at the end. W goes from product 1's accumulator
//     registers straight into product 2's A operand (the accumulator holds
//     columns 2t and 2t+1 of a thread's rows, the A operand columns t and
//     t+4), so the source tile's rows of B are staged in that order
//     (k = t <- source 2t, k = t + 4 <- source 2t + 1): the sum over
//     sources ignores their order, FlashAttention's P.V trick. W never
//     leaves registers;
//   - where the caller says where its targets sit among the sources
//     (self_offset: target i is source i + self_offset; the direct
//     solver's all-pairs pass gives 0, a shard of the targets its start),
//     a self pair adds nothing: its exact term is w * 0, while the
//     expanded form carries g m / eps^3 times x_i in both sums for the
//     rank-1 correction to cancel, and the tensor core's truncating sums
//     keep a few units of 2^-24 of it (with it: a 7e-3 band against
//     direct_vpu at N = 256 on the card, where the float32 expanded form
//     itself is at 1.9e-3 of the 2e-3 limit). Only the source tile that
//     holds a warp's own rows takes that test (a second instance of the
//     tile loop): the loop of the other tiles keeps no compare, select or
//     branch for it;
//   - each 256-source tile sums into a fresh accumulator, which joins the
//     target's total once a tile through a Kahan add (3 adds a tile, not 12
//     a pair), as the TPU sums each 2048-source tile before adding it;
//   - a warp owns four 16-target row tiles (more independent mma chains
//     than two); a block of 8 warps owns 512 targets and stages each
//     256-source tile once, pre-split into TF32 hi/lo, in the mma fragment
//     order (16 + 8 bytes a lane a k-step).
// Budget a pair (an m16n8 accumulator gives a lane 4 pairs a k-step): on
// the CUDA cores max, rsqrt (the MUFU instruction alone, .ftz: its argument
// is at least eps^2), 2 multiplies and the split of w (integer add and
// mask, one subtract): 7 issue slots, plus 4 mma and 0.5 shared loads a
// lane per 4 pairs, 8.1 a pair (the compiled loop: 9.3); MUFU one rsqrt at
// 16 a clock an SM; the tensor cores 3,584 FMA per 128 pairs, 56 flops a
// pair, at mma.sync's TF32 rate, which on an H100 is half the dense 495
// TF/s (about 8.6 clocks an m16n8k8 and 4.7 an m16n8k4 on an SM
// sub-partition, tools/tf32_mma_rate.py). At N = 262,144 and 1,980 MHz:
// MUFU 16.4 ms, issue 16.6 ms (19.2 at 9.3 a pair), tensor 15.6 ms. The
// pipes do not overlap fully: each k-step's max, rsqrt and split wait on
// product 1's two mma, which give its d2. wgmma would lift the tensor
// rate; the MUFU and issue floors stay.
//
// pair_potential (no TPU kernel: the counterpart of the jitted lax.scan of
// spacetpu/ops/energy.py:potential_energy): for every body i,
// sum_{j != i} m_j / sqrt(r_ij^2 + eps^2) (plummer) or m_j / r_ij (ref),
// 0 where the softened distance is 0, the self pair dropped by index. It
// takes direct_vpu_kernel's sweep (a thread a target, 256-source tiles in
// shared memory) over every ordered pair. The function needs only the
// N (N - 1) / 2 unordered ones (1/d_ij = 1/d_ji), one rsqrt and 11 flops
// each: the MUFU floor of that, not of this sweep, is its bound.
//
// The per-pair term and the rounding rules of the CUDA-core kernels are in
// pair.cuh.

#include "pair.cuh"

namespace {

constexpr int BLOCK = 256;

// Products and sums rounded one at a time, never fused into an FMA: the
// float64 expanded-form distance below is a difference of nearly equal
// terms, and these keep it bit-identical to the same steps done by PyTorch
// elementwise.
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
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
      pair_term<T, LAW, MASK>(tile[jj], xi, yi, zi, eps, eps2, tx, ty, tz);
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

// The targets a thread of direct_vpu_lean_kernel.
constexpr int LEAN_TARGETS = 2;

// direct_vpu where the entry takes the MUFU rsqrt alone (lean_ok): W is
// DirectLean. tgt: (M, 3) targets. src: (K) packed (x, y, z, g*m). out:
// (M, 3). Thread t of a block of blockDim.x threads (BLOCK, the entry's
// launch) owns targets b + t + q blockDim.x, q < NT, b = blockIdx.x NT
// blockDim.x, those below M live. Each 256-source tile is staged once a
// block and each staged source read once for the thread's NT targets; each
// target sums the tile apart, from the tile's first source to its last,
// then adds that sum to its total. The block size is read at run time:
// with BLOCK in its place nvcc gives the pair loop 9 more instructions a
// trip (15.25 SASS a pair, not 14.6875) and the kernel 39.95 ms, not 37.7,
// at the main path on an H100 (PERF.md §6, row 1).
template <class W, int NT>
__global__ void __launch_bounds__(BLOCK)
direct_vpu_lean_kernel(const float* __restrict__ tgt,
                       const Vec4<float>* __restrict__ src,
                       float* __restrict__ out, int64_t m, int64_t k,
                       const W weight) {
  __shared__ Vec4<float> tile[BLOCK];
  const int threads = static_cast<int>(blockDim.x);
  const int t = threadIdx.x;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * NT * threads + t;
  float p[NT][3], acc[NT][3];
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int64_t i = b + static_cast<int64_t>(q) * threads;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p[q][c] = i < m ? tgt[3 * i + c] : 0.0f;
      acc[q][c] = 0.0f;
    }
  }
  for (int64_t j0 = 0; j0 < k; j0 += BLOCK) {
    for (int e = t; e < BLOCK; e += threads) {
      const int64_t j = j0 + e;
      tile[e] = j < k ? src[j] : Vec4<float>{0.0f, 0.0f, 0.0f, 0.0f};
    }
    __syncthreads();
    float s[NT][3];
#pragma unroll
    for (int q = 0; q < NT; ++q) s[q][0] = s[q][1] = s[q][2] = 0.0f;
#pragma unroll (16 / NT)
    for (int jj = 0; jj < BLOCK; ++jj) {
      const Vec4<float> v = tile[jj];
#pragma unroll
      for (int q = 0; q < NT; ++q)
        body_term(v, p[q][0], p[q][1], p[q][2], weight, s[q][0], s[q][1],
                  s[q][2]);
    }
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      acc[q][0] += s[q][0];
      acc[q][1] += s[q][1];
      acc[q][2] += s[q][2];
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int64_t i = b + static_cast<int64_t>(q) * threads;
    if (i < m) {
      out[3 * i] = acc[q][0];
      out[3 * i + 1] = acc[q][1];
      out[3 * i + 2] = acc[q][2];
    }
  }
}

// Expanded form in float64 (plummer, eps > 0):
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

// ---- direct_mxu in float32: both products on the tensor cores --------------

constexpr int TC_WARPS = 8;
constexpr int TC_MT = 4;                        // 16-target row tiles a warp
constexpr int TC_ROWS = TC_WARPS * TC_MT * 16;  // 512 targets a block
constexpr int TC_TILE = 256;                    // sources staged a round
constexpr int TC_KSTEPS = TC_TILE / 8;          // mma k-steps a tile
constexpr int TC_THREADS = TC_WARPS * 32;
static_assert(TC_THREADS == TC_TILE, "one staging thread a source");

// a rounded to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32):
// half of the 13 dropped mantissa bits added, then those bits cleared.
__device__ __forceinline__ float tf32_hi(float a) {
  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xffffe000u);
}

// The (hi, lo) split of a staged operand, both exact TF32 values.
__device__ __forceinline__ float2 split_staged(float a) {
  const float hi = tf32_hi(a);
  return make_float2(hi, tf32_hi(a - hi));
}

// d += a b, m16n8k8 and m16n8k4, TF32 operands (float32 bit patterns),
// float32 sums. Fragments (g = lane / 4, t = lane % 4): a = A[g][t],
// A[g+8][t] (k8 also A[g][t+4], A[g+8][t+4]); b = B[t][g] (k8 also
// B[t+4][g]); d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_k4(float (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// One staged source tile against a warp's TC_MT row tiles, into acc.
// SELF: this tile holds the sources that coincide with some of this warp's
// rows (target i is source i + self_offset): the self pairs get w = 0.
// Only that tile takes the test (an index compare and select a pair).
template <bool SELF>
__device__ __forceinline__ void mxu_tile(
    const float4 (&b1s)[TC_KSTEPS][32], const float2 (&b2s)[TC_KSTEPS][32],
    const uint32_t (&a_hi)[TC_MT][2], const uint32_t (&a_lo)[TC_MT][2],
    float (&acc)[TC_MT][4], float eps2, int lane, int64_t self_at) {
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll 4
  for (int s = 0; s < TC_KSTEPS; ++s) {
    const float4 f1 = b1s[s][lane];
    const float2 f2 = b2s[s][lane];
    const uint32_t b_hi = __float_as_uint(f1.x);
    const uint32_t b_lo = __float_as_uint(f1.y);
    const uint32_t b0 = __float_as_uint(f2.x);
    const uint32_t b1 = __float_as_uint(f2.y);
#pragma unroll
    for (int mt = 0; mt < TC_MT; ++mt) {
      float d[4] = {f1.z, f1.w, f1.z, f1.w};
      mma_k8(d, a_hi[mt][0], a_hi[mt][1], a_lo[mt][0], a_lo[mt][1], b_hi, b_hi);
      mma_k4(d, a_hi[mt][0], a_hi[mt][1], b_lo);
      if (SELF) {
        // self_at: the source of this warp's first row less the tile's
        // first source
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int64_t row = self_at + mt * 16 + g + 8 * (q / 2);
          if (row == 8 * s + 2 * t + q % 2) d[q] = __int_as_float(0x7f800000);
        }
      }
      // W in product 2's A order: W[g][2t], W[g+8][2t], W[g][2t+1],
      // W[g+8][2t+1] are d[0], d[2], d[1], d[3]; an infinite d2 gives 0.
      uint32_t w_hi[4], w_lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float inv = rsqrt_ftz(fmaxf(d[(q % 2) * 2 + q / 2], eps2));
        const float w = inv * inv * inv;
        const float hi = tf32_hi(w);
        w_hi[q] = __float_as_uint(hi);
        w_lo[q] = __float_as_uint(w - hi);  // truncated to TF32 by the mma
      }
      mma_k8(acc[mt], w_lo[0], w_lo[1], w_lo[2], w_lo[3], b0, b1);
      mma_k8(acc[mt], w_hi[0], w_hi[1], w_hi[2], w_hi[3], b0, b1);
    }
  }
}

// tgt: (M) packed (x, y, z, |x|^2). src: (K) packed (x, y, z, g*m).
// sq: (K) |x_j|^2. out: (M) packed [sum_j w g m x_j, sum_j w g m] with
// w = max(d2, eps^2)^-3/2. The caller subtracts out.w * x_i. self_off:
// target i is source i + self_off (0 <= self_off <= k - m), or < 0 where no
// target is named among the sources.
//
// Product 1, d2 = [x, y, z, S]_i . [-2x, -2y, -2z, 1]_j + Q_j with
// S = |x_i|^2 + eps^2 and Q = |x_j|^2: the three terms hi.hi + lo.hi in one
// m16n8k8 (A = [hi | lo] features, B = [hi ; hi]) and hi.lo in one
// m16n8k4, Q exact in the accumulator's initial value. Product 2, W @
// [hi | lo] of [g m x, g m y, g m z, g m]: columns 0-3 take W_hi.B_hi +
// W_lo.B_hi (two m16n8k8 on the same B), columns 4-7 W_hi.B_lo, added at
// the end. Its rows of B follow the accumulator's columns: k = t <- source
// 2t, k = t + 4 <- source 2t + 1.
__global__ void __launch_bounds__(TC_THREADS, 2)
direct_mxu_tc_kernel(const float4* __restrict__ tgt,
                     const float4* __restrict__ src,
                     const float* __restrict__ sq, float* __restrict__ out,
                     int64_t m, int64_t k, float eps2, int64_t self_off) {
  // Product 1's B fragment and the accumulator's initial Q of each k-step,
  // lane by lane: {B_hi[t][g], B_lo[t][g], Q[2t], Q[2t+1]} of sources
  // 8s + g and 8s + 2t, 8s + 2t + 1.
  __shared__ float4 b1s[TC_KSTEPS][32];
  // Product 2's: {B[t][g], B[t+4][g]}, column g < 4 the hi part of
  // component g, g >= 4 the lo part of component g - 4.
  __shared__ float2 b2s[TC_KSTEPS][32];

  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int64_t row_base = static_cast<int64_t>(blockIdx.x) * TC_ROWS +
                           (threadIdx.x / 32) * TC_MT * 16;

  // Product 1's A fragments: feature t of rows g and g + 8, hi and lo.
  uint32_t a_hi[TC_MT][2], a_lo[TC_MT][2];
#pragma unroll
  for (int mt = 0; mt < TC_MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = row_base + mt * 16 + g + 8 * half;
      float f = 0.0f;
      if (row < m) {
        const float4 v = tgt[row];
        f = t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w + eps2;
      }
      const float2 p = split_staged(f);
      a_hi[mt][half] = __float_as_uint(p.x);
      a_lo[mt][half] = __float_as_uint(p.y);
    }
  }

  float tot[TC_MT][4], comp[TC_MT][4];
#pragma unroll
  for (int mt = 0; mt < TC_MT; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q) tot[mt][q] = comp[mt][q] = 0.0f;

  for (int64_t j0 = 0; j0 < k; j0 += TC_TILE) {
    __syncthreads();  // the previous tile is consumed
    {
      // Stage source j0 + threadIdx.x; a zero-filled source past the end
      // has d2 = |x_i|^2 + eps^2 > 0 and adds w * 0 = 0.
      const int q = threadIdx.x;
      const int s = q / 8;
      const int n = q % 8;
      const int64_t j = j0 + q;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float sqj = 0.0f, one = 0.0f;
      if (j < k) {
        v = src[j];
        sqj = sq[j];
        one = 1.0f;
      }
      const float f[4] = {-2.0f * v.x, -2.0f * v.y, -2.0f * v.z, one};
      float* b1f = reinterpret_cast<float*>(&b1s[s][0]);
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const float2 p = split_staged(f[tt]);
        b1f[(n * 4 + tt) * 4 + 0] = p.x;
        b1f[(n * 4 + tt) * 4 + 1] = p.y;
      }
#pragma unroll
      for (int gg = 0; gg < 8; ++gg) b1f[(gg * 4 + n / 2) * 4 + 2 + n % 2] = sqj;
      const float c[4] = {v.w * v.x, v.w * v.y, v.w * v.z, v.w};
      float* b2f = reinterpret_cast<float*>(&b2s[s][0]);
#pragma unroll
      for (int col = 0; col < 4; ++col) {
        const float2 p = split_staged(c[col]);
        b2f[(col * 4 + n / 2) * 2 + n % 2] = p.x;
        b2f[((col + 4) * 4 + n / 2) * 2 + n % 2] = p.y;
      }
    }
    __syncthreads();

    float acc[TC_MT][4];
#pragma unroll
    for (int mt = 0; mt < TC_MT; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][q] = 0.0f;
    // a coincident pair adds w * 0 exactly; the expanded form would carry
    // g m / eps^3 times x_i in both sums for the rank-1 correction to cancel
    const int64_t self_base = row_base + self_off;
    if (self_off >= 0 && j0 < self_base + TC_MT * 16 &&
        self_base < j0 + TC_TILE)
      mxu_tile<true>(b1s, b2s, a_hi, a_lo, acc, eps2, lane, self_base - j0);
    else
      mxu_tile<false>(b1s, b2s, a_hi, a_lo, acc, eps2, lane, 0);
#pragma unroll
    for (int mt = 0; mt < TC_MT; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) kahan_add(tot[mt][q], comp[mt][q], acc[mt][q]);
  }

  // Lanes t = 0 and 1 hold columns (0, 1) and (2, 3) of rows g and g + 8;
  // lanes t + 2 the same columns' W_hi.B_lo sums.
#pragma unroll
  for (int mt = 0; mt < TC_MT; ++mt) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float mine = tot[mt][q] - comp[mt][q];
      v[q] = mine + __shfl_xor_sync(0xFFFFFFFFu, mine, 2);
    }
    if (t < 2) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t row = row_base + mt * 16 + g + 8 * half;
        if (row < m) {
          *reinterpret_cast<float2*>(out + 4 * row + 2 * t) =
              make_float2(v[2 * half], v[2 * half + 1]);
        }
      }
    }
  }
}

// ---- pair_potential ---------------------------------------------------------

// body: (N) packed (x, y, z, m). out: (N) sum_{j != i} m_j / d_ij with
// d_ij^2 = r_ij^2 + eps^2 (plummer) or r_ij^2 (ref), and 1 / d = 0 where
// d^2 = 0 (spacetpu/ops/energy.py:58-63: the clamp to 1e-38 included).
template <typename T, int LAW>
__global__ void __launch_bounds__(BLOCK)
pair_potential_kernel(const Vec4<T>* __restrict__ body, T* __restrict__ out,
                      int64_t n, T eps2) {
  __shared__ Vec4<T> tile[BLOCK];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  const Vec4<T> b = i < n ? body[i] : Vec4<T>{T(0), T(0), T(0), T(0)};
  T acc = T(0);
  for (int64_t j0 = 0; j0 < n; j0 += BLOCK) {
    const int64_t j = j0 + threadIdx.x;
    tile[threadIdx.x] = j < n ? body[j] : Vec4<T>{T(0), T(0), T(0), T(0)};
    __syncthreads();
    const int64_t self = i - j0;  // the self pair's slot in this tile, if any
    T part = T(0);
#pragma unroll 8
    for (int jj = 0; jj < BLOCK; ++jj) {
      const Vec4<T> s = tile[jj];
      const T dx = s.x - b.x;
      const T dy = s.y - b.y;
      const T dz = s.z - b.z;
      T d2 = dx * dx + dy * dy + dz * dz;
      if (LAW == PLUMMER) d2 += eps2;
      T inv = d2 > T(0) ? rsqrt_(max_(d2, T(1e-38))) : T(0);
      inv = jj == self ? T(0) : inv;
      part += s.w * inv;
    }
    acc += part;
    __syncthreads();
  }
  if (i < n) out[i] = acc;
}

unsigned blocks_for(int64_t m) {
  return static_cast<unsigned>((m + BLOCK - 1) / BLOCK);
}

template <typename T, int LAW, bool MASK>
cudaError_t launch_vpu(const void* tgt, const void* src, void* out, int64_t m,
                       int64_t k, T eps, T eps2, cudaStream_t stream) {
  direct_vpu_kernel<T, LAW, MASK><<<blocks_for(m), BLOCK, 0, stream>>>(
      static_cast<const T*>(tgt), static_cast<const Vec4<T>*>(src),
      static_cast<T*>(out), m, k, eps, eps2);
  return cudaGetLastError();
}

// float32 plummer with eps^2 a normal float32 (lean_ok): direct_vpu_lean_kernel
// with DirectLean; else direct_vpu_kernel, with the eps == 0 mask where eps
// is 0 or the float32 eps^2 is flushed to 0.
template <typename T>
cudaError_t launch_vpu_law(int law, const void* tgt, const void* src,
                           void* out, int64_t m, int64_t k, double eps,
                           cudaStream_t stream) {
  if constexpr (std::is_same_v<T, float>) {
    if (lean_ok(0, law, eps)) {
      constexpr int64_t per_block = static_cast<int64_t>(LEAN_TARGETS) * BLOCK;
      direct_vpu_lean_kernel<DirectLean<float>, LEAN_TARGETS>
          <<<static_cast<unsigned>((m + per_block - 1) / per_block), BLOCK, 0,
             stream>>>(static_cast<const float*>(tgt),
                       static_cast<const Vec4<float>*>(src),
                       static_cast<float*>(out), m, k,
                       DirectLean<float>{static_cast<float>(eps * eps)});
      return cudaGetLastError();
    }
  }
  const T e = static_cast<T>(eps);
  if (law == PLUMMER) {
    if (eps == 0.0 || flushed_eps2<T>(eps))
      return launch_vpu<T, PLUMMER, true>(tgt, src, out, m, k, e, T(0),
                                          stream);
    return launch_vpu<T, PLUMMER, false>(tgt, src, out, m, k, e,
                                         static_cast<T>(eps * eps), stream);
  }
  if (law == REF) {
    const T e2 = static_cast<T>(eps * eps);
    return eps == 0.0
               ? launch_vpu<T, REF, true>(tgt, src, out, m, k, e, e2, stream)
               : launch_vpu<T, REF, false>(tgt, src, out, m, k, e, e2, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_mxu_f32(const void* tgt, const void* src, const void* sq,
                           void* out, int64_t m, int64_t k, double eps,
                           int64_t self_off, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((m + TC_ROWS - 1) / TC_ROWS);
  direct_mxu_tc_kernel<<<blocks, TC_THREADS, 0, stream>>>(
      static_cast<const float4*>(tgt), static_cast<const float4*>(src),
      static_cast<const float*>(sq), static_cast<float*>(out), m, k,
      static_cast<float>(eps * eps), self_off);
  return cudaGetLastError();
}

cudaError_t launch_mxu_f64(const void* tgt, const void* src, const void* sq,
                           void* out, int64_t m, int64_t k, double eps,
                           cudaStream_t stream) {
  direct_mxu_kernel<double><<<blocks_for(m), BLOCK, 0, stream>>>(
      static_cast<const Vec4<double>*>(tgt),
      static_cast<const Vec4<double>*>(src), static_cast<const double*>(sq),
      static_cast<Vec4<double>*>(out), m, k, eps * eps);
  return cudaGetLastError();
}

template <typename T, int LAW>
cudaError_t launch_potential(const void* body, void* out, int64_t n,
                             double eps, cudaStream_t stream) {
  pair_potential_kernel<T, LAW><<<blocks_for(n), BLOCK, 0, stream>>>(
      static_cast<const Vec4<T>*>(body), static_cast<T*>(out), n,
      static_cast<T>(eps * eps));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_potential_law(int law, const void* body, void* out,
                                 int64_t n, double eps, cudaStream_t stream) {
  if (law == PLUMMER) return launch_potential<T, PLUMMER>(body, out, n, eps, stream);
  if (law == REF) return launch_potential<T, REF>(body, out, n, eps, stream);
  return cudaErrorInvalidValue;
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

// self_offset: target i is source i + self_offset, or < 0 where the caller
// names no target among the sources (float32 drops the named self pairs'
// terms by index; float64 sums every pair as the expanded form does).
extern "C" int spacetpu_direct_mxu(int dtype, const void* tgt, const void* src,
                                   const void* sq, void* out, long long m,
                                   long long k, double eps,
                                   long long self_offset, void* stream) {
  if (m <= 0 || k < 0 || !(eps > 0.0) || self_offset > k - m)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_mxu_f32(tgt, src, sq, out, m, k, eps, self_offset, s);
  if (dtype == 1) return launch_mxu_f64(tgt, src, sq, out, m, k, eps, s);
  return cudaErrorInvalidValue;
}

// body: (N, 4) packed (x, y, z, m); out: (N) per-body sums (see
// pair_potential_kernel). dtype and law as above.
extern "C" int spacetpu_pair_potential(int dtype, int law, const void* body,
                                       void* out, long long n, double eps,
                                       void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_potential_law<float>(law, body, out, n, eps, s);
  if (dtype == 1) return launch_potential_law<double>(law, body, out, n, eps, s);
  return cudaErrorInvalidValue;
}
