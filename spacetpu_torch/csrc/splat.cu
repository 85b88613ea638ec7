// splat_tiles: the tile splatter's windows, one block a tile.
//
// Replaces spacetpu/render/fastsplat.py:_splat_kernel (launched by
// _splat_tiles_pallas). The entries are sorted by tile key; tile t owns the
// contiguous range [starts[t], starts[t + 1]). For each tile the kernel
// writes the (WIN_H * 3, WIN_W) = (96, 256) float32 window
//
//   W_t[y * 3 + ch, x] = sum_{e in t} (p((y - wy_e) inv_r_e) rgb_e[ch])
//                                     * p((x - wx_e) inv_r_e),
//   p(d) = max(1 - d^2, 0)^2,
//
// with (wx, wy, inv_r, rgb) decoded from the two int32 payloads exactly as
// fastsplat._decode does. The sentinel tile (key = T) is never read; an
// empty tile's window is zero.
//
// Design. The TPU kernel walks scalar-prefetched segments of 1024 entries
// and adds a batched matrix product into a window revisited across grid
// steps; here one block owns one tile and walks its whole range, so nothing
// is shared between blocks: no atomics, no zeroing pass, and the sum runs
// in entry order, so the result is deterministic. Each of the 256 threads
// owns one window column and its 96 accumulators in registers (rows fully
// unrolled). The block stages a chunk of entries in shared memory, decoded
// once: each entry's 96 row factors p((y - wy) inv_r) * rgb[ch] (the TPU
// kernel's `a`), its wx and inv_r. A thread then computes its column's
// factor p((x - wx) inv_r) and, where that factor is not zero, adds the 96
// products; a zero factor adds exact zeros, so skipping it leaves the sum
// bit for bit the same.
//
// What bounds it on an H100: the arithmetic that each entry's nonzero
// footprint needs (about ceil(2r) columns by 3 ceil(2r) rows, 2 flops
// each) is small; the block's issue of the column test for all 256 columns
// of every entry, and the imbalance of hot tiles (one block walks a tile's
// whole range), bound it in practice. Splitting hot tiles over several
// blocks, tensor cores and a fused overlap-add are later work.

#include <cuda_runtime.h>

namespace {

constexpr int WIN_H = 32;
constexpr int WIN_W = 256;
constexpr int ROWS = WIN_H * 3;
constexpr int CHUNK = 64;  // entries staged a round
constexpr int SUB = 16;
constexpr int RAD_Q = 4;
constexpr int QY_BITS = 9;
constexpr int QR_BITS = 6;

__device__ __forceinline__ float profile(float d) {
  const float t = fmaxf(1.0f - d * d, 0.0f);
  return t * t;
}

__global__ void __launch_bounds__(WIN_W)
splat_tiles_kernel(const int* __restrict__ pay1, const int* __restrict__ pay2,
                   const long long* __restrict__ starts,
                   float* __restrict__ out) {
  __shared__ __align__(16) float a_s[CHUNK][ROWS];
  __shared__ float wx_s[CHUNK], wy_s[CHUNK], ir_s[CHUNK];
  __shared__ float rgb_s[CHUNK][3];

  const int tile = blockIdx.x;
  const int x = threadIdx.x;
  const long long lo = starts[tile];
  const long long hi = starts[tile + 1];
  const float col = static_cast<float>(x);
  const float inv_sub = 1.0f / SUB;
  const float inv_cq = static_cast<float>(1.0 / 1023.0);

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;

  for (long long c0 = lo; c0 < hi; c0 += CHUNK) {
    const int n = static_cast<int>(hi - c0 < CHUNK ? hi - c0 : CHUNK);
    __syncthreads();  // the previous chunk is consumed
    if (x < n) {
      const unsigned p1 = static_cast<unsigned>(pay1[c0 + x]);
      const unsigned p2 = static_cast<unsigned>(pay2[c0 + x]);
      wx_s[x] = static_cast<float>(static_cast<int>(p1 >> (QY_BITS + QR_BITS)))
                * inv_sub;
      wy_s[x] = static_cast<float>(
                    static_cast<int>((p1 >> QR_BITS) & ((1u << QY_BITS) - 1)))
                * inv_sub;
      ir_s[x] = static_cast<float>(RAD_Q) /
                fmaxf(static_cast<float>(
                          static_cast<int>(p1 & ((1u << QR_BITS) - 1))),
                      1.0f);
      rgb_s[x][0] = static_cast<float>(static_cast<int>((p2 >> 20) & 0x3FF))
                    * inv_cq;
      rgb_s[x][1] = static_cast<float>(static_cast<int>((p2 >> 10) & 0x3FF))
                    * inv_cq;
      rgb_s[x][2] = static_cast<float>(static_cast<int>(p2 & 0x3FF)) * inv_cq;
    }
    __syncthreads();
    for (int i = x; i < n * WIN_H; i += WIN_W) {
      const int e = i / WIN_H;
      const int y = i % WIN_H;
      const float fy = profile((static_cast<float>(y) - wy_s[e]) * ir_s[e]);
      a_s[e][3 * y + 0] = fy * rgb_s[e][0];
      a_s[e][3 * y + 1] = fy * rgb_s[e][1];
      a_s[e][3 * y + 2] = fy * rgb_s[e][2];
    }
    __syncthreads();
    for (int e = 0; e < n; ++e) {
      const float fx = profile((col - wx_s[e]) * ir_s[e]);
      if (fx != 0.0f) {
        const float4* a4 = reinterpret_cast<const float4*>(a_s[e]);
#pragma unroll
        for (int k = 0; k < ROWS / 4; ++k) {
          const float4 v = a4[k];
          acc[4 * k + 0] = fmaf(v.x, fx, acc[4 * k + 0]);
          acc[4 * k + 1] = fmaf(v.y, fx, acc[4 * k + 1]);
          acc[4 * k + 2] = fmaf(v.z, fx, acc[4 * k + 2]);
          acc[4 * k + 3] = fmaf(v.w, fx, acc[4 * k + 3]);
        }
      }
    }
  }
  float* o = out + static_cast<long long>(tile) * ROWS * WIN_W + x;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) o[static_cast<long long>(r) * WIN_W] = acc[r];
}

}  // namespace

// pay1, pay2: the sorted entries' payloads; starts: (n_tiles + 1,) int64
// first entry of each tile; out: (n_tiles, 96, 256) float32. Returns the
// CUDA error of the launch (0 on success).
extern "C" int spacetpu_splat_tiles(const int* pay1, const int* pay2,
                                    const long long* starts, float* out,
                                    long long n_tiles, void* stream) {
  if (n_tiles > 0) {
    splat_tiles_kernel<<<static_cast<unsigned>(n_tiles), WIN_W, 0,
                         static_cast<cudaStream_t>(stream)>>>(pay1, pay2,
                                                              starts, out);
  }
  return static_cast<int>(cudaGetLastError());
}
