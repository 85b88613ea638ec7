// splat_tiles: the tile splatter's windows, over bounded segments of each
// tile's entries.
//
// Replaces spacetpu/render/fastsplat.py:_splat_kernel (launched by
// _splat_tiles_pallas). The entries are sorted by tile key; tile t owns the
// contiguous range [starts[t], starts[t + 1]). For each tile the kernels
// write the (WIN_H * 3, WIN_W) = (96, 256) float32 window
//
//   W_t[y * 3 + ch, x] = sum_{e in t} (p((y - wy_e) inv_r_e) rgb_e[ch])
//                                     * p((x - wx_e) inv_r_e),
//   p(d) = max(1 - d^2, 0)^2,
//
// with (wx, wy, inv_r, rgb) decoded from the two int32 payloads exactly as
// fastsplat._decode does. The sentinel tile (key = T) is never read; an
// empty tile's window is zero.
//
// What bounds it on an H100. The bytes (the int32 arrays read once, the
// windows written once) take about 0.06 ms a 1080p frame, and the
// arithmetic of each entry's nonzero footprint (ceil(2r) columns by
// 3 ceil(2r) rows) less. A kernel that gives one block a tile is bound
// instead by the fullest tile (9x the mean at 1M bodies, 1.6M entries of
// 9M in the first frames), and by an entry's cost on every column of its
// window. The design answers both.
//
// (a) Bounded, balanced work. The wrapper cuts each tile's range into
// segments of at most SEG = 2048 entries (twice the TPU's SEGK; at 1M
// bodies the fullest tile's 82,332 entries take 41 blocks).
// splat_segments_kernel gives one block a segment (the grid is sized from
// M and T; blocks past the live segments exit). A tile with one segment
// writes its window in place; each segment of a hotter tile writes a
// partial window, and splat_merge_kernel sums a tile's partials in segment
// order, a float4 of the window a thread. No atomics: the sum runs in a
// fixed order, so two calls give the same bits.
//
// (b) Work in proportion to the footprint. The block holds its window in
// dynamic shared memory, (96 rows, pitch 268) float32. A lane owns one
// (column, row) cell of a 4 x 8 patch and adds the three channels there;
// the window's 64 groups of 4 columns are dealt to the block's 16 warps in
// turn (group g to warp g mod 16), so entries, whose centres crowd the
// tile's middle half, spread over all the warps. A warp takes the staged
// entries 32 at a time, keeps by one ballot those whose footprint (columns
// floor(wx - r)..ceil(wx + r), rows likewise) meets one of its groups, and
// walks them in entry order, stepping the patch over the footprint's
// groups and 8-row bands: every window pixel has one owner, which adds its
// entries in entry order. Cells where either profile is 0 add nothing (an
// exact zero, so skipping them changes no bit). The row pitch makes
// 3 * pitch = 4 (mod 32) words, so a patch's 32 lanes touch 32 distinct
// banks. The window's 110 KB let an SM hold two blocks, 32 warps; the walk
// waits on its shared-memory round trips (an entry's decode, profiles and
// read-modify-write form one chain), which more warps hide.
//
// (c) Nothing is read back to the host: the segment table (tile, lo, hi,
// partial slot) and each tile's segment count are built on the device
// from the tile starts (render/cuda_splat.py: segment_table).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WIN_H = 32;
constexpr int WIN_W = 256;
constexpr int ROWS = WIN_H * 3;
constexpr int PITCH = 268;  // smem floats a window row: 3 * PITCH = 4 (mod 32)
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 256;      // entries staged a round, one a thread
constexpr int PATCH_W = 4;      // a warp's lanes: 4 columns x 8 rows
constexpr int PATCH_H = 8;
constexpr int SUB = 16;
constexpr int RAD_Q = 4;
constexpr int QY_BITS = 9;
constexpr int QR_BITS = 6;
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_PARTS = 24;  // merge blocks a tile, 4 rows each
constexpr size_t SMEM_BYTES =
    (ROWS * PITCH + CHUNK * 4 + CHUNK * 3) * sizeof(float);
static_assert(PATCH_W * PATCH_H == 32, "a lane a cell of the patch");
static_assert(ROWS * WIN_W / 4 == MERGE_PARTS * MERGE_THREADS,
              "a float4 a merge thread");
static_assert((WARPS & (WARPS - 1)) == 0, "column groups are dealt mod WARPS");

__device__ __forceinline__ float profile(float d) {
  const float t = fmaxf(1.0f - d * d, 0.0f);
  return t * t;
}

// seg_tile/lo/hi/slot: (G) the segment table, tile = T past the live
// segments, slot = -1 where the segment is its tile's only one (its window
// goes to out[tile]), else its partial window's index. out: (T, 96, 256);
// partials: (P, 96, 256).
__global__ void __launch_bounds__(THREADS, 2)
splat_segments_kernel(const int* __restrict__ pay1,
                      const int* __restrict__ pay2,
                      const long long* __restrict__ seg_tile,
                      const long long* __restrict__ seg_lo,
                      const long long* __restrict__ seg_hi,
                      const long long* __restrict__ seg_slot,
                      float* __restrict__ out, float* __restrict__ partials,
                      long long n_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* win = smem;                                    // ROWS x PITCH
  float4* geo = reinterpret_cast<float4*>(win + ROWS * PITCH);  // wx, wy, ir, span
  float* rgb = reinterpret_cast<float*>(geo + CHUNK);  // CHUNK x 3

  const long long tile = seg_tile[blockIdx.x];
  if (tile >= n_tiles) return;  // past the live segments
  const long long lo = seg_lo[blockIdx.x];
  const long long hi = seg_hi[blockIdx.x];
  const long long slot = seg_slot[blockIdx.x];

  float4* win4 = reinterpret_cast<float4*>(win);
  for (int i = threadIdx.x; i < ROWS * PITCH / 4; i += THREADS)
    win4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int dcol = lane % PATCH_W;
  const int drow = lane / PATCH_W;
  const float inv_sub = 1.0f / SUB;
  const float inv_cq = static_cast<float>(1.0 / 1023.0);

  for (long long c0 = lo; c0 < hi; c0 += CHUNK) {
    const int n = static_cast<int>(hi - c0 < CHUNK ? hi - c0 : CHUNK);
    __syncthreads();  // the window is zeroed, or the previous chunk consumed
    if (threadIdx.x < n) {  // n <= CHUNK
      const unsigned p1 = static_cast<unsigned>(pay1[c0 + threadIdx.x]);
      const unsigned p2 = static_cast<unsigned>(pay2[c0 + threadIdx.x]);
      const float wx =
          static_cast<float>(static_cast<int>(p1 >> (QY_BITS + QR_BITS))) * inv_sub;
      const float wy = static_cast<float>(static_cast<int>(
                           (p1 >> QR_BITS) & ((1u << QY_BITS) - 1))) * inv_sub;
      const float qr = fmaxf(
          static_cast<float>(static_cast<int>(p1 & ((1u << QR_BITS) - 1))), 1.0f);
      const float ir = static_cast<float>(RAD_Q) / qr;
      const float r = qr * (1.0f / RAD_Q);  // exact: qr / 4
      // the footprint: every pixel whose profiles can be nonzero (wx, wy
      // on a 1/16 grid and r on a 1/4 grid, so |x - wx| < r only inside)
      const int cmin = max(static_cast<int>(floorf(wx - r)), 0);
      const int cmax = min(static_cast<int>(ceilf(wx + r)), WIN_W - 1);
      const int rmin = max(static_cast<int>(floorf(wy - r)), 0);
      const int rmax = min(static_cast<int>(ceilf(wy + r)), WIN_H - 1);
      const unsigned span = static_cast<unsigned>(cmin) |
                            (static_cast<unsigned>(cmax) << 8) |
                            (static_cast<unsigned>(rmin) << 16) |
                            (static_cast<unsigned>(rmax) << 24);
      geo[threadIdx.x] = make_float4(wx, wy, ir, __uint_as_float(span));
      rgb[3 * threadIdx.x + 0] =
          static_cast<float>(static_cast<int>((p2 >> 20) & 0x3FF)) * inv_cq;
      rgb[3 * threadIdx.x + 1] =
          static_cast<float>(static_cast<int>((p2 >> 10) & 0x3FF)) * inv_cq;
      rgb[3 * threadIdx.x + 2] =
          static_cast<float>(static_cast<int>(p2 & 0x3FF)) * inv_cq;
    }
    __syncthreads();
    for (int g0 = 0; g0 < n; g0 += 32) {
      bool mine = false;
      if (g0 + lane < n) {
        const unsigned span = __float_as_uint(geo[g0 + lane].w);
        const int gmin = (span & 0xFF) / PATCH_W;
        const int gmax = ((span >> 8) & 0xFF) / PATCH_W;
        mine = gmax - gmin >= WARPS - 1 || ((warp - gmin) & (WARPS - 1)) <= gmax - gmin;
      }
      unsigned todo = __ballot_sync(0xFFFFFFFFu, mine);
      while (todo) {  // this warp's entries, in entry order
        const int e = g0 + __ffs(todo) - 1;
        todo &= todo - 1;
        const float4 gg = geo[e];
        const unsigned span = __float_as_uint(gg.w);
        const int gmin = (span & 0xFF) / PATCH_W;
        const int gmax = ((span >> 8) & 0xFF) / PATCH_W;
        const int bmin = ((span >> 16) & 0xFF) / PATCH_H;
        const int bmax = (span >> 24) / PATCH_H;
        const float r0 = rgb[3 * e + 0];
        const float r1 = rgb[3 * e + 1];
        const float r2 = rgb[3 * e + 2];
        for (int g = gmin + ((warp - gmin) & (WARPS - 1)); g <= gmax; g += WARPS) {
          const int col = g * PATCH_W + dcol;
          const float fx = profile((static_cast<float>(col) - gg.x) * gg.z);
          for (int band = bmin; band <= bmax; ++band) {
            const int row = band * PATCH_H + drow;
            const float fy = profile((static_cast<float>(row) - gg.y) * gg.z);
            if (fx != 0.0f && fy != 0.0f) {
              float* px = win + (3 * row) * PITCH + col;
              px[0] = fmaf(fy * r0, fx, px[0]);
              px[PITCH] = fmaf(fy * r1, fx, px[PITCH]);
              px[2 * PITCH] = fmaf(fy * r2, fx, px[2 * PITCH]);
            }
          }
        }
      }
    }
  }
  __syncthreads();
  float* dst = slot < 0 ? out + tile * (ROWS * WIN_W)
                        : partials + slot * (ROWS * WIN_W);
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < ROWS * WIN_W / 4; i += THREADS) {
    const int r = i / (WIN_W / 4);
    const int c4 = i % (WIN_W / 4);
    dst4[i] = win4[r * (PITCH / 4) + c4];
  }
}

// Block (tile, part): rows [part * 4, part * 4 + 4) of the tile's window,
// one float4 a thread. A tile with no segment gets zeros; one with a single
// segment was written in place; one with more sums its partials in segment
// order (the loads of a hot tile's many partials are independent, so they
// stay in flight together).
__global__ void __launch_bounds__(MERGE_THREADS)
splat_merge_kernel(const long long* __restrict__ tile_nseg,
                   const long long* __restrict__ tile_pfirst,
                   const float* __restrict__ partials,
                   float* __restrict__ out) {
  const long long tile = blockIdx.x;
  const long long nseg = tile_nseg[tile];
  if (nseg == 1) return;
  constexpr long long STRIDE4 = ROWS * WIN_W / 4;
  const long long at =
      static_cast<long long>(blockIdx.y) * MERGE_THREADS + threadIdx.x;
  const float4* p = reinterpret_cast<const float4*>(partials) +
                    tile_pfirst[tile] * STRIDE4 + at;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (nseg > 0) s = p[0];
#pragma unroll 8
  for (long long k = 1; k < nseg; ++k) {
    const float4 v = p[k * STRIDE4];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  reinterpret_cast<float4*>(out + tile * (ROWS * WIN_W))[at] = s;
}

}  // namespace

// pay1, pay2: the sorted entries' payloads; the segment table (G rows) and
// each tile's segment count and first partial slot (T rows), all int64 on
// the device; out: (T, 96, 256) float32; partials: scratch of the partial
// windows. Returns the CUDA error of the launches (0 on success).
extern "C" int spacetpu_splat_tiles(const int* pay1, const int* pay2,
                                    const long long* seg_tile,
                                    const long long* seg_lo,
                                    const long long* seg_hi,
                                    const long long* seg_slot,
                                    const long long* tile_nseg,
                                    const long long* tile_pfirst, float* out,
                                    float* partials, long long n_segments,
                                    long long n_tiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaFuncSetAttribute(
      splat_segments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_segments > 0) {
    splat_segments_kernel<<<static_cast<unsigned>(n_segments), THREADS,
                            SMEM_BYTES, s>>>(pay1, pay2, seg_tile, seg_lo,
                                             seg_hi, seg_slot, out, partials,
                                             n_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  splat_merge_kernel<<<dim3(static_cast<unsigned>(n_tiles), MERGE_PARTS),
                       MERGE_THREADS, 0, s>>>(tile_nseg, tile_pfirst, partials,
                                              out);
  return static_cast<int>(cudaGetLastError());
}
