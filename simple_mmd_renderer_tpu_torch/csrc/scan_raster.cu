// KS: the exact scan raster's body (`ops/tiled_raster.scan_raster`), and
// KSb, the bin pass that feeds it (`ops/tiled_raster.scan_bins`).
//
// They replace no Pallas kernel: the reference's scan raster
// (`simple_mmd_renderer_tpu/render/raster.py` `rasterize`, and its copy
// `_scan_subset` in `ops/tiled_raster.py` for the tiled path's oversized
// triangles) is a `lax.scan` over triangles in XLA. In the port it is the
// raster of `raster_mode="scan"` (the character, the shadow map and the
// edge hull) and the tiled path's big-triangle merges, where a loop of ~25
// eager operators a triangle over full frame planes stood before.
//
// Semantics, per pixel centre (px, py) = (x + 0.5, y + 0.5), triangles in
// draw order k = 0 .. n-1, each with screen vertices v0, v1, v2, depths z0,
// z1, z2, inv_area = 1 / area2 (0 where |area2| <= 1e-12) and a valid flag:
//
//     edge(a, b) = (b.x - a.x) * (py - a.y) - (b.y - a.y) * (px - a.x)
//     b0 = edge(v1, v2) * inv_area   b1 = edge(v2, v0) * inv_area
//     b2 = edge(v0, v1) * inv_area   zp = (b0*z0 + b1*z1) + b2*z2
//     passed = b0 >= 0 && b1 >= 0 && b2 >= 0 && valid
//              && zp <= depth && zp >= 0 && zp <= 1
//
// and a passing triangle writes depth = zp, tri = k, bary = (b1, b2)
// (LESS_EQUAL: a later triangle wins a z-tie). The buffer starts from the
// values the caller put in depth / tri / bary (cleared, or a start vis).
//
// Design. KSb clears a bitmask of static size on the stream and sets, for
// each instance and each coarse tile of `tile` x `tile` pixels (a multiple
// of the block's 16), bit k of the tile's row of ceil(n / 32) words when
// triangle k is valid and its pixel box (`_pixel_boxes` at extent 0, the
// table's last four columns), clipped to the frame, meets the tile, and
// the row's last word, its flag, to 1: one thread a triangle, an atomicOr
// a word (exact and order-free on bits). KS runs one thread a pixel of one
// instance, a block of SCAN_BW x SCAN_BH pixels inside one coarse tile. A
// block whose tile's flag is 0 leaves at once (its pixels keep the start
// buffer, as the scan would). Any other reads its tile's words 256 at a
// time, counts their bits with a block prefix, and expands the set bits in
// ascending order (a binary search over the prefix, then the bit's rank in
// its word), 256 candidates a round. Each thread tests one candidate's box
// against the block's pixel rectangle; the hits are appended in draw order
// to a shared stage (warp ballots and a prefix over the warps' counts) with
// their edge deltas and boxes, and once 256 or more are staged the block
// walks them: each warp picks out, 32 boxes at a time, the triangles whose
// box meets its two rows of pixels, and each thread applies the test to
// its pixel sequentially in registers, so the result is exact with no
// atomics. A pixel still sees, in draw order, every triangle whose box
// holds it (a triangle outside a pixel's box cannot cover it: the rounding
// argument of `_pixel_boxes`), so each pixel's winner, depth and
// barycentrics keep their bits.
//
// Bound. The first design had every block stage every triangle's box
// test: 32 bytes of setup a triangle a block, 819 KB a block and 6.7 GB
// (1080p character) or 13.4 GB (2048^2 shadow map) a launch of L2
// traffic, at the L2's rate: 1.33 / 2.45 ms, 119-128x its byte bound. Now
// a busy block reads its tile's words (3.2 KB at 25,608 triangles) and its
// candidates' rows, and what bounds KS is the serial walk of the densest
// blocks (the shadow map's character covers 0.26% of it, with ~12,000
// triangles of a pixel or two): 0.023 / 0.052 ms at 32-pixel tiles on an
// H100, 2.2-2.5x the byte bound. The tile size (`SCAN_TILE` in
// `ops/tiled_raster.py`) is 32: in chip_smoke.py's sweep (16 to 128,
// PERF.md §6) KSb + KS took least time there at both calls; 16 pays
// KSb's clear of 26 / 52 MB of bins, 64 and 128 the blocks' longer
// candidate lists. The wrapper doubles it where the bins of a launch
// would pass 64 MiB.
//
// Every product and sum is rounded separately (__fmul_rn / __fadd_rn /
// __fsub_rn, and the library is built with --fmad=false), in the plain
// version's order, so KS agrees bit for bit with `scan_raster_plain`.

#include <cuda_runtime.h>

namespace {

constexpr int SCAN_BW = 16;                    // block: pixel columns
constexpr int SCAN_BH = 16;                    // block: pixel rows
constexpr int SCAN_THREADS = SCAN_BW * SCAN_BH;
constexpr int SCAN_STAGE = SCAN_THREADS;       // candidates expanded a round
constexpr int SCAN_WORDS = SCAN_THREADS;       // bin words read a chunk
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int BIN_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
static_assert(2 * SCAN_BW == 32, "a warp covers two rows of a block");

// A staged triangle: its three edges as (b.x - a.x, b.y - a.y, a.x, a.y)
// for (a, b) = (v1, v2), (v2, v0), (v0, v1), and (z0, z1, z2, inv_area).
struct Staged {
  float4 e12, e20, e01, zi;
};

__device__ __forceinline__ float edge(const float4& e, float px, float py) {
  return __fsub_rn(__fmul_rn(e.x, __fsub_rn(py, e.w)),
                   __fmul_rn(e.y, __fsub_rn(px, e.z)));
}

__device__ __forceinline__ float4 make_edge(float ax, float ay, float bx,
                                            float by) {
  return make_float4(__fsub_rn(bx, ax), __fsub_rn(by, ay), ax, ay);
}

// The position of the n-th (from 0) set bit of v, which has more than n.
__device__ __forceinline__ int nth_set_bit(unsigned v, int n) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width >= 1; width >>= 1) {
    const int c = __popc(v & ((1u << width) - 1u));
    if (n >= c) {
      n -= c;
      v >>= width;
      pos += width;
    }
  }
  return pos;
}

// table: f32 [n_inst, n, 16] per triangle (x0, y0, x1, y1 | x2, y2, z0, z1
// | z2, inv_area, valid, 0 | box c0, r0, c1, r1); bins: u32 [n_inst,
// tiles_y * tiles_x, words + 1] (a tile's words, then its flag), cleared
// by the caller.
__global__ void __launch_bounds__(BIN_THREADS)
scan_bins_kernel(const float4* __restrict__ table, int n, int words,
                 int tile, int tiles_x, int tiles, int w, int h,
                 unsigned* __restrict__ bins) {
  const int k = blockIdx.x * BIN_THREADS + threadIdx.x;
  if (k >= n) return;
  const float4* tab = table + (static_cast<size_t>(blockIdx.y) * n + k) * 4;
  const float valid = tab[2].z;
  const float4 box = tab[3];
  const float last_x = static_cast<float>(w - 1);
  const float last_y = static_cast<float>(h - 1);
  // false for a NaN anywhere, as the walk's box test
  if (!(valid > 0.0f && box.x <= last_x && box.z >= 0.0f && box.y <= last_y
        && box.w >= 0.0f)) {
    return;
  }
  const int tx0 = static_cast<int>(fmaxf(box.x, 0.0f)) / tile;
  const int ty0 = static_cast<int>(fmaxf(box.y, 0.0f)) / tile;
  const int tx1 = static_cast<int>(fminf(box.z, last_x)) / tile;
  const int ty1 = static_cast<int>(fminf(box.w, last_y)) / tile;
  const int stride = words + 1;
  unsigned* inst = bins + static_cast<size_t>(blockIdx.y) * tiles * stride;
  const unsigned bit = 1u << (k & 31);
  for (int ty = ty0; ty <= ty1; ++ty) {
    for (int tx = tx0; tx <= tx1; ++tx) {
      unsigned* row = inst + static_cast<size_t>(ty * tiles_x + tx) * stride;
      atomicOr(row + (k >> 5), bit);
      atomicOr(row + words, 1u);
    }
  }
}

// The block's walk over the staged triangles [0, count), in draw order.
// A warp covers two rows of the block, (sx0, sy0) .. (sx0 + 15, sy0 + 1):
// its lanes test 32 staged boxes at a time against that strip, and it
// walks only the triangles whose box meets it (none outside can pass any
// of its pixels), each lane applying the test to its own pixel.
__device__ __forceinline__ void walk(const Staged* staged,
                                     const short4* staged_box,
                                     const int* staged_id, int count,
                                     int sx0, int sy0, float px, float py,
                                     float& d, int& id, float& b1w,
                                     float& b2w) {
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < count; j0 += 32) {
    bool meets = false;
    if (j0 + lane < count) {
      const short4 box = staged_box[j0 + lane];
      meets = box.x <= sx0 + SCAN_BW - 1 && box.z >= sx0
              && box.y <= sy0 + 1 && box.w >= sy0;
    }
    for (unsigned m = __ballot_sync(FULL, meets); m != 0u; m &= m - 1u) {
      const int j = j0 + __ffs(m) - 1;
      const Staged s = staged[j];
      const float b0 = __fmul_rn(edge(s.e12, px, py), s.zi.w);
      const float b1 = __fmul_rn(edge(s.e20, px, py), s.zi.w);
      const float b2 = __fmul_rn(edge(s.e01, px, py), s.zi.w);
      const float zp = __fadd_rn(
          __fadd_rn(__fmul_rn(b0, s.zi.x), __fmul_rn(b1, s.zi.y)),
          __fmul_rn(b2, s.zi.z));
      if (b0 >= 0.0f && b1 >= 0.0f && b2 >= 0.0f && zp <= d && zp >= 0.0f
          && zp <= 1.0f) {
        d = zp;
        id = staged_id[j];
        b1w = b1;
        b2w = b2;
      }
    }
  }
}

// table as scan_bins_kernel's, bins as it left them; depth f32, tri i32
// [n_inst, h, w], bary f32 [n_inst, h, w, 2], read and written in place.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_raster_kernel(const float4* __restrict__ table,
                   const unsigned* __restrict__ bins, int n, int words,
                   int tile, int tiles_x, int tiles, int w, int h,
                   float* __restrict__ depth, int* __restrict__ tri,
                   float2* __restrict__ bary) {
  // a round appends at most SCAN_STAGE hits to fewer than SCAN_STAGE
  __shared__ Staged staged[2 * SCAN_STAGE];
  __shared__ short4 staged_box[2 * SCAN_STAGE];
  __shared__ int staged_id[2 * SCAN_STAGE];
  __shared__ unsigned chunk_word[SCAN_WORDS];
  __shared__ int chunk_first[SCAN_WORDS];   // candidates before the word
  __shared__ int warp_bits[SCAN_WARPS];
  __shared__ int warp_hits[SCAN_WARPS];

  const int x0 = blockIdx.x * SCAN_BW;
  const int y0 = blockIdx.y * SCAN_BH;
  const unsigned* row =
      bins + (static_cast<size_t>(blockIdx.z) * tiles
              + (y0 / tile) * tiles_x + x0 / tile) * (words + 1);
  if (row[words] == 0u) return;   // no triangle reaches the tile

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int x = x0 + t % SCAN_BW;
  const int y = y0 + t / SCAN_BW;
  const int sy0 = y0 + 2 * warp;   // the warp's two rows
  const bool inside = x < w && y < h;
  const size_t pix = (static_cast<size_t>(blockIdx.z) * h + y) * w + x;
  // the block's pixel rectangle, clipped to the frame
  const float rx0 = static_cast<float>(x0);
  const float ry0 = static_cast<float>(y0);
  const float rx1 = static_cast<float>(min(x0 + SCAN_BW, w) - 1);
  const float ry1 = static_cast<float>(min(y0 + SCAN_BH, h) - 1);

  float d = 1.0f, b1w = 0.0f, b2w = 0.0f;
  int id = -1;
  if (inside) {
    d = depth[pix];
    id = tri[pix];
    const float2 b = bary[pix];
    b1w = b.x;
    b2w = b.y;
  }
  const float px = static_cast<float>(x) + 0.5f;   // exact
  const float py = static_cast<float>(y) + 0.5f;
  const float4* tab = table + static_cast<size_t>(blockIdx.z) * n * 4;

  int fill = 0;   // staged triangles, the same in every thread
  for (int base = 0; base < words; base += SCAN_WORDS) {
    const unsigned word = base + t < words ? row[base + t] : 0u;
    const int count = __popc(word);
    int incl = count;
#pragma unroll
    for (int dlt = 1; dlt < 32; dlt <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, dlt);
      incl += lane >= dlt ? v : 0;
    }
    if (lane == 31) warp_bits[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int i = 0; i < SCAN_WARPS; ++i) {
      const int m = warp_bits[i];
      before += i < warp ? m : 0;
      total += m;
    }
    chunk_word[t] = word;
    chunk_first[t] = before + incl - count;
    __syncthreads();

    for (int r = 0; r < total; r += SCAN_STAGE) {
      const int j = r + t;
      bool hit = false;
      int k = 0;
      float4 box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (j < total) {
        // the last word whose first candidate is at most j holds j (a
        // word without bits shares its first with the next word)
        int lo = 0, hi = SCAN_WORDS - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (chunk_first[mid] <= j) {
            lo = mid;
          } else {
            hi = mid - 1;
          }
        }
        k = (base + lo) * 32
            + nth_set_bit(chunk_word[lo], j - chunk_first[lo]);
        box = tab[4 * static_cast<size_t>(k) + 3];
        hit = box.x <= rx1 && box.z >= rx0 && box.y <= ry1 && box.w >= ry0;
      }
      const unsigned ballot = __ballot_sync(FULL, hit);
      if (lane == 0) warp_hits[warp] = __popc(ballot);
      __syncthreads();
      int offset = 0, hits = 0;
#pragma unroll
      for (int i = 0; i < SCAN_WARPS; ++i) {
        const int m = warp_hits[i];
        offset += i < warp ? m : 0;
        hits += m;
      }
      if (hit) {
        const int slot = fill + offset + __popc(ballot & below);
        const float4 a = tab[4 * static_cast<size_t>(k)];
        const float4 b = tab[4 * static_cast<size_t>(k) + 1];
        const float4 c = tab[4 * static_cast<size_t>(k) + 2];
        // vertices (a.x, a.y), (a.z, a.w), (b.x, b.y)
        staged[slot].e12 = make_edge(a.z, a.w, b.x, b.y);
        staged[slot].e20 = make_edge(b.x, b.y, a.x, a.y);
        staged[slot].e01 = make_edge(a.x, a.y, a.z, a.w);
        staged[slot].zi = make_float4(b.z, b.w, c.x, c.y);
        // the box's corners are integers in [-1, 32767]
        staged_box[slot] = make_short4(
            static_cast<short>(box.x), static_cast<short>(box.y),
            static_cast<short>(box.z), static_cast<short>(box.w));
        staged_id[slot] = k;
      }
      fill += hits;
      __syncthreads();
      if (fill >= SCAN_STAGE) {
        walk(staged, staged_box, staged_id, fill, x0, sy0, px, py, d, id,
             b1w, b2w);
        fill = 0;
        __syncthreads();   // the next round overwrites `staged`
      }
    }
  }
  walk(staged, staged_box, staged_id, fill, x0, sy0, px, py, d, id, b1w,
       b2w);
  if (inside) {
    depth[pix] = d;
    tri[pix] = id;
    bary[pix] = make_float2(b1w, b2w);
  }
}

bool bad_args(int n_inst, int tile) {
  return n_inst > 65535 || tile <= 0 || tile % SCAN_BW != 0
         || tile % SCAN_BH != 0;
}

}  // namespace

// KSb. table: f32 [n_inst, n, 16] (see scan_bins_kernel), 16-byte aligned;
// bins: u32 [n_inst, ceil(h / tile) * ceil(w / tile), ceil(n / 32) + 1],
// contiguous, cleared here on the stream and filled. Returns the first
// CUDA error of the clear and the launch.
extern "C" int smr_scan_bins(const void* table, int n, int n_inst, int w,
                             int h, int tile, void* bins, void* stream) {
  if (n <= 0 || n_inst <= 0 || w <= 0 || h <= 0) return 0;
  if (bad_args(n_inst, tile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int words = (n + 31) / 32;
  const int tiles_x = (w + tile - 1) / tile;
  const int tiles = tiles_x * ((h + tile - 1) / tile);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(
      bins, 0, static_cast<size_t>(n_inst) * tiles * (words + 1) * 4, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((n + BIN_THREADS - 1) / BIN_THREADS, n_inst);
  scan_bins_kernel<<<grid, BIN_THREADS, 0, s>>>(
      static_cast<const float4*>(table), n, words, tile, tiles_x, tiles, w,
      h, static_cast<unsigned*>(bins));
  return static_cast<int>(cudaGetLastError());
}

// KS. table as smr_scan_bins's, bins as it filled them at the same tile;
// depth f32 / tri i32 [n_inst, h, w] and bary f32 [n_inst, h, w, 2], all
// contiguous, holding the start buffer. Returns cudaGetLastError() after
// the launch.
extern "C" int smr_scan_raster(const void* table, const void* bins, int n,
                               int n_inst, int w, int h, int tile,
                               void* depth, void* tri, void* bary,
                               void* stream) {
  if (n <= 0 || n_inst <= 0 || w <= 0 || h <= 0) return 0;
  if (bad_args(n_inst, tile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int words = (n + 31) / 32;
  const int tiles_x = (w + tile - 1) / tile;
  const int tiles = tiles_x * ((h + tile - 1) / tile);
  const dim3 grid((w + SCAN_BW - 1) / SCAN_BW, (h + SCAN_BH - 1) / SCAN_BH,
                  n_inst);
  scan_raster_kernel<<<grid, SCAN_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const unsigned*>(bins),
      n, words, tile, tiles_x, tiles, w, h, static_cast<float*>(depth),
      static_cast<int*>(tri), static_cast<float2*>(bary));
  return static_cast<int>(cudaGetLastError());
}
