// K1, K2, K4, K6 and the crowd's K5a, K5b, K5c: the binned tile
// rasterizer's per-tile loops.
//
// K1 (`depth_tiles_kernel`) replaces the Pallas kernel `_depth_kernel` with
// its loop `_depth_tile_loop` (simple_mmd_renderer_tpu/ops/tiled_raster.py,
// launched by `_run_depth_kernel` for `rasterize_depth_tiled`, the shadow
// map). K6 (`depth_tiles_win_kernel`) replaces `_depth_kernel_win`
// (launched by `_run_depth_kernel_win` for `rasterize_depth_tiled_window`,
// the shadow map restricted to the casters' tile box). K2
// (`raster_tiles_kernel`) replaces `_raster_kernel` (launched by
// `_run_kernel` for `rasterize_attrs_tiled`, the character's visibility and
// perspective-correct attributes); K4 (`raster_tiles_ms_kernel`) replaces
// its 4x MSAA variant `_raster_kernel_ms` (launched by `_run_kernel_ms` for
// `rasterize_attrs_tiled_msaa`). The crowd kernels replace the same Pallas
// bodies launched with `inst_tiles` over an instance x tile grid: K5a
// (`raster_tiles_multi_kernel`) `_run_kernel_multi`, K5b
// (`raster_tiles_ms_multi_kernel`) `_run_kernel_ms_multi` and K5c
// (`depth_tiles_multi_kernel`) `_run_depth_kernel_multi`. Each runs the
// tile body of K2, K4 or K1 (`raster_tile`, `raster_tile_ms`, `depth_tile`)
// with one block per (instance, tile): block g reads the bins of the global
// tile g, takes its pixel coordinates from the local tile g % inst_tiles
// and writes the planes of instance g / inst_tiles, so a crowd tile gets
// the single-instance kernel's bits on the same bins.
//
// Input is the binning's output: setup rows sorted by tile, so that tile t
// owns the contiguous entries [starts[t], starts[t] + counts[t]) of `rows`
// ([E, row_w] f32). A row holds plane coefficients anchored at the
// triangle's vertex 0 (lanes: 0 ax, 1 ay, 2 w1x, 3 w1y, 4 w2x, 5 w2y, 6 z0,
// 7 zx, 8 zy, 9 valid, 10 triangle id; with attributes, lane 16 starts the
// 1/w denominator plane and lane 19 + 3a the numerator plane of attribute
// a). At pixel centre (px, py) = (x + 0.5, y + 0.5), with dx = px - ax and
// dy = py - ay:
//
//     w1 = w1x*dx + w1y*dy      w2 = w2x*dx + w2y*dy
//     zp = (z0 + zx*dx) + zy*dy
//     cover = w1 >= 0 && w2 >= 0 && w1 + w2 <= 1 && valid > 0
//
// K1: depth = min(1, zp over covering entries with zp >= 0). K6: K1 over
// the tiles of a window of the tile grid, the rest of the map left as the
// caller initialised it (1.0).
// K2: the entry with the smallest zp in [0, 1] wins, a tie goes to the
// larger triangle id (order-free, so entry order never matters); outputs
// depth (1 where empty), tri (-1 where empty), b1 = w1, b2 = w2 and
// attr[a] = num_a / den with den replaced by 1 where |den| <= 1e-9.
// K4: as K2, but an entry takes part where it covers any of the four
// samples at (ox, oy) = MSAA4_OFFSETS, whose planes are the centre's plus
// a per-entry offset (w1s = w1 + (w1x*ox + w1y*oy), likewise w2s and
// zs = zp + (zx*ox + zy*oy)). Its candidate depth is zp where it covers the
// centre, zp + 2 where it covers only samples (a centre-covering entry
// always wins), 4 where it covers none; depth starts at 3 with triangle -1,
// and the clear takes part in the tie rule. The output depth is un-biased
// as the reference does (1 where empty, d - 2 where d > 1.5). Per sample,
// sdepth = min(1, zs over entries covering the sample with zs >= 0).
//
// Every product and sum is rounded separately (__fmul_rn / __fadd_rn, and
// the library is built with --fmad=false), in the reference's order, so the
// kernels agree bit for bit with their plain PyTorch versions
// (`depth_tiles_plain`, `depth_tiles_win_plain`, `raster_tiles_plain`,
// `raster_tiles_ms_plain`).
//
// Design: one block per tile; a thread owns one column and consecutive
// rows, so each row's stores are coalesced (K1/K2/K6: 256 threads, 16 rows
// of a 32-row tile or 4 of an 8-row one; K4: 512 threads of 8 rows, so its
// four per-sample depths per row stay in registers). The block walks its
// entries in chunks of CHUNK rows copied cooperatively into shared memory
// (counts are unbounded: a dense tile loops over as many chunks as it
// needs). K2/K4 keep only depth, triangle id and the winning entry's index
// per pixel and evaluate b1, b2 and the attribute planes once, from the
// winner's row, after the loop: the same arithmetic as carrying every
// plane through the loop, with register use flat in the attribute count.
// K6 reads its window from the card, so its caller sizes no grid from the
// data and needs no host synchronisation.
//
// What bounds them on the H100: the per-entry plane arithmetic (about 20
// fp32 operations per pixel per entry, ~60 for K4's four samples), all from
// shared-memory broadcasts; rows are read once per tile. The simple design
// leaves for later: skipping the rows an entry cannot cover, a
// TMA/cp.async double buffer for the chunk copy, and a retuned tile shape.
//
// Launches on the caller's stream, never synchronises, allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = TILE_H * TILE_W / THREADS;  // 16
constexpr int CHUNK = 256;       // entries per shared-memory chunk
constexpr int LANES = 11;        // lanes the loop reads (0..10)
constexpr int BASE_WIDTH = 16;   // first attribute-plane lane
constexpr int MAX_ATTRS = 36;    // the reference's row-payload bound
constexpr int MS_THREADS = 512;  // K4
constexpr int MS_ROWS = TILE_H * TILE_W / MS_THREADS;  // 8

// D3D11/OpenGL standard 4x MSAA sample offsets from the pixel centre
__constant__ float kSampleX[4] = {-0.125f, 0.375f, -0.375f, 0.125f};
__constant__ float kSampleY[4] = {-0.375f, -0.125f, 0.125f, 0.375f};

// Copy lanes [0, LANES) of rows [first, first + n) into shared memory,
// lane-major (lane l of entry e at sh[l * CHUNK + e]), with NT threads.
template <int NT = THREADS>
__device__ __forceinline__ void load_chunk(float* sh,
                                           const float* __restrict__ rows,
                                           int row_w, int first, int n) {
  for (int i = threadIdx.x; i < n * LANES; i += NT) {
    const int e = i / LANES;
    const int l = i - e * LANES;
    sh[l * CHUNK + e] = rows[static_cast<size_t>(first + e) * row_w + l];
  }
}

// One tile of K1/K6: the min of zp over the tile's entries, for the TH x
// TILE_W tile (ty, tx) of the full grid whose entries are [starts[gid],
// starts[gid] + counts[gid]). Every thread of the block calls it.
template <int TH>
__device__ __forceinline__ void depth_tile(const int* __restrict__ starts,
                                           const int* __restrict__ counts,
                                           const float* __restrict__ rows,
                                           int row_w, int gid, int ty, int tx,
                                           float* __restrict__ depth,
                                           int pad_w, float* sh) {
  constexpr int RPT = TH * TILE_W / THREADS;   // rows per thread
  const int col = threadIdx.x % TILE_W;
  const int row0 = (threadIdx.x / TILE_W) * RPT;
  const float px = (float)col + ((float)(tx * TILE_W) + 0.5f);
  const float ybase = (float)(ty * TH) + 0.5f;

  float d[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) d[r] = 1.0f;

  const int start = starts[gid];
  const int count = counts[gid];
  for (int c0 = 0; c0 < count; c0 += CHUNK) {
    const int n = min(CHUNK, count - c0);
    __syncthreads();
    load_chunk(sh, rows, row_w, start + c0, n);
    __syncthreads();
    for (int e = 0; e < n; ++e) {
      if (!(sh[9 * CHUNK + e] > 0.0f)) continue;
      const float dx = __fsub_rn(px, sh[0 * CHUNK + e]);
      const float ay = sh[1 * CHUNK + e];
      const float w1dx = __fmul_rn(sh[2 * CHUNK + e], dx);
      const float w1y = sh[3 * CHUNK + e];
      const float w2dx = __fmul_rn(sh[4 * CHUNK + e], dx);
      const float w2y = sh[5 * CHUNK + e];
      const float zdx = __fadd_rn(sh[6 * CHUNK + e],
                                  __fmul_rn(sh[7 * CHUNK + e], dx));
      const float zy = sh[8 * CHUNK + e];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float dy = __fsub_rn((float)(row0 + r) + ybase, ay);
        const float w1 = __fadd_rn(w1dx, __fmul_rn(w1y, dy));
        const float w2 = __fadd_rn(w2dx, __fmul_rn(w2y, dy));
        const float zp = __fadd_rn(zdx, __fmul_rn(zy, dy));
        const bool ok = (w1 >= 0.0f) && (w2 >= 0.0f)
                        && (__fadd_rn(w1, w2) <= 1.0f) && (zp >= 0.0f);
        if (ok) d[r] = fminf(d[r], zp);
      }
    }
  }
  const size_t base = static_cast<size_t>(ty * TH + row0) * pad_w
                      + tx * TILE_W + col;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    depth[base + static_cast<size_t>(r) * pad_w] = d[r];
}

__global__ void __launch_bounds__(THREADS)
depth_tiles_kernel(const int* __restrict__ starts,
                   const int* __restrict__ counts,
                   const float* __restrict__ rows, int row_w, int tiles_x,
                   float* __restrict__ depth, int pad_w) {
  __shared__ float sh[LANES * CHUNK];
  const int t = blockIdx.x;
  const int ty = t / tiles_x;
  depth_tile<TILE_H>(starts, counts, rows, row_w, t, ty, t - ty * tiles_x,
                     depth, pad_w, sh);
}

// K6: block i takes tile i of the window (row-major over its tile columns);
// the window (first tile row, first tile column, tile rows, tile columns)
// is read on the card, so the grid covers every tile of the map and the
// blocks past the window's tile count exit at once. Tile coordinates and
// starts/counts are the full grid's, so a window tile gets K1's bits.
template <int TH>
__global__ void __launch_bounds__(THREADS)
depth_tiles_win_kernel(const int* __restrict__ window,
                       const int* __restrict__ starts,
                       const int* __restrict__ counts,
                       const float* __restrict__ rows, int row_w,
                       int n_tiles, int tiles_x, float* __restrict__ depth,
                       int pad_w) {
  __shared__ float sh[LANES * CHUNK];
  const int tw = max(window[3], 0);
  const int i = blockIdx.x;
  if (i >= max(window[2], 0) * tw) return;
  const int ty = window[0] + i / tw;
  const int tx = window[1] + i % tw;
  if (ty < 0 || tx < 0 || tx >= tiles_x || ty * tiles_x + tx >= n_tiles)
    return;
  depth_tile<TH>(starts, counts, rows, row_w, ty * tiles_x + tx, ty, tx,
                 depth, pad_w, sh);
}

// b1, b2 and the attributes at pixel centre (px, py), offset o, from the
// winning entry `win` (zeros where win < 0), as K2 and K4 write them.
__device__ __forceinline__ void write_winner(const float* __restrict__ rows,
                                             int row_w, int n_attrs, int win,
                                             float px, float py, size_t o,
                                             size_t plane,
                                             float* __restrict__ b1,
                                             float* __restrict__ b2,
                                             float* __restrict__ attr) {
  float w1 = 0.0f, w2 = 0.0f;
  if (win >= 0) {
    const float* rw = rows + static_cast<size_t>(win) * row_w;
    const float dx = __fsub_rn(px, rw[0]);
    const float dy = __fsub_rn(py, rw[1]);
    w1 = __fadd_rn(__fmul_rn(rw[2], dx), __fmul_rn(rw[3], dy));
    w2 = __fadd_rn(__fmul_rn(rw[4], dx), __fmul_rn(rw[5], dy));
    if (n_attrs > 0) {
      const float* p = rw + BASE_WIDTH;
      float den = __fadd_rn(__fadd_rn(p[0], __fmul_rn(p[1], dx)),
                            __fmul_rn(p[2], dy));
      den = fabsf(den) > 1e-9f ? den : 1.0f;
      for (int a = 0; a < n_attrs; ++a) {
        const float* q = p + 3 + 3 * a;
        const float num = __fadd_rn(__fadd_rn(q[0], __fmul_rn(q[1], dx)),
                                    __fmul_rn(q[2], dy));
        attr[a * plane + o] = __fdiv_rn(num, den);
      }
    }
  } else {
    for (int a = 0; a < n_attrs; ++a) attr[a * plane + o] = 0.0f;
  }
  if (n_attrs == 0) attr[o] = 0.0f;
  b1[o] = w1;
  b2[o] = w2;
}

// One tile of K2/K5a: tile (ty, tx) of one instance's frame, whose entries
// are [starts[gid], starts[gid] + counts[gid]); the output planes are that
// instance's. Every thread of the block calls it.
__device__ __forceinline__ void raster_tile(
    const int* __restrict__ starts, const int* __restrict__ counts,
    const float* __restrict__ rows, int row_w, int n_attrs, int gid, int ty,
    int tx, float* __restrict__ depth, int* __restrict__ tri,
    float* __restrict__ b1, float* __restrict__ b2, float* __restrict__ attr,
    int pad_h, int pad_w, float* sh) {
  const int col = threadIdx.x % TILE_W;
  const int row0 = (threadIdx.x / TILE_W) * ROWS_PER_THREAD;
  const float px = (float)col + ((float)(tx * TILE_W) + 0.5f);
  const float ybase = (float)(ty * TILE_H) + 0.5f;

  float d[ROWS_PER_THREAD];
  int id[ROWS_PER_THREAD];
  int win[ROWS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    d[r] = 1.0f;
    id[r] = -1;
    win[r] = -1;
  }

  const int start = starts[gid];
  const int count = counts[gid];
  for (int c0 = 0; c0 < count; c0 += CHUNK) {
    const int n = min(CHUNK, count - c0);
    __syncthreads();
    load_chunk(sh, rows, row_w, start + c0, n);
    __syncthreads();
    for (int e = 0; e < n; ++e) {
      if (!(sh[9 * CHUNK + e] > 0.0f)) continue;
      const float dx = __fsub_rn(px, sh[0 * CHUNK + e]);
      const float ay = sh[1 * CHUNK + e];
      const float w1dx = __fmul_rn(sh[2 * CHUNK + e], dx);
      const float w1y = sh[3 * CHUNK + e];
      const float w2dx = __fmul_rn(sh[4 * CHUNK + e], dx);
      const float w2y = sh[5 * CHUNK + e];
      const float zdx = __fadd_rn(sh[6 * CHUNK + e],
                                  __fmul_rn(sh[7 * CHUNK + e], dx));
      const float zy = sh[8 * CHUNK + e];
      const int tid = (int)sh[10 * CHUNK + e];
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r) {
        const float dy = __fsub_rn((float)(row0 + r) + ybase, ay);
        const float w1 = __fadd_rn(w1dx, __fmul_rn(w1y, dy));
        const float w2 = __fadd_rn(w2dx, __fmul_rn(w2y, dy));
        const float zp = __fadd_rn(zdx, __fmul_rn(zy, dy));
        const bool ok = (w1 >= 0.0f) && (w2 >= 0.0f)
                        && (__fadd_rn(w1, w2) <= 1.0f) && (zp >= 0.0f)
                        && (zp <= 1.0f);
        if (ok && (zp < d[r] || (zp == d[r] && tid > id[r]))) {
          d[r] = zp;
          id[r] = tid;
          win[r] = start + c0 + e;
        }
      }
    }
  }

  const size_t plane = static_cast<size_t>(pad_h) * pad_w;
  const size_t base = static_cast<size_t>(ty * TILE_H + row0) * pad_w
                      + tx * TILE_W + col;
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const size_t o = base + static_cast<size_t>(r) * pad_w;
    depth[o] = d[r];
    tri[o] = id[r];
    write_winner(rows, row_w, n_attrs, win[r], px,
                 (float)(row0 + r) + ybase, o, plane, b1, b2, attr);
  }
}

__global__ void __launch_bounds__(THREADS)
raster_tiles_kernel(const int* __restrict__ starts,
                    const int* __restrict__ counts,
                    const float* __restrict__ rows, int row_w, int n_attrs,
                    int tiles_x, float* __restrict__ depth,
                    int* __restrict__ tri, float* __restrict__ b1,
                    float* __restrict__ b2, float* __restrict__ attr,
                    int pad_h, int pad_w) {
  __shared__ float sh[LANES * CHUNK];
  const int t = blockIdx.x;
  const int ty = t / tiles_x;
  raster_tile(starts, counts, rows, row_w, n_attrs, t, ty, t - ty * tiles_x,
              depth, tri, b1, b2, attr, pad_h, pad_w, sh);
}

// K5a: block i takes tile i % inst_tiles of instance i / inst_tiles;
// starts/counts are indexed by the global tile i, pixel coordinates come
// from the local tile, every output plane is offset by the instance.
__global__ void __launch_bounds__(THREADS)
raster_tiles_multi_kernel(const int* __restrict__ starts,
                          const int* __restrict__ counts,
                          const float* __restrict__ rows, int row_w,
                          int n_attrs, int inst_tiles, int tiles_x,
                          float* __restrict__ depth, int* __restrict__ tri,
                          float* __restrict__ b1, float* __restrict__ b2,
                          float* __restrict__ attr, int pad_h, int pad_w) {
  __shared__ float sh[LANES * CHUNK];
  const int g = blockIdx.x;
  const int inst = g / inst_tiles;
  const int local = g - inst * inst_tiles;
  const int ty = local / tiles_x;
  const size_t o = static_cast<size_t>(inst) * pad_h * pad_w;
  raster_tile(starts, counts, rows, row_w, n_attrs, g, ty,
              local - ty * tiles_x, depth + o, tri + o, b1 + o, b2 + o,
              attr + o * max(n_attrs, 1), pad_h, pad_w, sh);
}

// One tile of K4/K5b (see raster_tile), with the per-sample depths.
__device__ __forceinline__ void raster_tile_ms(
    const int* __restrict__ starts, const int* __restrict__ counts,
    const float* __restrict__ rows, int row_w, int n_attrs, int gid, int ty,
    int tx, float* __restrict__ depth, int* __restrict__ tri,
    float* __restrict__ b1, float* __restrict__ b2, float* __restrict__ attr,
    float* __restrict__ sdepth, int pad_h, int pad_w, float* sh) {
  const int col = threadIdx.x % TILE_W;
  const int row0 = (threadIdx.x / TILE_W) * MS_ROWS;
  const float px = (float)col + ((float)(tx * TILE_W) + 0.5f);
  const float ybase = (float)(ty * TILE_H) + 0.5f;

  float d[MS_ROWS];
  int id[MS_ROWS];
  int win[MS_ROWS];
  float sd[4][MS_ROWS];
#pragma unroll
  for (int r = 0; r < MS_ROWS; ++r) {
    d[r] = 3.0f;          // the biased clear
    id[r] = -1;
    win[r] = -1;
#pragma unroll
    for (int k = 0; k < 4; ++k) sd[k][r] = 1.0f;
  }

  const int start = starts[gid];
  const int count = counts[gid];
  for (int c0 = 0; c0 < count; c0 += CHUNK) {
    const int n = min(CHUNK, count - c0);
    __syncthreads();
    load_chunk<MS_THREADS>(sh, rows, row_w, start + c0, n);
    __syncthreads();
    for (int e = 0; e < n; ++e) {
      // an invalid entry covers no sample: its candidate (4) never wins
      // and its sample depths (2) never go below the clear (1)
      if (!(sh[9 * CHUNK + e] > 0.0f)) continue;
      const float dx = __fsub_rn(px, sh[0 * CHUNK + e]);
      const float ay = sh[1 * CHUNK + e];
      const float w1x = sh[2 * CHUNK + e];
      const float w1y = sh[3 * CHUNK + e];
      const float w2x = sh[4 * CHUNK + e];
      const float w2y = sh[5 * CHUNK + e];
      const float zx = sh[7 * CHUNK + e];
      const float zy = sh[8 * CHUNK + e];
      const float w1dx = __fmul_rn(w1x, dx);
      const float w2dx = __fmul_rn(w2x, dx);
      const float zdx = __fadd_rn(sh[6 * CHUNK + e], __fmul_rn(zx, dx));
      const int tid = (int)sh[10 * CHUNK + e];
      float dw1[4], dw2[4], dz[4];   // per-sample plane offsets
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dw1[k] = __fadd_rn(__fmul_rn(w1x, kSampleX[k]),
                           __fmul_rn(w1y, kSampleY[k]));
        dw2[k] = __fadd_rn(__fmul_rn(w2x, kSampleX[k]),
                           __fmul_rn(w2y, kSampleY[k]));
        dz[k] = __fadd_rn(__fmul_rn(zx, kSampleX[k]),
                          __fmul_rn(zy, kSampleY[k]));
      }
#pragma unroll
      for (int r = 0; r < MS_ROWS; ++r) {
        const float dy = __fsub_rn((float)(row0 + r) + ybase, ay);
        const float w1 = __fadd_rn(w1dx, __fmul_rn(w1y, dy));
        const float w2 = __fadd_rn(w2dx, __fmul_rn(w2y, dy));
        const float zp = __fadd_rn(zdx, __fmul_rn(zy, dy));
        bool any = false;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float w1s = __fadd_rn(w1, dw1[k]);
          const float w2s = __fadd_rn(w2, dw2[k]);
          const float zs = __fadd_rn(zp, dz[k]);
          const bool cov = (w1s >= 0.0f) && (w2s >= 0.0f)
                           && (__fadd_rn(w1s, w2s) <= 1.0f);
          any = any || cov;
          if (cov && zs >= 0.0f) sd[k][r] = fminf(sd[k][r], zs);
        }
        if (any && zp >= 0.0f && zp <= 1.0f) {
          const bool centre = (w1 >= 0.0f) && (w2 >= 0.0f)
                              && (__fadd_rn(w1, w2) <= 1.0f);
          const float zb = __fadd_rn(zp, centre ? 0.0f : 2.0f);
          if (zb < d[r] || (zb == d[r] && tid > id[r])) {
            d[r] = zb;
            id[r] = tid;
            win[r] = start + c0 + e;
          }
        }
      }
    }
  }

  const size_t plane = static_cast<size_t>(pad_h) * pad_w;
  const size_t base = static_cast<size_t>(ty * TILE_H + row0) * pad_w
                      + tx * TILE_W + col;
#pragma unroll
  for (int r = 0; r < MS_ROWS; ++r) {
    const size_t o = base + static_cast<size_t>(r) * pad_w;
    depth[o] = id[r] < 0 ? 1.0f
                         : (d[r] > 1.5f ? __fsub_rn(d[r], 2.0f) : d[r]);
    tri[o] = id[r];
#pragma unroll
    for (int k = 0; k < 4; ++k) sdepth[k * plane + o] = sd[k][r];
    write_winner(rows, row_w, n_attrs, win[r], px,
                 (float)(row0 + r) + ybase, o, plane, b1, b2, attr);
  }
}

__global__ void __launch_bounds__(MS_THREADS)
raster_tiles_ms_kernel(const int* __restrict__ starts,
                       const int* __restrict__ counts,
                       const float* __restrict__ rows, int row_w,
                       int n_attrs, int tiles_x, float* __restrict__ depth,
                       int* __restrict__ tri, float* __restrict__ b1,
                       float* __restrict__ b2, float* __restrict__ attr,
                       float* __restrict__ sdepth, int pad_h, int pad_w) {
  __shared__ float sh[LANES * CHUNK];
  const int t = blockIdx.x;
  const int ty = t / tiles_x;
  raster_tile_ms(starts, counts, rows, row_w, n_attrs, t, ty,
                 t - ty * tiles_x, depth, tri, b1, b2, attr, sdepth, pad_h,
                 pad_w, sh);
}

// K5b: K4 over the instance x tile grid (see raster_tiles_multi_kernel).
__global__ void __launch_bounds__(MS_THREADS)
raster_tiles_ms_multi_kernel(const int* __restrict__ starts,
                             const int* __restrict__ counts,
                             const float* __restrict__ rows, int row_w,
                             int n_attrs, int inst_tiles, int tiles_x,
                             float* __restrict__ depth,
                             int* __restrict__ tri, float* __restrict__ b1,
                             float* __restrict__ b2, float* __restrict__ attr,
                             float* __restrict__ sdepth, int pad_h,
                             int pad_w) {
  __shared__ float sh[LANES * CHUNK];
  const int g = blockIdx.x;
  const int inst = g / inst_tiles;
  const int local = g - inst * inst_tiles;
  const int ty = local / tiles_x;
  const size_t o = static_cast<size_t>(inst) * pad_h * pad_w;
  raster_tile_ms(starts, counts, rows, row_w, n_attrs, g, ty,
                 local - ty * tiles_x, depth + o, tri + o, b1 + o, b2 + o,
                 attr + o * max(n_attrs, 1), sdepth + o * 4, pad_h, pad_w,
                 sh);
}

// K5c: K1 over the instance x tile grid (see raster_tiles_multi_kernel).
__global__ void __launch_bounds__(THREADS)
depth_tiles_multi_kernel(const int* __restrict__ starts,
                         const int* __restrict__ counts,
                         const float* __restrict__ rows, int row_w,
                         int inst_tiles, int tiles_x,
                         float* __restrict__ depth, int pad_h, int pad_w) {
  __shared__ float sh[LANES * CHUNK];
  const int g = blockIdx.x;
  const int inst = g / inst_tiles;
  const int local = g - inst * inst_tiles;
  const int ty = local / tiles_x;
  depth_tile<TILE_H>(starts, counts, rows, row_w, g, ty, local - ty * tiles_x,
                     depth + static_cast<size_t>(inst) * pad_h * pad_w, pad_w,
                     sh);
}

}  // namespace

// starts: i32 [n_tiles + 1]; counts: i32 [n_tiles]; rows: f32 [E, row_w];
// depth: f32 [pad_h, pad_w] with pad_h = tiles_y * 32, pad_w = tiles_x * 128.
// Returns cudaGetLastError() after the launch.
extern "C" int smr_depth_tiles(const void* starts, const void* counts,
                               const void* rows, int row_w, int n_tiles,
                               int tiles_x, void* depth, int pad_w,
                               void* stream) {
  if (n_tiles <= 0) return 0;
  if (row_w < LANES) return static_cast<int>(cudaErrorInvalidValue);
  depth_tiles_kernel<<<n_tiles, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const float*>(rows), row_w, tiles_x,
      static_cast<float*>(depth), pad_w);
  return static_cast<int>(cudaGetLastError());
}

// As smr_depth_tiles, plus tri: i32 [pad_h, pad_w], b1/b2: f32 [pad_h,
// pad_w] and attr: f32 [max(n_attrs, 1), pad_h, pad_w]; rows must hold
// BASE_WIDTH + 3 + 3 * n_attrs lanes when n_attrs > 0.
extern "C" int smr_raster_tiles(const void* starts, const void* counts,
                                const void* rows, int row_w, int n_attrs,
                                int n_tiles, int tiles_x, void* depth,
                                void* tri, void* b1, void* b2, void* attr,
                                int pad_h, int pad_w, void* stream) {
  if (n_tiles <= 0) return 0;
  if (n_attrs < 0 || n_attrs > MAX_ATTRS || row_w < LANES
      || (n_attrs > 0 && row_w < BASE_WIDTH + 3 + 3 * n_attrs))
    return static_cast<int>(cudaErrorInvalidValue);
  raster_tiles_kernel<<<n_tiles, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const float*>(rows), row_w, n_attrs, tiles_x,
      static_cast<float*>(depth), static_cast<int*>(tri),
      static_cast<float*>(b1), static_cast<float*>(b2),
      static_cast<float*>(attr), pad_h, pad_w);
  return static_cast<int>(cudaGetLastError());
}

// As smr_raster_tiles (K4), plus sdepth: f32 [4, pad_h, pad_w].
extern "C" int smr_raster_tiles_ms(const void* starts, const void* counts,
                                   const void* rows, int row_w, int n_attrs,
                                   int n_tiles, int tiles_x, void* depth,
                                   void* tri, void* b1, void* b2, void* attr,
                                   void* sdepth, int pad_h, int pad_w,
                                   void* stream) {
  if (n_tiles <= 0) return 0;
  if (n_attrs < 0 || n_attrs > MAX_ATTRS || row_w < LANES
      || (n_attrs > 0 && row_w < BASE_WIDTH + 3 + 3 * n_attrs))
    return static_cast<int>(cudaErrorInvalidValue);
  raster_tiles_ms_kernel<<<n_tiles, MS_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const float*>(rows), row_w, n_attrs, tiles_x,
      static_cast<float*>(depth), static_cast<int*>(tri),
      static_cast<float*>(b1), static_cast<float*>(b2),
      static_cast<float*>(attr), static_cast<float*>(sdepth), pad_h, pad_w);
  return static_cast<int>(cudaGetLastError());
}

// K6. window: i32 [4] on the card (first tile row, first tile column, tile
// rows, tile columns); starts/counts/rows as smr_depth_tiles over
// tile_h x 128 tiles (tile_h 8 or 32); depth: f32 [tiles_y * tile_h,
// pad_w], already filled with 1.0 by the caller (only window tiles are
// written). One block per tile of the map.
extern "C" int smr_depth_tiles_win(const void* window, const void* starts,
                                   const void* counts, const void* rows,
                                   int row_w, int n_tiles, int tiles_x,
                                   int tile_h, void* depth, int pad_w,
                                   void* stream) {
  if (n_tiles <= 0) return 0;
  if (row_w < LANES || (tile_h != 8 && tile_h != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<const int*>(window);
  const auto s = static_cast<const int*>(starts);
  const auto c = static_cast<const int*>(counts);
  const auto r = static_cast<const float*>(rows);
  const auto d = static_cast<float*>(depth);
  if (tile_h == 32)
    depth_tiles_win_kernel<32><<<n_tiles, THREADS, 0, st>>>(
        w, s, c, r, row_w, n_tiles, tiles_x, d, pad_w);
  else
    depth_tiles_win_kernel<8><<<n_tiles, THREADS, 0, st>>>(
        w, s, c, r, row_w, n_tiles, tiles_x, d, pad_w);
  return static_cast<int>(cudaGetLastError());
}

// K5c, K5a, K5b: the crowd launchers. starts: i32 [n_inst * inst_tiles + 1]
// and counts: i32 [n_inst * inst_tiles] over the global tile
// inst * inst_tiles + tile; every output gains a leading instance axis:
// depth/tri/b1/b2 [n_inst, pad_h, pad_w], attr [n_inst, max(n_attrs, 1),
// pad_h, pad_w], sdepth [n_inst, 4, pad_h, pad_w]. One block per
// (instance, tile).
extern "C" int smr_depth_tiles_multi(const void* starts, const void* counts,
                                     const void* rows, int row_w, int n_inst,
                                     int inst_tiles, int tiles_x, void* depth,
                                     int pad_h, int pad_w, void* stream) {
  if (n_inst <= 0 || inst_tiles <= 0) return 0;
  if (row_w < LANES) return static_cast<int>(cudaErrorInvalidValue);
  depth_tiles_multi_kernel<<<n_inst * inst_tiles, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const float*>(rows), row_w, inst_tiles, tiles_x,
      static_cast<float*>(depth), pad_h, pad_w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int smr_raster_tiles_multi(const void* starts, const void* counts,
                                      const void* rows, int row_w,
                                      int n_attrs, int n_inst, int inst_tiles,
                                      int tiles_x, void* depth, void* tri,
                                      void* b1, void* b2, void* attr,
                                      int pad_h, int pad_w, void* stream) {
  if (n_inst <= 0 || inst_tiles <= 0) return 0;
  if (n_attrs < 0 || n_attrs > MAX_ATTRS || row_w < LANES
      || (n_attrs > 0 && row_w < BASE_WIDTH + 3 + 3 * n_attrs))
    return static_cast<int>(cudaErrorInvalidValue);
  raster_tiles_multi_kernel<<<n_inst * inst_tiles, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const float*>(rows), row_w, n_attrs, inst_tiles, tiles_x,
      static_cast<float*>(depth), static_cast<int*>(tri),
      static_cast<float*>(b1), static_cast<float*>(b2),
      static_cast<float*>(attr), pad_h, pad_w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int smr_raster_tiles_ms_multi(const void* starts,
                                         const void* counts, const void* rows,
                                         int row_w, int n_attrs, int n_inst,
                                         int inst_tiles, int tiles_x,
                                         void* depth, void* tri, void* b1,
                                         void* b2, void* attr, void* sdepth,
                                         int pad_h, int pad_w, void* stream) {
  if (n_inst <= 0 || inst_tiles <= 0) return 0;
  if (n_attrs < 0 || n_attrs > MAX_ATTRS || row_w < LANES
      || (n_attrs > 0 && row_w < BASE_WIDTH + 3 + 3 * n_attrs))
    return static_cast<int>(cudaErrorInvalidValue);
  raster_tiles_ms_multi_kernel<<<n_inst * inst_tiles, MS_THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const float*>(rows), row_w, n_attrs, inst_tiles, tiles_x,
      static_cast<float*>(depth), static_cast<int*>(tri),
      static_cast<float*>(b1), static_cast<float*>(b2),
      static_cast<float*>(attr), static_cast<float*>(sdepth), pad_h, pad_w);
  return static_cast<int>(cudaGetLastError());
}
