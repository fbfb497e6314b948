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
// (`depth_tiles_multi_kernel`) `_run_depth_kernel_multi`. K5a, K5b and K5c
// run the tile body of K2, K4 or K1 (`raster_tile`, `raster_tile_ms`,
// `depth_tile`). Each has one block (K5c: one cluster) per (instance,
// tile): block g reads the bins of the global tile g, takes its pixel
// coordinates from the local tile g % inst_tiles and writes the planes of
// instance g / inst_tiles, so a crowd tile gets the single-instance
// kernel's bits on the same bins and boxes.
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
// attr[a] = num_a / den with den replaced by 1 where |den| <= 1e-9; the
// clear (depth 1, triangle -1) takes part in the tie rule, so an entry at
// exactly zp = 1 wins its pixel.
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
// `raster_tiles_ms_plain`), which evaluate every entry at every pixel of
// its tile.
//
// Design of K1/K6/K5c (`depth_tile`): the raster bodies' design below with
// one word of state and one pass. The state of one TH x 128 tile (TH 32
// for K1 and K5c, 8 or 32 for K6) is one u32 a pixel in shared memory (16
// KB at 32 rows, 4 KB at 8), cleared to the bits of 1.0. Entries are taken
// one a thread through the same walks (`tile_entries` with its wide-box
// queue): where an entry covers a pixel centre with zp >= 0 it does an
// integer atomicMin on the bits of zp + 0. There is no key, no second pass
// and no gather; the tile is then stored with coalesced 16-byte writes.
// The zp <= 1 test of K2 is not needed: the clear at 1.0 implies it. The
// planes are evaluated in the order of the plain version, so the bits are
// its bits, except for the sign of a zero depth: the fold stores +0.0
// where the plain version's min may keep -0.0 (the two compare equal, as
// `torch.equal` and the smoke run's mismatch count compare).
// A tile is split over a cluster of CLUSTER blocks (a template argument):
// block r takes the chunks r, r + CLUSTER, ... of the entries and lowers
// the state of the leader (rank 0) through distributed shared memory,
// between two cluster barriers. A tile without entries takes no state and
// no barrier: its leader stores the clear and the other blocks leave at
// once. K1 and K6 take DEPTH_CLUSTER = 8: at the flagship's light all the
// entries fall in a few dozen of the map's 1,024 tiles, up to 2,189 in one,
// and 8 blocks of 256 threads beat 1, 2 and 4 blocks and 512 or 1,024
// threads (scripts/probe_torch_raster_ms.py). K5c takes
// CROWD_DEPTH_CLUSTER = 1, one block a tile: the crowd's entries spread
// over its 64 maps' 1,024 tiles, some 70 a tile, where a cluster's launch
// and barriers cost more than they share (the same script on the crowd's
// frame-1 bins: 1, 2, 4 and 8 blocks 0.0124, 0.0136, 0.0180 and 0.0299 ms
// back to back on an H100). What bounds them now: the launch of the
// blocks, most of which leave at once or hold a chunk or less, and the
// maps' store (K5c on empty bins takes half its time on the frame's); the
// fullest tile's walks come after. K6 reads
// its window from the card, so its caller sizes no grid from the data and
// needs no host synchronisation; the clusters past the window's tile count
// exit at once. `boxes` None on the host side means every entry over its
// whole tile (each gets the whole int16 range as its box).
//
// Design of the raster bodies, K2/K5a (`raster_tile`, centre-sampled) and
// K4/K5b (`raster_tile_ms`): an entry is evaluated only where it can cover.
// The binning hands each entry the box of pixels its triangle can reach
// (`boxes`, int16 x0, y0, x1, y1 in the frame, a pixel of margin included;
// see `_pixel_boxes` in ops/tiled_raster.py for why the margin is safe and
// which triangles get the whole range instead). One block still owns a
// 32x128 tile, but its running state lives in shared memory (per pixel the
// least depth and the winner's key, 48 KB, for K2; the least biased depth
// and four sample depths, 80 KB, for K4) and its threads take ENTRIES, a
// chunk of one per thread at a time: a thread reads its entry's row and box
// straight into registers (three float4 loads and one 8-byte load; no
// staging buffer, no barrier around a copy), clamps the box to the tile and
// walks it, updating the pixels it covers with integer atomicMin on the
// depths' bits. An entry whose clamped box is wider than `wide_box` pixels
// is queued instead, and the block's warps then share the queue, the 32
// lanes of a warp striding over one box (all the threads of the block over
// a box of more than BLOCK_BOX pixels), so that one thread never holds its
// block up with a box of thousands of pixels. A second pass over the same
// entries finds each pixel's winner: among the entries whose candidate
// equals the final depth, atomicMax on (triangle id, entry index) - the
// plain version's choice whatever the order of the entries; it skips a
// pixel as soon as the entry's zp cannot be the pixel's depth. The epilogue
// (K4's un-bias, b1, b2, attributes from the winner's row: aligned float4
// loads in K2/K4, lane by lane in the crowd kernels, each measured the
// faster there) is pixel-parallel with coalesced stores. 1,024 threads a
// block (up to 64 registers each: one block on an SM) measured faster than
// 512 (two blocks) for all four kernels: a tile's block is the unit of
// work, and the fullest tile's sets the kernel's time.
// What bounds them now: with sub-pixel triangles (the crowd) a box holds a
// dozen pixels and most of the time goes to what the kernel moves - the
// rows, read once per pass, and the output planes; with triangles of tens
// of pixels (the flagship) to the evaluation of the fullest tile's entries
// on one SM and to the epilogue's gather of the winners' rows, since one
// block still owns a tile however many entries it holds. Left for later:
// splitting such a tile over the blocks of a cluster, and a sorted row
// buffer without the unused slots.
//
// Launches on the caller's stream, never synchronises, allocates nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int BASE_WIDTH = 16;   // first attribute-plane lane
constexpr int MAX_ATTRS = 36;    // the reference's row-payload bound
constexpr int CENTRE_THREADS = 1024;  // K2/K5a
constexpr int MS_THREADS = 1024;  // K4/K5b
constexpr int DEPTH_THREADS = 256;  // K1/K6/K5c: threads a block
constexpr int DEPTH_CLUSTER = 8;    // K1/K6: blocks a tile
constexpr int CROWD_DEPTH_CLUSTER = 1;   // K5c: blocks a tile

// D3D11/OpenGL standard 4x MSAA sample offsets from the pixel centre
__constant__ float kSampleX[4] = {-0.125f, 0.375f, -0.375f, 0.125f};
__constant__ float kSampleY[4] = {-0.375f, -0.125f, 0.125f, 0.375f};

// ---------------------------------------------------------------------------
// The boxed tile bodies: K2/K5a, K4/K5b and K1/K6/K5c. Entries are
// evaluated only inside their pixel boxes, in parallel, against tile state
// held in shared memory.
// ---------------------------------------------------------------------------

constexpr int TILE_PIX = TILE_H * TILE_W;   // 4096
constexpr int BLOCK_BOX = 1024;   // pixels of the largest box one warp takes

// The body kinds: CENTRE (K2/K5a), MSAA (K4/K5b), DEPTH (K1/K6/K5c).
enum Kind { CENTRE, MSAA, DEPTH };

// Per body kind and tile height TH (only DEPTH takes 8 as well as 32):
// threads a block, and the u32 words of tile state per pixel. Shared memory
// of one block (dynamic, `shared` bytes):
//   depth  u32 [pix]           bits of each pixel's least depth (K4: biased)
//   K2:  win u64 [pix]         (triangle id + 1) << 32 | (entry in tile + 1)
//   K4:  sd  u32 [4][pix]      bits of the four per-sample depths; once they
//                              are written out, the same bytes hold `win`
//   wide   i32 [threads]       this chunk's entries with wide boxes
//   n_wide i32
// Every depth kept here is >= +0 (zp >= 0 is tested, -0 is folded into +0,
// K4's biases are +2 and the clears 3 and 1), and the bits of non-negative
// floats order as unsigned integers. So the state is updated with integer
// atomicMin / atomicMax only: exact and order-free, whatever order the
// threads arrive in, which keeps the kernels deterministic (no float atomic
// is used anywhere).
template <int KIND, int TH = TILE_H>
struct Body {
  static constexpr int pix = TH * TILE_W;
  static constexpr int threads = KIND == MSAA     ? MS_THREADS
                                 : KIND == CENTRE ? CENTRE_THREADS
                                                  : DEPTH_THREADS;
  static constexpr int words = KIND == MSAA ? 5 : KIND == CENTRE ? 3 : 1;
  static constexpr size_t shared =
      sizeof(unsigned) * (words * pix + threads + 4);
};

struct TileShared {
  unsigned* depth;
  unsigned* sd;                 // K4 only
  unsigned long long* win;      // K2, K4
  int* wide;
  int* n_wide;
};

template <int KIND, int TH = TILE_H>
__device__ __forceinline__ TileShared tile_shared(unsigned char* smem) {
  using B = Body<KIND, TH>;
  TileShared sh;
  sh.depth = reinterpret_cast<unsigned*>(smem);
  sh.sd = sh.depth + B::pix;
  sh.win = reinterpret_cast<unsigned long long*>(sh.sd);
  sh.wide = reinterpret_cast<int*>(sh.depth + B::words * B::pix);
  sh.n_wide = sh.wide + B::threads;
  return sh;
}

// One entry's planes in registers (K4: with its per-sample plane offsets).
struct Entry {
  float ax, ay, w1x, w1y, w2x, w2y, z0, zx, zy;
  int tid;
  float dw1[4], dw2[4], dz[4];
  int x0, y0, x1, y1;   // its box clamped to the tile, tile-local
};

// Entry e's box clamped to the TH x TILE_W tile (ty, tx), tile-local -> its
// pixel count (0 where it misses the tile).
template <int TH>
__device__ __forceinline__ int entry_box(const short4* __restrict__ boxes,
                                         int e, int ty, int tx, Entry& en) {
  const short4 bx = __ldg(boxes + e);
  en.x0 = max((int)bx.x - tx * TILE_W, 0);
  en.y0 = max((int)bx.y - ty * TH, 0);
  en.x1 = min((int)bx.z - tx * TILE_W, TILE_W - 1);
  en.y1 = min((int)bx.w - ty * TH, TH - 1);
  return max(en.x1 - en.x0 + 1, 0) * max(en.y1 - en.y0 + 1, 0);
}

// Load the planes of entry e of `rows` (lanes 0..11 as three float4). False
// where the entry is invalid: it covers nothing.
template <bool MS>
__device__ __forceinline__ bool entry_planes(const float* __restrict__ rows,
                                             int row_w, int e, Entry& en) {
  const float4* r = reinterpret_cast<const float4*>(
      rows + static_cast<size_t>(e) * row_w);
  const float4 c = __ldg(r + 2);            // lanes 8..11
  if (!(c.y > 0.0f)) return false;          // lane 9: valid
  const float4 a = __ldg(r);                // lanes 0..3
  const float4 b = __ldg(r + 1);            // lanes 4..7
  en.ax = a.x; en.ay = a.y; en.w1x = a.z; en.w1y = a.w;
  en.w2x = b.x; en.w2y = b.y; en.z0 = b.z; en.zx = b.w;
  en.zy = c.x;
  en.tid = (int)c.z;                        // lane 10
  if constexpr (MS) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      en.dw1[k] = __fadd_rn(__fmul_rn(en.w1x, kSampleX[k]),
                            __fmul_rn(en.w1y, kSampleY[k]));
      en.dw2[k] = __fadd_rn(__fmul_rn(en.w2x, kSampleX[k]),
                            __fmul_rn(en.w2y, kSampleY[k]));
      en.dz[k] = __fadd_rn(__fmul_rn(en.zx, kSampleX[k]),
                           __fmul_rn(en.zy, kSampleY[k]));
    }
  }
  return true;
}

// K2: entry `en` at tile-local pixel (lx, ly), whose centre is (px, py):
// the arithmetic of the reference's loop, product by product. PASS 1 lowers
// the pixel's depth where the entry covers the centre with 0 <= zp <= 1;
// PASS 2 (the depth final) raises `win` to `key` where that zp is the
// pixel's depth.
template <int PASS>
__device__ __forceinline__ void centre_pixel(const Entry& en, int lx, int ly,
                                             float px, float py,
                                             const TileShared& sh,
                                             unsigned long long key) {
  const int p = ly * TILE_W + lx;
  const float dx = __fsub_rn(px, en.ax);
  const float dy = __fsub_rn(py, en.ay);
  const float zp = __fadd_rn(__fadd_rn(en.z0, __fmul_rn(en.zx, dx)),
                             __fmul_rn(en.zy, dy));
  // zp + 0 folds -0 into +0
  const unsigned bits = __float_as_uint(__fadd_rn(zp, 0.0f));
  // where the pixel's depth is not zp, the entry is not its winner
  if (PASS == 2 && bits != sh.depth[p]) return;
  if (!(zp >= 0.0f && zp <= 1.0f)) return;
  const float w1 = __fadd_rn(__fmul_rn(en.w1x, dx), __fmul_rn(en.w1y, dy));
  const float w2 = __fadd_rn(__fmul_rn(en.w2x, dx), __fmul_rn(en.w2y, dy));
  if ((w1 >= 0.0f) && (w2 >= 0.0f) && (__fadd_rn(w1, w2) <= 1.0f)) {
    if (PASS == 1) {
      atomicMin(sh.depth + p, bits);
    } else {
      atomicMax(sh.win + p, key);
    }
  }
}

// K4: entry `en` at tile-local pixel (lx, ly), whose centre is (px, py).
// PASS 1 lowers the pixel's biased depth and its sample depths; PASS 2 (the
// depths final) raises `win` to `key` where the entry's candidate is the
// pixel's depth.
template <int PASS>
__device__ __forceinline__ void ms_pixel(const Entry& en, int lx, int ly,
                                         float px, float py,
                                         const TileShared& sh,
                                         unsigned long long key) {
  const int p = ly * TILE_W + lx;
  const float dx = __fsub_rn(px, en.ax);
  const float dy = __fsub_rn(py, en.ay);
  const float w1 = __fadd_rn(__fmul_rn(en.w1x, dx), __fmul_rn(en.w1y, dy));
  const float w2 = __fadd_rn(__fmul_rn(en.w2x, dx), __fmul_rn(en.w2y, dy));
  const float zp = __fadd_rn(__fadd_rn(en.z0, __fmul_rn(en.zx, dx)),
                             __fmul_rn(en.zy, dy));
  if (PASS == 2) {
    // the candidate is zp + 0 or zp + 2: where the pixel's depth is neither,
    // the entry is not its winner, whatever it covers
    const unsigned d = sh.depth[p];
    if (d != __float_as_uint(__fadd_rn(zp, 0.0f))
        && d != __float_as_uint(__fadd_rn(zp, 2.0f)))
      return;
  }
  bool any = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float w1s = __fadd_rn(w1, en.dw1[k]);
    const float w2s = __fadd_rn(w2, en.dw2[k]);
    const bool cov = (w1s >= 0.0f) && (w2s >= 0.0f)
                     && (__fadd_rn(w1s, w2s) <= 1.0f);
    any = any || cov;
    if (PASS == 1 && cov) {
      const float zs = __fadd_rn(zp, en.dz[k]);
      if (zs >= 0.0f) {
        const unsigned bits = __float_as_uint(__fadd_rn(zs, 0.0f));  // -0: +0
        atomicMin(sh.sd + k * TILE_PIX + p, bits);
      }
    }
  }
  if (any && zp >= 0.0f && zp <= 1.0f) {
    const bool centre = (w1 >= 0.0f) && (w2 >= 0.0f)
                        && (__fadd_rn(w1, w2) <= 1.0f);
    // zp + 0 folds -0 into +0, like the sample depths
    const unsigned bits =
        __float_as_uint(__fadd_rn(zp, centre ? 0.0f : 2.0f));
    if (PASS == 1) {
      atomicMin(sh.depth + p, bits);
    } else {
      if (bits == sh.depth[p]) atomicMax(sh.win + p, key);
    }
  }
}

// K1/K6/K5c: entry `en` at tile-local pixel (lx, ly), whose centre is
// (px, py), in the order of the plain version. Lowers the
// pixel's depth where the entry covers the centre with zp >= 0 (no zp <= 1
// test: the clear at 1.0 implies it).
__device__ __forceinline__ void depth_pixel(const Entry& en, int lx, int ly,
                                            float px, float py,
                                            const TileShared& sh) {
  const float dx = __fsub_rn(px, en.ax);
  const float dy = __fsub_rn(py, en.ay);
  const float zp = __fadd_rn(__fadd_rn(en.z0, __fmul_rn(en.zx, dx)),
                             __fmul_rn(en.zy, dy));
  if (!(zp >= 0.0f)) return;
  const float w1 = __fadd_rn(__fmul_rn(en.w1x, dx), __fmul_rn(en.w1y, dy));
  const float w2 = __fadd_rn(__fmul_rn(en.w2x, dx), __fmul_rn(en.w2y, dy));
  if ((w1 >= 0.0f) && (w2 >= 0.0f) && (__fadd_rn(w1, w2) <= 1.0f)) {
    // zp + 0 folds -0 into +0
    const unsigned bits = __float_as_uint(__fadd_rn(zp, 0.0f));
    atomicMin(sh.depth + ly * TILE_W + lx, bits);
  }
}

template <int KIND, int PASS>
__device__ __forceinline__ void tile_pixel(const Entry& en, int lx, int ly,
                                           float px, float py,
                                           const TileShared& sh,
                                           unsigned long long key) {
  if constexpr (KIND == MSAA)
    ms_pixel<PASS>(en, lx, ly, px, py, sh, key);
  else if constexpr (KIND == CENTRE)
    centre_pixel<PASS>(en, lx, ly, px, py, sh, key);
  else
    depth_pixel(en, lx, ly, px, py, sh);
}

// Entry `en` over its clamped box, by one thread alone (a small box).
template <int KIND, int PASS, int TH>
__device__ __forceinline__ void walk_thread(const Entry& en, int ty, int tx,
                                            const TileShared& sh,
                                            unsigned long long key) {
  for (int ly = en.y0; ly <= en.y1; ++ly) {
    const float py = (float)(ty * TH + ly) + 0.5f;
    for (int lx = en.x0; lx <= en.x1; ++lx)
      tile_pixel<KIND, PASS>(en, lx, ly, (float)(tx * TILE_W + lx) + 0.5f,
                             py, sh, key);
  }
}

// Entry `en` over its clamped box, shared by `step` threads (a wide box):
// thread `first` of them takes the box pixels first, first + step, ... in
// row-major order.
template <int KIND, int PASS, int TH>
__device__ __forceinline__ void walk_shared(const Entry& en, int first,
                                            int step, int ty, int tx,
                                            const TileShared& sh,
                                            unsigned long long key) {
  const int bw = en.x1 - en.x0 + 1;
  const int n = bw * (en.y1 - en.y0 + 1);
  for (int i = first; i < n; i += step) {
    const int q = i / bw;
    const int lx = en.x0 + (i - q * bw);
    const int ly = en.y0 + q;
    tile_pixel<KIND, PASS>(en, lx, ly, (float)(tx * TILE_W + lx) + 0.5f,
                           (float)(ty * TH + ly) + 0.5f, sh, key);
  }
}

__device__ __forceinline__ unsigned long long tile_key(int tid, int local) {
  return (static_cast<unsigned long long>(tid + 1) << 32)
         | static_cast<unsigned>(local + 1);
}

// One pass over the tile's entries [start, start + count), a chunk of one
// entry per thread at a time (the block takes chunks part, part + parts,
// ... where `parts` blocks share the tile): each thread takes one entry,
// walks its box itself when it holds at most `wide_box` pixels and queues
// it otherwise.
// The queued entries are then shared: one of at most BLOCK_BOX pixels goes
// to one warp (the warps take them in turn), its 32 lanes striding over the
// box; a larger one (up to the whole tile) to all the threads of the block.
// All of them update the same shared state with the same order-free
// atomics, so the split changes no bit. Ends with a barrier (where count >
// 0).
template <int KIND, int PASS, int TH = TILE_H>
__device__ __forceinline__ void tile_entries(const float* __restrict__ rows,
                                             const short4* __restrict__ boxes,
                                             int row_w, int start, int count,
                                             int ty, int tx, int wide_box,
                                             const TileShared& sh,
                                             int part = 0, int parts = 1) {
  constexpr int NT = Body<KIND, TH>::threads;
  constexpr bool MS = KIND == MSAA;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Entry en;
  for (int c0 = part * NT; c0 < count; c0 += parts * NT) {
    if (threadIdx.x == 0) *sh.n_wide = 0;
    __syncthreads();
    const int local = c0 + threadIdx.x;
    if (local < count) {
      const int n = entry_box<TH>(boxes, start + local, ty, tx, en);
      if (n > wide_box)
        sh.wide[atomicAdd(sh.n_wide, 1)] = local;
      else if (n > 0 && entry_planes<MS>(rows, row_w, start + local, en))
        walk_thread<KIND, PASS, TH>(en, ty, tx, sh, tile_key(en.tid, local));
    }
    __syncthreads();
    const int n_wide = *sh.n_wide;
    for (int i = 0; i < n_wide; ++i) {
      const int wl = sh.wide[i];
      const bool whole_block =
          entry_box<TH>(boxes, start + wl, ty, tx, en) > BLOCK_BOX;
      if (!whole_block && i % (NT / 32) != warp) continue;
      if (!entry_planes<MS>(rows, row_w, start + wl, en)) continue;
      if (whole_block)
        walk_shared<KIND, PASS, TH>(en, threadIdx.x, NT, ty, tx, sh,
                                    tile_key(en.tid, wl));
      else
        walk_shared<KIND, PASS, TH>(en, lane, 32, ty, tx, sh,
                                    tile_key(en.tid, wl));
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float plane_over(float c, float cx, float cy,
                                            float dx, float dy, float den) {
  return __fdiv_rn(__fadd_rn(__fadd_rn(c, __fmul_rn(cx, dx)),
                             __fmul_rn(cy, dy)), den);
}

// b1, b2 and the attributes at pixel centre (px, py), offset o, from the
// winning entry `win` (zeros where win < 0), as K2 and K4 write them. VEC:
// the winner's row is read with aligned float4 loads, lanes 0..7, then from
// lane 16 the 1/w plane and the attributes' planes (attribute a at lanes
// 19 + 3a .. 21 + 3a), four attributes to three loads; rows are 16-byte
// aligned and a multiple of 4 lanes (`tile_rows_ok`), so no load leaves
// the row. Else lane by lane: the crowd kernels K5a and K5b, whose winners
// are mostly sub-pixel entries of a pixel each, measured faster so
// (scripts/probe_torch_raster_ms.py). Same arithmetic either way.
template <bool VEC>
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
    const float4* r = reinterpret_cast<const float4*>(rw);
    float dx, dy;
    if constexpr (VEC) {
      const float4 a = __ldg(r);              // ax ay w1x w1y
      const float4 b = __ldg(r + 1);          // w2x w2y z0 zx
      dx = __fsub_rn(px, a.x);
      dy = __fsub_rn(py, a.y);
      w1 = __fadd_rn(__fmul_rn(a.z, dx), __fmul_rn(a.w, dy));
      w2 = __fadd_rn(__fmul_rn(b.x, dx), __fmul_rn(b.y, dy));
    } else {
      dx = __fsub_rn(px, rw[0]);
      dy = __fsub_rn(py, rw[1]);
      w1 = __fadd_rn(__fmul_rn(rw[2], dx), __fmul_rn(rw[3], dy));
      w2 = __fadd_rn(__fmul_rn(rw[4], dx), __fmul_rn(rw[5], dy));
    }
    if (n_attrs > 0 && VEC) {
      const float4* q = r + BASE_WIDTH / 4;
      const float4 h = __ldg(q);              // lanes 16..19
      float den = __fadd_rn(__fadd_rn(h.x, __fmul_rn(h.y, dx)),
                            __fmul_rn(h.z, dy));
      den = fabsf(den) > 1e-9f ? den : 1.0f;
      float c0 = h.w;          // lane 19 + 12g: attribute 4g's first lane
      for (int g = 0; 4 * g < n_attrs; ++g) {
        // attributes 4g .. 4g + 3 hold lanes 19 + 12g .. 30 + 12g
        const int left = n_attrs - 4 * g;
        const float4 u = __ldg(q + 1 + 3 * g);               // 20 + 12g ..
        const float4 v = left > 1 ? __ldg(q + 2 + 3 * g) : u;  // 24 + 12g ..
        const float4 w = left > 3 ? __ldg(q + 3 + 3 * g) : u;  // 28 + 12g ..
        float* out = attr + static_cast<size_t>(4 * g) * plane + o;
        out[0] = plane_over(c0, u.x, u.y, dx, dy, den);
        if (left > 1) out[plane] = plane_over(u.z, u.w, v.x, dx, dy, den);
        if (left > 2) out[2 * plane] = plane_over(v.y, v.z, v.w, dx, dy, den);
        if (left > 3) out[3 * plane] = plane_over(w.x, w.y, w.z, dx, dy, den);
        c0 = w.w;
      }
    } else if (n_attrs > 0) {
      const float* p = rw + BASE_WIDTH;
      float den = __fadd_rn(__fadd_rn(p[0], __fmul_rn(p[1], dx)),
                            __fmul_rn(p[2], dy));
      den = fabsf(den) > 1e-9f ? den : 1.0f;
      for (int a = 0; a < n_attrs; ++a) {
        const float* q = p + 3 + 3 * a;
        attr[a * plane + o] = plane_over(q[0], q[1], q[2], dx, dy, den);
      }
    }
  } else {
    for (int a = 0; a < n_attrs; ++a) attr[a * plane + o] = 0.0f;
  }
  if (n_attrs == 0) attr[o] = 0.0f;
  b1[o] = w1;
  b2[o] = w2;
}

// The tile's planes from its final state: per pixel the depth (K4's
// un-biased), the winner's triangle id (-1: nothing but the clear) and b1,
// b2 and the attributes from the winner's row. A thread owns one column and
// TILE_PIX / threads rows: coalesced stores. VEC as in write_winner.
template <bool MS, bool VEC>
__device__ __forceinline__ void write_tile(
    const float* __restrict__ rows, int row_w, int n_attrs, int start, int ty,
    int tx, const TileShared& sh, float* __restrict__ depth,
    int* __restrict__ tri, float* __restrict__ b1, float* __restrict__ b2,
    float* __restrict__ attr, int pad_h, int pad_w) {
  constexpr int RPT = TILE_PIX / Body<MS ? MSAA : CENTRE>::threads;
  const int col = threadIdx.x % TILE_W;
  const int row0 = (threadIdx.x / TILE_W) * RPT;
  const size_t plane = static_cast<size_t>(pad_h) * pad_w;
  const size_t base = static_cast<size_t>(ty * TILE_H + row0) * pad_w
                      + tx * TILE_W + col;
  const float px = (float)(tx * TILE_W + col) + 0.5f;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int p = (row0 + r) * TILE_W + col;
    const size_t o = base + static_cast<size_t>(r) * pad_w;
    const unsigned long long key = sh.win[p];
    const bool won = key != 0ull;
    const float d = __uint_as_float(sh.depth[p]);
    // K2: the clear 1.0 where nothing won
    depth[o] = !MS ? d : (!won ? 1.0f : (d > 1.5f ? __fsub_rn(d, 2.0f) : d));
    tri[o] = won ? (int)(key >> 32) - 1 : -1;
    const int win = won ? start + (int)(key & 0xffffffffull) - 1 : -1;
    write_winner<VEC>(rows, row_w, n_attrs, win, px,
                      (float)(ty * TILE_H + row0 + r) + 0.5f, o, plane, b1,
                      b2, attr);
  }
}

// One tile of K2/K5a: tile (ty, tx) of one instance's frame, whose entries
// are [starts[gid], starts[gid] + counts[gid]); the output planes are that
// instance's. Every thread of the block calls it. VEC as in write_winner.
template <bool VEC>
__device__ __forceinline__ void raster_tile(
    const int* __restrict__ starts, const int* __restrict__ counts,
    const float* __restrict__ rows, const short4* __restrict__ boxes,
    int row_w, int n_attrs, int gid, int ty, int tx, int wide_box,
    float* __restrict__ depth, int* __restrict__ tri,
    float* __restrict__ b1, float* __restrict__ b2, float* __restrict__ attr,
    int pad_h, int pad_w, unsigned char* smem) {
  const TileShared sh = tile_shared<CENTRE>(smem);
  const int start = starts[gid];
  const int count = counts[gid];

  // the clear: depth 1.0 and no winner. It takes part in the tie rule like
  // an entry, so an entry at exactly zp = 1 still wins its pixels.
  for (int i = threadIdx.x; i < TILE_PIX; i += CENTRE_THREADS) {
    sh.depth[i] = __float_as_uint(1.0f);
    sh.win[i] = 0ull;
  }
  // (the first barrier of tile_entries orders the clears before the updates)
  tile_entries<CENTRE, 1>(rows, boxes, row_w, start, count, ty, tx, wide_box,
                          sh);
  // the winning entry: among the entries whose zp equals the pixel's depth,
  // the larger triangle id, then the larger entry index (what the plain
  // version's max over id * span + index picks)
  tile_entries<CENTRE, 2>(rows, boxes, row_w, start, count, ty, tx, wide_box,
                          sh);
  __syncthreads();
  write_tile<false, VEC>(rows, row_w, n_attrs, start, ty, tx, sh, depth,
                         tri, b1, b2, attr, pad_h, pad_w);
}

__global__ void __launch_bounds__(CENTRE_THREADS)
raster_tiles_kernel(const int* __restrict__ starts,
                    const int* __restrict__ counts,
                    const float* __restrict__ rows,
                    const short4* __restrict__ boxes, int row_w, int n_attrs,
                    int tiles_x, int wide_box, float* __restrict__ depth,
                    int* __restrict__ tri, float* __restrict__ b1,
                    float* __restrict__ b2, float* __restrict__ attr,
                    int pad_h, int pad_w) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int t = blockIdx.x;
  const int ty = t / tiles_x;
  raster_tile<true>(starts, counts, rows, boxes, row_w, n_attrs, t, ty,
                    t - ty * tiles_x, wide_box, depth, tri, b1, b2, attr,
                    pad_h, pad_w, tile_smem);
}

// K5a: block i takes tile i % inst_tiles of instance i / inst_tiles;
// starts/counts are indexed by the global tile i, pixel coordinates come
// from the local tile, every output plane is offset by the instance.
__global__ void __launch_bounds__(CENTRE_THREADS)
raster_tiles_multi_kernel(const int* __restrict__ starts,
                          const int* __restrict__ counts,
                          const float* __restrict__ rows,
                          const short4* __restrict__ boxes, int row_w,
                          int n_attrs, int inst_tiles, int tiles_x,
                          int wide_box, float* __restrict__ depth,
                          int* __restrict__ tri, float* __restrict__ b1,
                          float* __restrict__ b2, float* __restrict__ attr,
                          int pad_h, int pad_w) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int g = blockIdx.x;
  const int inst = g / inst_tiles;
  const int local = g - inst * inst_tiles;
  const int ty = local / tiles_x;
  const size_t o = static_cast<size_t>(inst) * pad_h * pad_w;
  raster_tile<false>(starts, counts, rows, boxes, row_w, n_attrs, g, ty,
                     local - ty * tiles_x, wide_box, depth + o, tri + o,
                     b1 + o, b2 + o, attr + o * max(n_attrs, 1), pad_h, pad_w,
                     tile_smem);
}

// One tile of K4/K5b: tile (ty, tx) of one instance's frame, whose entries
// are [starts[gid], starts[gid] + counts[gid]); the output planes are that
// instance's. Every thread of the block calls it. VEC as in write_winner.
template <bool VEC>
__device__ __forceinline__ void raster_tile_ms(
    const int* __restrict__ starts, const int* __restrict__ counts,
    const float* __restrict__ rows, const short4* __restrict__ boxes,
    int row_w, int n_attrs, int gid, int ty, int tx, int wide_box,
    float* __restrict__ depth, int* __restrict__ tri,
    float* __restrict__ b1, float* __restrict__ b2, float* __restrict__ attr,
    float* __restrict__ sdepth, int pad_h, int pad_w, unsigned char* smem) {
  constexpr int RPT = TILE_PIX / MS_THREADS;
  const TileShared sh = tile_shared<MSAA>(smem);
  const int start = starts[gid];
  const int count = counts[gid];

  // the biased clear (3.0; no winner) and the sample clear (1.0)
  for (int i = threadIdx.x; i < TILE_PIX; i += MS_THREADS)
    sh.depth[i] = __float_as_uint(3.0f);
  for (int i = threadIdx.x; i < 4 * TILE_PIX; i += MS_THREADS)
    sh.sd[i] = __float_as_uint(1.0f);
  // (the first barrier of tile_entries orders the clears before the updates)
  tile_entries<MSAA, 1>(rows, boxes, row_w, start, count, ty, tx, wide_box,
                        sh);
  __syncthreads();

  // the sample depths, as write_tile lays its planes out
  const int col = threadIdx.x % TILE_W;
  const int row0 = (threadIdx.x / TILE_W) * RPT;
  const size_t plane = static_cast<size_t>(pad_h) * pad_w;
  const size_t base = static_cast<size_t>(ty * TILE_H + row0) * pad_w
                      + tx * TILE_W + col;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int p = (row0 + r) * TILE_W + col;
    const size_t o = base + static_cast<size_t>(r) * pad_w;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      sdepth[k * plane + o] = __uint_as_float(sh.sd[k * TILE_PIX + p]);
  }
  __syncthreads();

  // the winning entry: among the entries whose candidate equals the pixel's
  // depth, the larger triangle id, then the larger entry index (what the
  // plain version's max over id * span + index picks). 0: only the clear.
  for (int i = threadIdx.x; i < TILE_PIX; i += MS_THREADS) sh.win[i] = 0ull;
  tile_entries<MSAA, 2>(rows, boxes, row_w, start, count, ty, tx, wide_box,
                        sh);
  __syncthreads();
  write_tile<true, VEC>(rows, row_w, n_attrs, start, ty, tx, sh, depth, tri,
                        b1, b2, attr, pad_h, pad_w);
}

__global__ void __launch_bounds__(MS_THREADS)
raster_tiles_ms_kernel(const int* __restrict__ starts,
                       const int* __restrict__ counts,
                       const float* __restrict__ rows,
                       const short4* __restrict__ boxes, int row_w,
                       int n_attrs, int tiles_x, int wide_box,
                       float* __restrict__ depth, int* __restrict__ tri,
                       float* __restrict__ b1, float* __restrict__ b2,
                       float* __restrict__ attr, float* __restrict__ sdepth,
                       int pad_h, int pad_w) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int t = blockIdx.x;
  const int ty = t / tiles_x;
  raster_tile_ms<true>(starts, counts, rows, boxes, row_w, n_attrs, t, ty,
                       t - ty * tiles_x, wide_box, depth, tri, b1, b2, attr,
                       sdepth, pad_h, pad_w, tile_smem);
}

// K5b: K4 over the instance x tile grid (see raster_tiles_multi_kernel).
__global__ void __launch_bounds__(MS_THREADS)
raster_tiles_ms_multi_kernel(const int* __restrict__ starts,
                             const int* __restrict__ counts,
                             const float* __restrict__ rows,
                             const short4* __restrict__ boxes, int row_w,
                             int n_attrs, int inst_tiles, int tiles_x,
                             int wide_box, float* __restrict__ depth,
                             int* __restrict__ tri, float* __restrict__ b1,
                             float* __restrict__ b2, float* __restrict__ attr,
                             float* __restrict__ sdepth, int pad_h,
                             int pad_w) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int g = blockIdx.x;
  const int inst = g / inst_tiles;
  const int local = g - inst * inst_tiles;
  const int ty = local / tiles_x;
  const size_t o = static_cast<size_t>(inst) * pad_h * pad_w;
  raster_tile_ms<false>(starts, counts, rows, boxes, row_w, n_attrs, g, ty,
                        local - ty * tiles_x, wide_box, depth + o, tri + o,
                        b1 + o, b2 + o, attr + o * max(n_attrs, 1),
                        sdepth + o * 4, pad_h, pad_w, tile_smem);
}

// One tile of K1/K6/K5c: tile (ty, tx) of the TH x TILE_W grid, whose
// entries are [starts[gid], starts[gid] + counts[gid]) with their pixel
// boxes. The least zp >= 0 of the entries covering each pixel centre,
// cleared to 1.0. Every thread of the tile's cluster (CLUSTER blocks) calls
// it. The leader (rank 0) holds the tile's state; block r takes the chunks
// r, r + CLUSTER, ... of the entries and lowers the leader's state through
// distributed shared memory. A tile without entries needs no state and no
// barrier: its leader stores the clear, the other blocks leave.
template <int TH, int CLUSTER>
__device__ __forceinline__ void depth_tile(
    const int* __restrict__ starts, const int* __restrict__ counts,
    const float* __restrict__ rows, const short4* __restrict__ boxes,
    int row_w, int gid, int ty, int tx, int wide_box,
    float* __restrict__ depth, int pad_w, unsigned char* smem) {
  using B = Body<DEPTH, TH>;
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int count = counts[gid];
  TileShared sh = tile_shared<DEPTH, TH>(smem);
  const uint4* own = reinterpret_cast<const uint4*>(sh.depth);
  if (count > 0) {
    if (rank == 0) {
      for (int i = threadIdx.x; i < B::pix; i += B::threads)
        sh.depth[i] = __float_as_uint(1.0f);
    } else {
      sh.depth = cluster.map_shared_rank(sh.depth, 0);
    }
    cluster.sync();   // the clear before any update
    tile_entries<DEPTH, 1, TH>(rows, boxes, row_w, starts[gid], count, ty,
                               tx, wide_box, sh, rank, CLUSTER);
    // every update before the store; the leader's state outlives them
    cluster.sync();
  }
  if (rank != 0) return;
  // the tile out, four pixels a thread at a time: a warp stores 512
  // consecutive bytes of a row (pad_w is a multiple of TILE_W, the map
  // 16-byte aligned)
  const unsigned one = __float_as_uint(1.0f);
  for (int i = threadIdx.x; i < B::pix / 4; i += B::threads) {
    const int r = i / (TILE_W / 4);
    const int c = i - r * (TILE_W / 4);
    const size_t o = static_cast<size_t>(ty * TH + r) * pad_w
                     + tx * TILE_W + 4 * c;
    *reinterpret_cast<uint4*>(depth + o) =
        count > 0 ? own[i] : make_uint4(one, one, one, one);
  }
}

// K1: cluster t (blocks DEPTH_CLUSTER * t ...) takes tile t.
__global__ void __cluster_dims__(DEPTH_CLUSTER, 1, 1)
__launch_bounds__(DEPTH_THREADS)
depth_tiles_kernel(const int* __restrict__ starts,
                   const int* __restrict__ counts,
                   const float* __restrict__ rows,
                   const short4* __restrict__ boxes, int row_w, int tiles_x,
                   int wide_box, float* __restrict__ depth, int pad_w) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int t = blockIdx.x / DEPTH_CLUSTER;
  const int ty = t / tiles_x;
  depth_tile<TILE_H, DEPTH_CLUSTER>(starts, counts, rows, boxes, row_w, t,
                                    ty, t - ty * tiles_x, wide_box, depth,
                                    pad_w, tile_smem);
}

// K6: cluster i takes tile i of the window (row-major over its tile
// columns); the window (first tile row, first tile column, tile rows, tile
// columns) is read on the card, so the grid covers every tile of the map
// and the clusters past the window's tile count exit at once. Tile
// coordinates and starts/counts are the full grid's, so a window tile gets
// K1's bits.
template <int TH>
__global__ void __cluster_dims__(DEPTH_CLUSTER, 1, 1)
__launch_bounds__(DEPTH_THREADS)
depth_tiles_win_kernel(const int* __restrict__ window,
                       const int* __restrict__ starts,
                       const int* __restrict__ counts,
                       const float* __restrict__ rows,
                       const short4* __restrict__ boxes, int row_w,
                       int n_tiles, int tiles_x, int wide_box,
                       float* __restrict__ depth, int pad_w) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int tw = max(window[3], 0);
  const int i = blockIdx.x / DEPTH_CLUSTER;
  if (i >= max(window[2], 0) * tw) return;
  const int ty = window[0] + i / tw;
  const int tx = window[1] + i % tw;
  if (ty < 0 || tx < 0 || tx >= tiles_x || ty * tiles_x + tx >= n_tiles)
    return;
  depth_tile<TH, DEPTH_CLUSTER>(starts, counts, rows, boxes, row_w,
                                ty * tiles_x + tx, ty, tx, wide_box, depth,
                                pad_w, tile_smem);
}

// K5c: K1's body over the instance x tile grid: cluster g (blocks
// CROWD_DEPTH_CLUSTER * g ...) reads the bins of the global tile g, takes
// its pixel coordinates from the local tile g % inst_tiles and writes the
// map of instance g / inst_tiles (see raster_tiles_multi_kernel), so a
// crowd tile gets K1's bits on the same bins and boxes.
__global__ void __cluster_dims__(CROWD_DEPTH_CLUSTER, 1, 1)
__launch_bounds__(DEPTH_THREADS)
depth_tiles_multi_kernel(const int* __restrict__ starts,
                         const int* __restrict__ counts,
                         const float* __restrict__ rows,
                         const short4* __restrict__ boxes, int row_w,
                         int inst_tiles, int tiles_x, int wide_box,
                         float* __restrict__ depth, int pad_h, int pad_w) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int g = blockIdx.x / CROWD_DEPTH_CLUSTER;
  const int inst = g / inst_tiles;
  const int local = g - inst * inst_tiles;
  const int ty = local / tiles_x;
  depth_tile<TILE_H, CROWD_DEPTH_CLUSTER>(
      starts, counts, rows, boxes, row_w, g, ty, local - ty * tiles_x,
      wide_box, depth + static_cast<size_t>(inst) * pad_h * pad_w, pad_w,
      tile_smem);
}

}  // namespace

// Whether the boxed bodies (K1, K2, K4, K6 and the crowd's K5a, K5b, K5c)
// take these rows: lanes 0..11 and the winner's planes are read as aligned
// float4 loads, so a row is a multiple of 4 lanes at a 16-byte address.
static bool tile_rows_ok(const void* rows, int row_w, int n_attrs) {
  return n_attrs >= 0 && n_attrs <= MAX_ATTRS && row_w >= 12
         && row_w % 4 == 0 && reinterpret_cast<size_t>(rows) % 16 == 0
         && (n_attrs == 0 || row_w >= BASE_WIDTH + 3 + 3 * n_attrs);
}

// K1. starts: i32 [n_tiles + 1]; counts: i32 [n_tiles]; rows: f32 [E,
// row_w]; boxes: i16 [E, 4] and wide_box as smr_raster_tiles takes them;
// depth: f32 [pad_h, pad_w] with pad_h = tiles_y * 32, pad_w = tiles_x *
// 128, at a 16-byte address. Returns cudaGetLastError() after the launch.
// A cluster of DEPTH_CLUSTER blocks per tile; the depth bodies' shared
// memory stays under the 48 KB default.
extern "C" int smr_depth_tiles(const void* starts, const void* counts,
                               const void* rows, const void* boxes,
                               int row_w, int n_tiles, int tiles_x,
                               int wide_box, void* depth, int pad_w,
                               void* stream) {
  if (n_tiles <= 0) return 0;
  if (!tile_rows_ok(rows, row_w, 0) || reinterpret_cast<size_t>(depth) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  depth_tiles_kernel<<<n_tiles * DEPTH_CLUSTER, DEPTH_THREADS,
                       Body<DEPTH>::shared,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const float*>(rows), static_cast<const short4*>(boxes),
      row_w, tiles_x, wide_box, static_cast<float*>(depth), pad_w);
  return static_cast<int>(cudaGetLastError());
}

// Let `kernel` take the dynamic shared memory of its body (over 48 KB).
template <int KIND, typename Kernel>
static cudaError_t allow_shared(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Body<KIND>::shared));
}

// K2. starts: i32 [n_tiles + 1]; counts: i32 [n_tiles]; rows: f32 [E,
// row_w] (BASE_WIDTH + 3 + 3 * n_attrs lanes when n_attrs > 0); boxes: i16
// [E, 4] (each entry's first column, first row, last column, last row in
// the frame, inclusive; the kernel clamps them to the tile); wide_box: the
// most pixels of a clamped box that one thread walks alone. Outputs depth,
// b1, b2: f32 [pad_h, pad_w], tri: i32 [pad_h, pad_w], attr: f32
// [max(n_attrs, 1), pad_h, pad_w].
extern "C" int smr_raster_tiles(const void* starts, const void* counts,
                                const void* rows, const void* boxes,
                                int row_w, int n_attrs, int n_tiles,
                                int tiles_x, int wide_box, void* depth,
                                void* tri, void* b1, void* b2, void* attr,
                                int pad_h, int pad_w, void* stream) {
  if (n_tiles <= 0) return 0;
  if (!tile_rows_ok(rows, row_w, n_attrs))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = allow_shared<CENTRE>(raster_tiles_kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  raster_tiles_kernel<<<n_tiles, CENTRE_THREADS, Body<CENTRE>::shared,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const float*>(rows), static_cast<const short4*>(boxes),
      row_w, n_attrs, tiles_x, wide_box, static_cast<float*>(depth),
      static_cast<int*>(tri), static_cast<float*>(b1),
      static_cast<float*>(b2), static_cast<float*>(attr), pad_h, pad_w);
  return static_cast<int>(cudaGetLastError());
}

// K4: as smr_raster_tiles, plus sdepth: f32 [4, pad_h, pad_w].
extern "C" int smr_raster_tiles_ms(const void* starts, const void* counts,
                                   const void* rows, const void* boxes,
                                   int row_w, int n_attrs, int n_tiles,
                                   int tiles_x, int wide_box, void* depth,
                                   void* tri, void* b1, void* b2, void* attr,
                                   void* sdepth, int pad_h, int pad_w,
                                   void* stream) {
  if (n_tiles <= 0) return 0;
  if (!tile_rows_ok(rows, row_w, n_attrs))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = allow_shared<MSAA>(raster_tiles_ms_kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  raster_tiles_ms_kernel<<<n_tiles, MS_THREADS, Body<MSAA>::shared,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const float*>(rows), static_cast<const short4*>(boxes),
      row_w, n_attrs, tiles_x, wide_box, static_cast<float*>(depth),
      static_cast<int*>(tri), static_cast<float*>(b1),
      static_cast<float*>(b2), static_cast<float*>(attr),
      static_cast<float*>(sdepth), pad_h, pad_w);
  return static_cast<int>(cudaGetLastError());
}

// K6. window: i32 [4] on the card (first tile row, first tile column, tile
// rows, tile columns); starts/counts/rows/boxes as smr_depth_tiles over
// tile_h x 128 tiles (tile_h 8 or 32); depth: f32 [tiles_y * tile_h,
// pad_w], already filled with 1.0 by the caller (only window tiles are
// written). One cluster per tile of the map.
extern "C" int smr_depth_tiles_win(const void* window, const void* starts,
                                   const void* counts, const void* rows,
                                   const void* boxes, int row_w, int n_tiles,
                                   int tiles_x, int tile_h, int wide_box,
                                   void* depth, int pad_w, void* stream) {
  if (n_tiles <= 0) return 0;
  if (!tile_rows_ok(rows, row_w, 0) || reinterpret_cast<size_t>(depth) % 16
      || (tile_h != 8 && tile_h != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<const int*>(window);
  const auto s = static_cast<const int*>(starts);
  const auto c = static_cast<const int*>(counts);
  const auto r = static_cast<const float*>(rows);
  const auto b = static_cast<const short4*>(boxes);
  const auto d = static_cast<float*>(depth);
  if (tile_h == 32)
    depth_tiles_win_kernel<32><<<n_tiles * DEPTH_CLUSTER, DEPTH_THREADS,
                                 Body<DEPTH, 32>::shared, st>>>(
            w, s, c, r, b, row_w, n_tiles, tiles_x, wide_box, d, pad_w);
  else
    depth_tiles_win_kernel<8><<<n_tiles * DEPTH_CLUSTER, DEPTH_THREADS,
                                Body<DEPTH, 8>::shared, st>>>(
            w, s, c, r, b, row_w, n_tiles, tiles_x, wide_box, d, pad_w);
  return static_cast<int>(cudaGetLastError());
}

// K5c, K5a, K5b: the crowd launchers. starts: i32 [n_inst * inst_tiles + 1]
// and counts: i32 [n_inst * inst_tiles] over the global tile
// inst * inst_tiles + tile; boxes and wide_box as the single-instance
// launchers take them; every output gains a leading instance axis:
// depth/tri/b1/b2 [n_inst, pad_h, pad_w], attr [n_inst, max(n_attrs, 1),
// pad_h, pad_w], sdepth [n_inst, 4, pad_h, pad_w]. One block per
// (instance, tile) for K5a and K5b; one cluster of CROWD_DEPTH_CLUSTER
// blocks for K5c, whose depth must lie at a 16-byte address.
extern "C" int smr_depth_tiles_multi(const void* starts, const void* counts,
                                     const void* rows, const void* boxes,
                                     int row_w, int n_inst, int inst_tiles,
                                     int tiles_x, int wide_box, void* depth,
                                     int pad_h, int pad_w, void* stream) {
  if (n_inst <= 0 || inst_tiles <= 0) return 0;
  if (!tile_rows_ok(rows, row_w, 0) || reinterpret_cast<size_t>(depth) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  depth_tiles_multi_kernel<<<n_inst * inst_tiles * CROWD_DEPTH_CLUSTER,
                             DEPTH_THREADS, Body<DEPTH>::shared,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const float*>(rows), static_cast<const short4*>(boxes),
      row_w, inst_tiles, tiles_x, wide_box, static_cast<float*>(depth),
      pad_h, pad_w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int smr_raster_tiles_multi(const void* starts, const void* counts,
                                      const void* rows, const void* boxes,
                                      int row_w, int n_attrs, int n_inst,
                                      int inst_tiles, int tiles_x,
                                      int wide_box, void* depth, void* tri,
                                      void* b1, void* b2, void* attr,
                                      int pad_h, int pad_w, void* stream) {
  if (n_inst <= 0 || inst_tiles <= 0) return 0;
  if (!tile_rows_ok(rows, row_w, n_attrs))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = allow_shared<CENTRE>(raster_tiles_multi_kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  raster_tiles_multi_kernel<<<n_inst * inst_tiles, CENTRE_THREADS,
                              Body<CENTRE>::shared,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const float*>(rows), static_cast<const short4*>(boxes),
      row_w, n_attrs, inst_tiles, tiles_x, wide_box,
      static_cast<float*>(depth), static_cast<int*>(tri),
      static_cast<float*>(b1), static_cast<float*>(b2),
      static_cast<float*>(attr), pad_h, pad_w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int smr_raster_tiles_ms_multi(const void* starts,
                                         const void* counts, const void* rows,
                                         const void* boxes, int row_w,
                                         int n_attrs, int n_inst,
                                         int inst_tiles, int tiles_x,
                                         int wide_box, void* depth, void* tri,
                                         void* b1, void* b2, void* attr,
                                         void* sdepth, int pad_h, int pad_w,
                                         void* stream) {
  if (n_inst <= 0 || inst_tiles <= 0) return 0;
  if (!tile_rows_ok(rows, row_w, n_attrs))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = allow_shared<MSAA>(raster_tiles_ms_multi_kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  raster_tiles_ms_multi_kernel<<<n_inst * inst_tiles, MS_THREADS,
                                 Body<MSAA>::shared,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const float*>(rows), static_cast<const short4*>(boxes),
      row_w, n_attrs, inst_tiles, tiles_x, wide_box,
      static_cast<float*>(depth), static_cast<int*>(tri),
      static_cast<float*>(b1), static_cast<float*>(b2),
      static_cast<float*>(attr), static_cast<float*>(sdepth), pad_h, pad_w);
  return static_cast<int>(cudaGetLastError());
}
