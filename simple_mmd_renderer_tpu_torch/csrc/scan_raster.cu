// KS: the exact scan raster's body (`ops/tiled_raster.scan_raster`).
//
// It replaces no Pallas kernel: the reference's scan raster
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
// Design: one thread owns one pixel of one instance and applies the test
// sequentially in registers, so the result is exact with no atomics. A
// block of SCAN_BW x SCAN_BH pixels stages the per-triangle setup (computed
// by the wrapper) in draw order, SCAN_STAGE triangles at a time: each
// thread tests one triangle's pixel box (`_pixel_boxes` at extent 0, the
// same boxes K2 culls with) and valid flag against the block's pixel
// rectangle, and the hits are compacted into shared memory in draw order
// (warp ballots and a prefix over the warps' counts), with their edge
// deltas precomputed. The block then walks only the hits. A triangle
// outside a pixel's box cannot cover it (the rounding argument of
// `_pixel_boxes`), so skipping it changes no bit.
//
// Bound: per pixel, the arithmetic of every triangle whose box holds it
// (fp32 operations), and the bytes of the setup table plus the output
// planes. What the design does about it: the box test runs once per block
// and triangle, in parallel over the block's threads, so a pixel pays only
// for the triangles that can reach its block.
//
// Every product and sum is rounded separately (__fmul_rn / __fadd_rn /
// __fsub_rn, and the library is built with --fmad=false), in the plain
// version's order, so KS agrees bit for bit with `scan_raster_plain`.

#include <cuda_runtime.h>

namespace {

constexpr int SCAN_BW = 16;                    // block: pixel columns
constexpr int SCAN_BH = 16;                    // block: pixel rows
constexpr int SCAN_THREADS = SCAN_BW * SCAN_BH;
constexpr int SCAN_STAGE = SCAN_THREADS;       // triangles staged at once
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

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

// table: f32 [n_inst, n, 16] per triangle (x0, y0, x1, y1 | x2, y2, z0, z1
// | z2, inv_area, valid, 0 | box c0, r0, c1, r1); depth f32, tri i32
// [n_inst, h, w], bary f32 [n_inst, h, w, 2], read and written in place.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_raster_kernel(const float4* __restrict__ table, int n, int w, int h,
                   float* __restrict__ depth, int* __restrict__ tri,
                   float2* __restrict__ bary) {
  __shared__ Staged staged[SCAN_STAGE];
  __shared__ int staged_id[SCAN_STAGE];
  __shared__ int warp_hits[SCAN_WARPS];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int x0 = blockIdx.x * SCAN_BW;
  const int y0 = blockIdx.y * SCAN_BH;
  const int x = x0 + t % SCAN_BW;
  const int y = y0 + t / SCAN_BW;
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

  for (int base = 0; base < n; base += SCAN_STAGE) {
    const int k = base + t;
    bool hit = false;
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (k < n) {
      c = tab[4 * static_cast<size_t>(k) + 2];
      const float4 box = tab[4 * static_cast<size_t>(k) + 3];
      hit = c.z > 0.0f && box.x <= rx1 && box.z >= rx0 && box.y <= ry1
            && box.w >= ry0;
    }
    const unsigned ballot = __ballot_sync(FULL, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int i = 0; i < SCAN_WARPS; ++i) {
      const int m = warp_hits[i];
      offset += i < warp ? m : 0;
      total += m;
    }
    if (hit) {
      const int slot = offset + __popc(ballot & ((1u << lane) - 1u));
      const float4 a = tab[4 * static_cast<size_t>(k)];
      const float4 b = tab[4 * static_cast<size_t>(k) + 1];
      // vertices (a.x, a.y), (a.z, a.w), (b.x, b.y)
      staged[slot].e12 = make_edge(a.z, a.w, b.x, b.y);
      staged[slot].e20 = make_edge(b.x, b.y, a.x, a.y);
      staged[slot].e01 = make_edge(a.x, a.y, a.z, a.w);
      staged[slot].zi = make_float4(b.z, b.w, c.x, c.y);
      staged_id[slot] = k;
    }
    __syncthreads();
    for (int j = 0; j < total; ++j) {
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
    __syncthreads();   // the next stage overwrites `staged`
  }
  if (inside) {
    depth[pix] = d;
    tri[pix] = id;
    bary[pix] = make_float2(b1w, b2w);
  }
}

}  // namespace

// table: f32 [n_inst, n, 16] (see scan_raster_kernel), 16-byte aligned;
// depth f32 / tri i32 [n_inst, h, w] and bary f32 [n_inst, h, w, 2], all
// contiguous, holding the start buffer. Returns cudaGetLastError() after
// the launch.
extern "C" int smr_scan_raster(const void* table, int n, int n_inst, int w,
                               int h, void* depth, void* tri, void* bary,
                               void* stream) {
  if (n <= 0 || n_inst <= 0 || w <= 0 || h <= 0) return 0;
  if (n_inst > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + SCAN_BW - 1) / SCAN_BW, (h + SCAN_BH - 1) / SCAN_BH,
                  n_inst);
  scan_raster_kernel<<<grid, SCAN_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), n, w, h, static_cast<float*>(depth),
      static_cast<int*>(tri), static_cast<float2*>(bary));
  return static_cast<int>(cudaGetLastError());
}
