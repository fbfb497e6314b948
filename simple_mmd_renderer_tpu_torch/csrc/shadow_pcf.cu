// K3: shadow-space 3x3 PCF lit map for the y=0 ground plane.
//
// Replaces the Pallas kernel `_pcf_kernel` of
// simple_mmd_renderer_tpu/ops/shadow_pcf.py (launched by
// `pcf_lit_map_tiled`). For every texel (row, col) of each [S,S] shadow
// map b in a batch of B, with map b's plane (z0, zc, zr) read from element
// b * plane_stride of three device arrays (a stride of 0 shares one plane,
// as the reference's unbatched call; 1 gives each map its own, as its vmap
// over batched planes):
//
//     zref  = (z0 + zc*col) + zr*row          (bias already folded into z0)
//     count = #{3x3 taps, clamped to the map's edge, with zref < depth}
//     lit   = clip(count * (1/9), 0, 1)
//
// Clamping each tap index to [0, S-1] reads exactly what the reference's
// edge pre-pad holds there, so the result is bit-identical to the plain
// PyTorch version (`pcf_lit_map_plain`). The plane arithmetic uses
// __fmul_rn/__fadd_rn in the plain version's order, so no multiply-add is
// contracted (the library is also built with --fmad=false). The taps are
// counted in an int: the plain version's float sum of nine 0/1 terms is
// exact in any order, so (float)count is the same value.
//
// What bounds it on the H100: device memory. It must read each texel once
// and write each lit value once (8 bytes a texel, 33.5 MB at S=2048 or for
// the crowd's [64,256,256]), against a few dozen integer and float
// operations a texel. Design, a row-window stencil: a thread owns V = 4
// adjacent columns (one 16-byte word a row) over a strip of PCF_ROWS
// consecutive rows of one map and walks down it with a window of three rows
// in registers. Each new row is one float4 load; the two neighbouring
// columns come from the adjacent lanes by __shfl_up_sync/__shfl_down_sync,
// and only the warp's two outer lanes load one extra value each (the index
// clamped to the map's edge). Rows clamp to the same map's edge, so no read
// crosses into another map of the batch. The output is one float4 store a
// row. The strip's loop is unrolled, so its loads are all in flight
// together. A block is PCF_WARPS_X warps wide and PCF_WARPS_Y strips tall;
// the grid covers the maps with a few blocks per SM. Where S is not a
// multiple of 4 or either base is not 16-byte aligned, the launcher runs
// the same kernel with V = 1 (one column a thread, scalar loads and
// stores). Measured back to back on an H100 at 2048^2 and [64,256,256]
// (scripts/probe_torch_raster_ms.py): strips of 8 rows in blocks of 2 x 4
// warps 0.0100-0.0107 ms, the bound's 0.0100 (the maps may stay in the L2
// from one launch to the next); strips of 4, 16 and 32 rows 0.0105-0.0113,
// 0.0126-0.0146 and 0.0170-0.0205; 1 or 4 warps across and 2 or 8 down
// within 0.0101-0.0112 but 4 across at the crowd's 256 columns, 0.0142;
// V = 1 at every shape 0.0159; the earlier design, a thread a texel with
// nine scalar loads, 0.0231-0.0234.
//
// Launches on the caller's stream, never synchronises, allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int PCF_ROWS = 8;      // rows of a thread's strip
constexpr int PCF_WARPS_X = 2;   // warps across a block (columns)
constexpr int PCF_WARPS_Y = 4;   // strips down a block (rows)
constexpr unsigned FULL = 0xffffffffu;

// One row of a thread's window: its V columns and the columns on either
// side (edge-clamped).
template <int V>
struct Row {
  float v[V + 2];   // v[0]: column c0 - 1, v[1..V]: c0 .. c0 + V - 1,
                    // v[V + 1]: column c0 + V
};

// Row `row` of map `m` (s columns) at unit `uc` (columns uc*V ..) of a row
// of `q` units. Every lane of the warp calls it (the shuffles).
template <int V>
__device__ __forceinline__ Row<V> load_row(const float* __restrict__ m,
                                           int row, int s, int uc, int q,
                                           int lane) {
  const float* p = m + static_cast<size_t>(row) * s;
  const int c0 = uc * V;
  Row<V> w;
  if constexpr (V == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p + c0));
    w.v[1] = f.x; w.v[2] = f.y; w.v[3] = f.z; w.v[4] = f.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) w.v[1 + j] = __ldg(p + c0 + j);
  }
  const float up = __shfl_up_sync(FULL, w.v[V], 1);     // lane - 1's last
  const float down = __shfl_down_sync(FULL, w.v[1], 1);  // lane + 1's first
  w.v[0] = uc == 0 ? w.v[1] : (lane == 0 ? __ldg(p + c0 - 1) : up);
  w.v[V + 1] = uc == q - 1 ? w.v[V]
                           : (lane == 31 ? __ldg(p + c0 + V) : down);
  return w;
}

// The taps of output column j (0 .. V-1) in one row of the window that lie
// beyond zref.
template <int V>
__device__ __forceinline__ int taps(const Row<V>& w, int j, float zref) {
  return (zref < w.v[j]) + (zref < w.v[j + 1]) + (zref < w.v[j + 2]);
}

template <int V>
__global__ void __launch_bounds__(32 * PCF_WARPS_X * PCF_WARPS_Y)
pcf_lit_map_kernel(const float* __restrict__ maps,
                   const float* __restrict__ z0s,
                   const float* __restrict__ zcs,
                   const float* __restrict__ zrs, int plane_stride,
                   float* __restrict__ out, int s) {
  const int q = s / V;                                   // units a row
  const int u = blockIdx.x * blockDim.x + threadIdx.x;   // this unit
  const int r0 = (blockIdx.y * blockDim.y + threadIdx.y) * PCF_ROWS;
  // (warp-uniform: a warp lies in one row of the block)
  if (r0 >= s) return;
  const int uc = min(u, q - 1);   // past the row's end: load, never store
  const int lane = threadIdx.x & 31;
  const size_t plane = static_cast<size_t>(s) * static_cast<size_t>(s);
  const float* m = maps + static_cast<size_t>(blockIdx.z) * plane;
  float* o = out + static_cast<size_t>(blockIdx.z) * plane;
  const int pb = static_cast<int>(blockIdx.z) * plane_stride;
  const float z0 = z0s[pb];   // this map's plane
  const float zc = zcs[pb];
  const float zr = zrs[pb];
  float a[V];   // z0 + zc*col of the thread's columns
#pragma unroll
  for (int j = 0; j < V; ++j)
    a[j] = __fadd_rn(z0, __fmul_rn(zc, (float)(uc * V + j)));

  Row<V> prev = load_row<V>(m, max(r0 - 1, 0), s, uc, q, lane);
  Row<V> cur = load_row<V>(m, min(r0, s - 1), s, uc, q, lane);
#pragma unroll
  for (int k = 0; k < PCF_ROWS; ++k) {
    const int row = r0 + k;
    const Row<V> next = load_row<V>(m, min(row + 1, s - 1), s, uc, q, lane);
    if (row < s && u < q) {
      const float zb = __fmul_rn(zr, (float)row);
      float lit[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float zref = __fadd_rn(a[j], zb);
        const int count = taps<V>(prev, j, zref) + taps<V>(cur, j, zref)
                          + taps<V>(next, j, zref);
        lit[j] = fminf(fmaxf(__fmul_rn((float)count, 1.0f / 9.0f), 0.0f),
                       1.0f);
      }
      float* dst = o + static_cast<size_t>(row) * s + uc * V;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(lit[0], lit[1], lit[2], lit[3]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) dst[j] = lit[j];
      }
    }
    prev = cur;
    cur = next;
  }
}

template <int V>
cudaError_t launch(const float* maps, const float* const* planes,
                   int plane_stride, float* out, int b, int s,
                   cudaStream_t stream) {
  const dim3 block(32 * PCF_WARPS_X, PCF_WARPS_Y);
  const int strips = (s + PCF_ROWS - 1) / PCF_ROWS;
  const dim3 grid((s / V + block.x - 1) / block.x,
                  (strips + block.y - 1) / block.y, b);
  pcf_lit_map_kernel<V><<<grid, block, 0, stream>>>(
      maps, planes[0], planes[1], planes[2], plane_stride, out, s);
  return cudaGetLastError();
}

}  // namespace

// maps: f32 [b, s, s] contiguous; z0, zc, zr: f32 on the device, map i's
// plane at element i * plane_stride of each (0: one plane for all, 1: [b]
// arrays); out: f32 [b, s, s]. Four columns a thread where s is a multiple
// of 4 and both bases are 16-byte aligned, else one. Returns
// cudaGetLastError() after the launch.
extern "C" int smr_pcf_lit_map(const void* maps, const void* z0,
                               const void* zc, const void* zr,
                               int plane_stride, void* out, int b, int s,
                               void* stream) {
  if (b <= 0 || s <= 0) return 0;
  if (b > 65535 || plane_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto m = static_cast<const float*>(maps);
  const float* p[3] = {static_cast<const float*>(z0),
                       static_cast<const float*>(zc),
                       static_cast<const float*>(zr)};
  const auto o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec = s % 4 == 0 && reinterpret_cast<size_t>(maps) % 16 == 0
                   && reinterpret_cast<size_t>(out) % 16 == 0;
  return static_cast<int>(vec ? launch<4>(m, p, plane_stride, o, b, s, st)
                              : launch<1>(m, p, plane_stride, o, b, s, st));
}
