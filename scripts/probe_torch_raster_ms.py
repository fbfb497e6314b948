"""Where the hand-written kernels' time goes: variants of their sources,
timed.

    python3 scripts/probe_torch_raster_ms.py [--only base,no_walk,...]
        [--parent DIR]

The machine with the card has no kernel profiler, so this script takes the
three boxed tile bodies of `csrc/tiled_raster.cu` apart - the
centre-sampled raster (`raster_tile`: K2, K5a), the MSAA one
(`raster_tile_ms`: K4, K5b) and the depth body (`depth_tile`: K1, K6,
K5c), which share their entry walks (the two rasters their epilogue too) -
and the PCF stencil of `csrc/shadow_pcf.cu` (K3), by building VARIANTS of a
source (a few lines substituted, compiled beside the real library with the
same flags) and timing each on the arguments the kernels get in frame 1 of
their paths, as `chip_smoke.py` captures them: K1, K2 and K3 in the
flagship scene at msaa=1, K6 and K4 at msaa=4 + shadow_window (1920x1080,
shadow map 2048^2), K5c, K5a and K3 (its [64,256,256] batch of maps,
"K3crowd") in the 64-instance crowd at density 2.0 at msaa=1 (256x144,
shadow maps 256^2), K5b at msaa=4. A variant of one source times only the
kernels of that source. Some variants compute the same function another
way (their outputs must equal the real kernels', bit for bit); the others
leave a phase out, give wrong pictures, and only tell what that phase
costs:

  base           the sources as they are
  threads_512    512 threads a block (two blocks on an SM) instead of 1,024,
                 in both raster bodies
  depth_threads_512, depth_threads_1024
                 the depth body with 512 or 1,024 threads a block instead
                 of 256
  depth_cluster_1, depth_cluster_2, depth_cluster_4
                 a K1/K6 tile over a cluster of 1, 2 or 4 blocks instead of
                 8 (1: one block a tile, no distributed shared memory)
  depth_cluster_1_t1024
                 one block of 1,024 threads a tile
  crowd_cluster_1, crowd_cluster_2, crowd_cluster_4, crowd_cluster_8
                 a K5c tile over a cluster of 1, 2, 4 or 8 blocks (one of
                 them is the source's CROWD_DEPTH_CLUSTER)
  read_first     a plain read of the shared value before each atomicMin, the
                 atomic made only where it would lower it (the raster
                 bodies; depth_read_first the depth body)
  scalar_gather  every kernel's epilogue reads the winner's row lane by
                 lane (the source: the crowd kernels K5a, K5b)
  float4_gather  every kernel's epilogue reads it with float4 loads (the
                 source: K2, K4)
  own_pixels     (K2, K5a) no gather: a third walk in which the entry that
                 won a pixel writes its b1, b2 and attributes into a staging
                 tile in shared memory (5 planes, 80 KB: three attributes,
                 as these frames carry), stored with coalesced writes
  no_walk        entries loaded and set up, boxes never walked (every
                 body: the small boxes, a thread each)
  no_pass2       no second pass (no winner: the epilogue gathers no row)
  no_passes      neither pass: the clears and the output planes only
  no_gather      both passes, but the epilogue gathers no winner's row
  pcf_rows_4, pcf_rows_16, pcf_rows_32
                 K3 with strips of 4, 16 or 32 rows a thread (PCF_ROWS)
  pcf_warps_x_1, pcf_warps_x_4, pcf_warps_y_2, pcf_warps_y_8
                 K3 blocks of 1 or 4 warps across, 2 or 8 strips down
  pcf_scalar     K3 with one column a thread (the variant the launcher
                 takes for S not a multiple of 4 or unaligned maps) at
                 every shape
  parent         (with --parent DIR) K3 as the checkout DIR builds it:
                 `DIR/simple_mmd_renderer_tpu_torch/csrc/shadow_pcf.cu`,
                 whose entry point takes the same arguments

Each time is the least of 6 means of 20 launches run back to back
(`chip_smoke.primed_ms`: CUDA events, the stream held by a sleep kernel
while the host queues the launches, so that a kernel shorter than its
wrapper's Python is not timed at the host's pace), the timer of the
kernels' record (`chip_smoke.back_to_back_runs`); two rounds over all
variants show drift. K1, K2, K4 and K5c on empty bins (every count
0) are printed as the floor of a launch at that frame size. `build_variants`,
`capture` and `use` serve scripts/tune_torch_raster_ms.py too.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import re
import subprocess
import sys

import torch

WALK = ("        walk_thread<KIND, PASS, TH>(en, ty, tx, sh, "
        "tile_key(en.tid, local));")


def _pass(ms: bool, n: int) -> str:
    """The source's call of pass n of one raster body."""
    kind = "MSAA" if ms else "CENTRE"
    pad = " " * (len(kind) + 20)
    return (f"  tile_entries<{kind}, {n}>(rows, boxes, "
            f"row_w, start, count, ty, tx, wide_box,\n{pad}sh);")


PASSES = {n: [(_pass(ms, n), "") for ms in (False, True)] for n in (1, 2)}

# the epilogue's read of the winner's row: the VEC template argument of
# write_winner chooses float4 loads (K2, K4) or lane by lane (K5a, K5b)
GATHER = ("template <bool VEC>\n__device__ __forceinline__ void "
          "write_winner(")

# own_pixels: the centre body's state gains a staging tile of 5 planes, the
# entry carries its row, and a third pass writes the winners' planes
OWN_SHARED = ("  static constexpr size_t shared =\n"
              "      sizeof(unsigned) * (words * pix + threads + 4);")
OWN_SHARED_NEW = OWN_SHARED[:-1] + " + (KIND == CENTRE ? 5 * pix * 4 : 0);"
OWN_PIXEL = """// the own_pixels probe: the winner of pixel p writes its planes
__device__ __forceinline__ void own_pixel(const Entry& en, int p, float px,
                                          float py, const TileShared& sh,
                                          unsigned long long key) {
  if (key != sh.win[p]) return;
  float* st = reinterpret_cast<float*>(sh.n_wide + 4) + p;
  const float dx = __fsub_rn(px, en.ax);
  const float dy = __fsub_rn(py, en.ay);
  st[0] = __fadd_rn(__fmul_rn(en.w1x, dx), __fmul_rn(en.w1y, dy));
  st[TILE_PIX] = __fadd_rn(__fmul_rn(en.w2x, dx), __fmul_rn(en.w2y, dy));
  const float* q = en.row + BASE_WIDTH;
  float den = __fadd_rn(__fadd_rn(q[0], __fmul_rn(q[1], dx)),
                        __fmul_rn(q[2], dy));
  den = fabsf(den) > 1e-9f ? den : 1.0f;
  for (int a = 0; a < 3; ++a)
    st[(2 + a) * TILE_PIX] = __fdiv_rn(
        __fadd_rn(__fadd_rn(q[3 + 3 * a], __fmul_rn(q[4 + 3 * a], dx)),
                  __fmul_rn(q[5 + 3 * a], dy)), den);
}

template <int PASS>
__device__ __forceinline__ void centre_pixel("""
OWN_WRITE = """  __syncthreads();
  write_tile<false, VEC>(rows, row_w, n_attrs, start, ty, tx, sh, depth,
                         tri, b1, b2, attr, pad_h, pad_w);"""
OWN_WRITE_NEW = """  tile_entries<CENTRE, 3>(rows, boxes, row_w, start, count, ty, tx,
                          wide_box, sh);
  __syncthreads();
  const float* st = reinterpret_cast<const float*>(sh.n_wide + 4);
  constexpr int RPT = TILE_PIX / CENTRE_THREADS;
  const int col = threadIdx.x % TILE_W;
  const int row0 = (threadIdx.x / TILE_W) * RPT;
  const size_t plane = static_cast<size_t>(pad_h) * pad_w;
  const size_t base = static_cast<size_t>(ty * TILE_H + row0) * pad_w
                      + tx * TILE_W + col;
  for (int r = 0; r < RPT; ++r) {
    const int p = (row0 + r) * TILE_W + col;
    const size_t o = base + static_cast<size_t>(r) * pad_w;
    const unsigned long long key = sh.win[p];
    const bool won = key != 0ull;
    depth[o] = __uint_as_float(sh.depth[p]);
    tri[o] = won ? (int)(key >> 32) - 1 : -1;
    b1[o] = won ? st[p] : 0.0f;
    b2[o] = won ? st[TILE_PIX + p] : 0.0f;
    for (int a = 0; a < n_attrs; ++a)
      attr[a * plane + o] = won ? st[(2 + a) * TILE_PIX + p] : 0.0f;
    if (n_attrs == 0) attr[o] = 0.0f;
  }"""

DEPTH_ATOMIC = "    atomicMin(sh.depth + ly * TILE_W + lx, bits);"
DEPTH_CLUSTER = "constexpr int DEPTH_CLUSTER = 8;"
CROWD_CLUSTER = "constexpr int CROWD_DEPTH_CLUSTER = 1;"

# name -> (substitutions, whether the outputs must equal the real kernels')
VARIANTS = {
    "base": ([], True),
    "threads_512": ([("constexpr int CENTRE_THREADS = 1024;",
                      "constexpr int CENTRE_THREADS = 512;"),
                     ("constexpr int MS_THREADS = 1024;",
                      "constexpr int MS_THREADS = 512;")], True),
    "depth_threads_512": ([("constexpr int DEPTH_THREADS = 256;",
                            "constexpr int DEPTH_THREADS = 512;")], True),
    "depth_threads_1024": ([("constexpr int DEPTH_THREADS = 256;",
                             "constexpr int DEPTH_THREADS = 1024;")], True),
    "depth_cluster_1": ([(DEPTH_CLUSTER, "constexpr int DEPTH_CLUSTER = 1;")],
                        True),
    "depth_cluster_2": ([(DEPTH_CLUSTER, "constexpr int DEPTH_CLUSTER = 2;")],
                        True),
    "depth_cluster_4": ([(DEPTH_CLUSTER, "constexpr int DEPTH_CLUSTER = 4;")],
                        True),
    "depth_cluster_1_t1024": ([
        (DEPTH_CLUSTER, "constexpr int DEPTH_CLUSTER = 1;"),
        ("constexpr int DEPTH_THREADS = 256;",
         "constexpr int DEPTH_THREADS = 1024;")], True),
    **{f"crowd_cluster_{n}": ([(CROWD_CLUSTER, "constexpr int "
                                 f"CROWD_DEPTH_CLUSTER = {n};")], True)
       for n in (1, 2, 4, 8)},
    "depth_read_first": ([(DEPTH_ATOMIC, "    if (bits < sh.depth[ly * TILE_W "
                           "+ lx])\n  " + DEPTH_ATOMIC)], True),
    "read_first": ([
        ("        atomicMin(sh.sd + k * TILE_PIX + p, bits);",
         "        if (bits < sh.sd[k * TILE_PIX + p])\n"
         "          atomicMin(sh.sd + k * TILE_PIX + p, bits);"),
        ("      atomicMin(sh.depth + p, bits);",
         "      if (bits < sh.depth[p]) atomicMin(sh.depth + p, bits);")],
        True),
    "scalar_gather": ([(GATHER, GATHER.replace(
        "<bool VEC>", "<bool VEC_, bool VEC = false>"))], True),
    "float4_gather": ([("  raster_tile<false>(", "  raster_tile<true>("),
                       ("  raster_tile_ms<false>(",
                        "  raster_tile_ms<true>(")], True),
    "own_pixels": ([
        (OWN_SHARED, OWN_SHARED_NEW),
        ("  int tid;\n  float dw1[4]", "  int tid;\n  const float* row;\n"
         "  float dw1[4]"),
        ("  en.tid = (int)c.z;                        // lane 10\n",
         "  en.tid = (int)c.z;                        // lane 10\n"
         "  en.row = rows + static_cast<size_t>(e) * row_w;\n"),
        ("template <int PASS>\n__device__ __forceinline__ void centre_pixel(",
         OWN_PIXEL),
        ("  const int p = ly * TILE_W + lx;\n"
         "  const float dx = __fsub_rn(px, en.ax);\n"
         "  const float dy = __fsub_rn(py, en.ay);\n"
         "  const float zp",
         "  const int p = ly * TILE_W + lx;\n"
         "  if (PASS == 3) {\n"
         "    own_pixel(en, p, px, py, sh, key);\n"
         "    return;\n"
         "  }\n"
         "  const float dx = __fsub_rn(px, en.ax);\n"
         "  const float dy = __fsub_rn(py, en.ay);\n"
         "  const float zp"),
        (OWN_WRITE, OWN_WRITE_NEW)], True),
    # the walk behind a test no row passes, so that the loads stay
    "no_walk": ([(WALK, "        if (en.ax + en.w1x + en.w2x + en.z0 + en.zy "
                  "== 1.2345e30f)\n  " + WALK)], False),
    "no_pass2": (PASSES[2], False),
    "no_passes": (PASSES[1] + PASSES[2], False),
    "no_gather": ([("    const int win = won ? start + (int)(key & "
                    "0xffffffffull) - 1 : -1;", "    const int win = -1;")],
                  False),
}
# K3's variants, of csrc/shadow_pcf.cu
PCF_SELECT = "  const bool vec = s % 4 == 0"
PCF_VARIANTS = {
    **{f"pcf_rows_{n}": ([("constexpr int PCF_ROWS = 8;",
                           f"constexpr int PCF_ROWS = {n};")], True)
       for n in (4, 16, 32)},
    **{f"pcf_warps_{axis}_{n}": ([(f"constexpr int PCF_WARPS_{axis.upper()} "
                                   f"= {was};",
                                   f"constexpr int PCF_WARPS_{axis.upper()} "
                                   f"= {n};")], True)
       for axis, was, ns in (("x", 2, (1, 4)), ("y", 4, (2, 8)))
       for n in ns},
    "pcf_scalar": ([(PCF_SELECT, "  const bool vec = false && s % 4 == 0")],
                   True),
}

# per source: its variants, the entry points a variant library replaces,
# the kernels whose registers are reported, the captured cases it times
SOURCES = {
    "tiled_raster.cu": (
        VARIANTS,
        ("smr_raster_tiles", "smr_raster_tiles_multi", "smr_raster_tiles_ms",
         "smr_raster_tiles_ms_multi", "smr_depth_tiles",
         "smr_depth_tiles_win", "smr_depth_tiles_multi"),
        ("raster_tiles_kernel", "raster_tiles_multi_kernel",
         "raster_tiles_ms_kernel", "raster_tiles_ms_multi_kernel",
         "depth_tiles_kernel", "depth_tiles_win_kernel",
         "depth_tiles_multi_kernel"),
        ("K1", "K2", "K6", "K4", "K5c", "K5a", "K5b")),
    "shadow_pcf.cu": (
        PCF_VARIANTS, ("smr_pcf_lit_map",), ("pcf_lit_map_kernel",),
        ("K3", "K3crowd")),
}


def source_of(name: str) -> str | None:
    """The source file variant `name` edits (None: base, every source)."""
    if name == "base":
        return None
    if name == "parent":
        return "shadow_pcf.cu"
    return next(src for src, (vs, *_) in SOURCES.items() if name in vs)


def variant_source(source: str, name: str) -> str:
    """`source` (the text of the file variant `name` edits) with the
    variant's substitutions."""
    text = source
    if name == "base":
        return text
    for old, new in SOURCES[source_of(name)][0][name][0]:
        if old not in text:
            raise RuntimeError(f"variant {name}: the source no longer holds "
                               f"{old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants(names, out="build/probe", parent=None):
    """Compile each variant into its own library (nvcc -Xptxas -v, all at
    once; `base` from every source; `parent` from the checkout `parent`'s
    shadow_pcf.cu) -> {name: (ctypes handles, {kernel: (registers, spill
    bytes)})}."""
    from simple_mmd_renderer_tpu_torch.ops import _build

    os.makedirs(out, exist_ok=True)
    jobs = []
    for name in names:
        src = source_of(name)
        for file in SOURCES if src is None else (src,):
            if name == "parent":
                text = open(os.path.join(parent, "simple_mmd_renderer_tpu_"
                                         "torch", "csrc", file)).read()
            else:
                text = (_build.CSRC / file).read_text()
                if src is not None:
                    text = variant_source(text, name)
            stem = f"{name}_{file[:-3]}"
            cu = os.path.join(out, f"{stem}.cu")
            with open(cu, "w") as f:
                f.write(text)
            so = os.path.abspath(os.path.join(out, f"{stem}.so"))
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                   so, cu]
            jobs.append((name, file, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    built = {}
    for name, file, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed:\n{log[-3000:]}")
        _, entries, kernels, _ = SOURCES[file]
        found = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) bytes "
                           r"spill stores.*?Used (\d+) registers", log, re.S)
        regs = {k: (int(r), int(sp)) for k in kernels
                for fn, sp, r in found if f"{len(k)}{k}" in fn}
        handle = ctypes.CDLL(so)
        for n in entries:
            fn = getattr(handle, n)
            fn.argtypes, fn.restype = _build.SIGNATURES[n], ctypes.c_int
        handles, all_regs = built.setdefault(name, ({}, {}))
        handles[file] = handle
        all_regs.update(regs)
    return built


def capture(pcf=False):
    """{"K1"|"K2"|"K6"|"K4"|"K5c"|"K5a"|"K5b": (wrapper, args)} from frame
    1 of each path, boxes included; with `pcf` also K3's: "K3" on the
    msaa=1 flagship's map, "K3crowd" on the crowd's batch of maps."""
    import chip_smoke as cs
    from simple_mmd_renderer_tpu_torch.core.scene import build_sample_scene
    from simple_mmd_renderer_tpu_torch.ops import shadow_pcf
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    out = {}
    for msaa in (False, True):
        scene = build_sample_scene(cs.DENSITY, cs.WIDTH, cs.HEIGHT, cs.SHADOW,
                                   "cuda", **(cs.MSAA_PATH if msaa else {}))
        _, _, seen = cs.capture_frame(scene.step_and_render,
                                      scene.init_state(),
                                      cs.path_kernels(msaa))
        for key in cs.path_kernels(msaa)[:2]:     # (K6, K4) or (K1, K2)
            out[key] = seen[key][0]
        if not msaa:
            out["K3"] = seen["K3"][0]
    crowd = cs.build_crowd(cs.DENSITY, "crowd-dense")
    for msaa, key in ((False, "K5a"), (True, "K5b")):
        step, state = crowd[msaa]
        _, _, seen = cs.capture_frame(step, state, cs.crowd_kernels(msaa))
        out[key] = seen[key][0]
        if not msaa:
            out["K5c"] = seen["K5c"][0]
            out["K3crowd"] = seen["K3"][0]
    fns = {"K1": tr.depth_tiles, "K6": tr.depth_tiles_win,
           "K2": tr.raster_tiles, "K5a": tr.raster_tiles_multi,
           "K4": tr.raster_tiles_ms, "K5b": tr.raster_tiles_ms_multi,
           "K5c": tr.depth_tiles_multi}
    if pcf:
        fns.update(K3=shadow_pcf.pcf_lit_map, K3crowd=shadow_pcf.pcf_lit_map)
    return {k: (fns[k], out[k]) for k in fns}


@contextlib.contextmanager
def use(handles):
    """The wrappers launch the entry points of `handles` ({source file:
    library}, as build_variants gives them) inside the block."""
    from simple_mmd_renderer_tpu_torch.ops import _build

    lib = _build.lib()
    names = [n for file in handles for n in SOURCES[file][1]]
    real = {n: getattr(lib, n) for n in names}
    try:
        for file, handle in handles.items():
            for n in SOURCES[file][1]:
                setattr(lib, n, getattr(handle, n))
        yield
    finally:
        for n in names:
            setattr(lib, n, real[n])


def best(fn) -> float:
    import chip_smoke as cs

    return min(cs.primed_ms(fn, 20) for _ in range(6))


def _planes(out):
    """A kernel's output as a tuple of planes (K1, K6, K5c, K3 give one
    map)."""
    return out if isinstance(out, tuple) else (out,)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join([*VARIANTS, *PCF_VARIANTS]))
    ap.add_argument("--out", default="build/probe")
    ap.add_argument("--parent", default=None,
                    help="a checkout whose K3 is timed as variant `parent`")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_raster_ms: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    names = list(dict.fromkeys(opts.only.split(",")))
    if opts.parent:
        names.append("parent")
    print(cs.smi_name_power(), flush=True)
    cases = capture(pcf=True)
    built = build_variants(names, opts.out, opts.parent)
    want = {k: fn(*args) for k, (fn, args) in cases.items()}
    empty = {k: (args[0], args[1] * 0, args[2] * 0) + tuple(args[3:])
             for k, (_, args) in cases.items()
             if k in ("K1", "K2", "K4", "K5c")}
    for rnd in range(2):
        for name, (handles, regs) in built.items():
            src = source_of(name)
            mine = {k: v for k, v in cases.items()
                    if src is None or k in SOURCES[src][3]}
            exact = name in ("base", "parent") or SOURCES[src][0][name][1]
            with use(handles):
                same = {k: all(torch.equal(a, b) for a, b in
                               zip(_planes(fn(*args)), _planes(want[k])))
                        for k, (fn, args) in mine.items()}
                if exact and not all(same.values()):
                    raise AssertionError(f"variant {name} changes the bits: "
                                         f"{same}")
                times = {k: best(lambda: fn(*args))
                         for k, (fn, args) in mine.items()}
                floors = {k: best(lambda: cases[k][0](*e))
                          for k, e in empty.items() if k in mine}
            print(f"round {rnd}, {name}: "
                  + ", ".join(f"{k} {t:.4f} ms" for k, t in times.items())
                  + "; on empty bins "
                  + ", ".join(f"{k} {t:.4f} ms" for k, t in floors.items())
                  + f"; same bits as the real kernels: {same}; registers, "
                  f"spill bytes {regs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
