"""Where K4's and K5b's time goes: variants of the MSAA tile body, timed.

    python3 scripts/probe_torch_raster_ms.py [--only base,no_walk,...]

The machine with the card has no kernel profiler, so this script takes the
tile body apart by building VARIANTS of `csrc/tiled_raster.cu` (the source
with a few lines substituted, compiled beside the real library with the
same flags) and timing each on the arguments K4 gets in frame 1 of the
flagship scene (1920x1080, msaa=4 + shadow_window) and K5b in frame 1 of
the 64-instance crowd at density 2.0 (256x144, msaa=4), as `chip_smoke.py`
captures them. Some variants compute the same function another way (their
outputs must equal the real kernel's, bit for bit); the others leave a
phase out, give wrong pictures, and only tell what that phase costs:

  base         the source as it is
  threads_512  512 threads a block (two blocks on an SM) instead of 1,024
  read_first   a plain read of the shared value before each atomicMin, the
               atomic made only where it would lower it
  cp_async     each thread's entry (row lanes 0..11 and box) staged through
               a double buffer in shared memory with cp.async, the next
               chunk's copy in flight while this chunk is evaluated
  no_walk      entries loaded and set up, boxes never walked
  no_pass2     no second pass (no winner: the epilogue gathers no row)
  no_passes    neither pass: the clears and the output planes only
  no_gather    both passes, but the epilogue gathers no winner's row

Each time is the least of 6 means of 20 launches (CUDA events); two rounds
over all variants show drift. K4 on empty bins (every count 0) is printed
as the floor of a launch at that frame size.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

WALK = "        ms_walk_thread<PASS>(en, ty, tx, sh, ms_key(en.tid, local));"
PASS1 = ("  ms_entries<1>(rows, boxes, row_w, start, count, ty, tx, wide_box, "
         "sh);")
PASS2 = PASS1.replace("<1>", "<2>")
GENERIC_LOADS = [("__ldg(boxes + e)", "boxes[e]"), ("__ldg(r + 2)", "r[2]"),
                 ("__ldg(r);", "r[0];"), ("__ldg(r + 1)", "r[1]")]

# the thread phase of ms_entries, and the same with a thread-private
# cp.async double buffer behind the tile state
THREAD_PHASE = """  MsEntry en;
  for (int c0 = 0; c0 < count; c0 += MS_THREADS) {
    if (threadIdx.x == 0) *sh.n_wide = 0;
    __syncthreads();
    const int local = c0 + threadIdx.x;
    if (local < count) {
      const int n = ms_box(boxes, start + local, ty, tx, en);
      if (n > wide_box)
        sh.wide[atomicAdd(sh.n_wide, 1)] = local;
      else if (n > 0 && ms_planes(rows, row_w, start + local, en))"""
THREAD_PHASE_CP_ASYNC = """  MsEntry en;
  int buf = 0;
  auto prefetch = [&](int c, int b) {
    const int l = c + threadIdx.x;
    if (l < count) {
      float4* s = sh.stage + (b * MS_THREADS + threadIdx.x) * 4;
      const float* r = rows + static_cast<size_t>(start + l) * row_w;
      cp16(s, r); cp16(s + 1, r + 4); cp16(s + 2, r + 8);
      cp8(s + 3, boxes + start + l);
    }
    asm volatile("cp.async.commit_group;");
  };
  prefetch(0, 0);
  for (int c0 = 0; c0 < count; c0 += MS_THREADS, buf ^= 1) {
    if (threadIdx.x == 0) *sh.n_wide = 0;
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    prefetch(c0 + MS_THREADS, buf ^ 1);
    __syncthreads();
    const int local = c0 + threadIdx.x;
    if (local < count) {
      const float4* s = sh.stage + (buf * MS_THREADS + threadIdx.x) * 4;
      const int n = ms_box(reinterpret_cast<const short4*>(s + 3), 0, ty, tx,
                           en);
      if (n > wide_box)
        sh.wide[atomicAdd(sh.n_wide, 1)] = local;
      else if (n > 0 && ms_planes(reinterpret_cast<const float*>(s), 0, 0,
                                  en))"""
SHARED_SIZE = ("constexpr size_t MS_SHARED =\n"
               "    sizeof(unsigned) * (5 * TILE_PIX + MS_THREADS + 4);")
SHARED_SIZE_CP_ASYNC = """constexpr size_t MS_STATE =
    sizeof(unsigned) * (5 * TILE_PIX + MS_THREADS + 4);
constexpr size_t MS_SHARED = MS_STATE + 2 * MS_THREADS * 64;
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src));
}"""

# name -> (substitutions, whether the outputs must equal the real kernel's)
VARIANTS = {
    "base": ([], True),
    "threads_512": ([("constexpr int MS_THREADS = 1024;",
                      "constexpr int MS_THREADS = 512;")], True),
    "read_first": ([
        ("        atomicMin(sh.sd + k * TILE_PIX + p, bits);",
         "        if (bits < sh.sd[k * TILE_PIX + p])\n"
         "          atomicMin(sh.sd + k * TILE_PIX + p, bits);"),
        ("      atomicMin(sh.depth + p, bits);",
         "      if (bits < sh.depth[p]) atomicMin(sh.depth + p, bits);")],
        True),
    "cp_async": (GENERIC_LOADS + [
        (SHARED_SIZE, SHARED_SIZE_CP_ASYNC),
        ("  int* n_wide;\n};", "  int* n_wide;\n  float4* stage;\n};"),
        ("  sh.n_wide = sh.wide + MS_THREADS;\n",
         "  sh.n_wide = sh.wide + MS_THREADS;\n"
         "  sh.stage = reinterpret_cast<float4*>(smem + MS_STATE);\n"),
        (THREAD_PHASE, THREAD_PHASE_CP_ASYNC)], True),
    # the walk behind a test no row passes, so that the loads stay
    "no_walk": ([(WALK, "        if (en.ax + en.w1x + en.w2x + en.z0 + en.zy "
                  "+ en.dz[3] + en.dw1[2] + en.dw2[1] == 1.2345e30f)\n  "
                  + WALK)], False),
    "no_pass2": ([(PASS2, "")], False),
    "no_passes": ([(PASS1, ""), (PASS2, "")], False),
    "no_gather": ([("    const int win = won ? start + (int)(key & "
                    "0xffffffffull) - 1 : -1;", "    const int win = -1;")],
                  False),
}
ENTRY_POINTS = ("smr_raster_tiles_ms", "smr_raster_tiles_ms_multi")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(VARIANTS))
    ap.add_argument("--out", default="build/probe")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_raster_ms: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from simple_mmd_renderer_tpu_torch.core.scene import build_sample_scene
    from simple_mmd_renderer_tpu_torch.ops import _build
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    source = (_build.CSRC / "tiled_raster.cu").read_text()
    os.makedirs(opts.out, exist_ok=True)
    jobs = []
    for name in opts.only.split(","):
        text = source
        for old, new in VARIANTS[name][0]:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source no longer "
                                   f"holds {old[:60]!r}")
            text = text.replace(old, new)
        cu = os.path.join(opts.out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.abspath(os.path.join(opts.out, f"{name}.so"))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
               cu]
        jobs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))

    print(cs.smi_name_power(), flush=True)
    scene = build_sample_scene(cs.DENSITY, cs.WIDTH, cs.HEIGHT, cs.SHADOW,
                               "cuda", **cs.MSAA_PATH)
    _, _, seen = cs.capture_frame(scene.step_and_render, scene.init_state(),
                                  cs.path_kernels(True))
    k4 = seen["K4"][0]
    step, state = cs.build_crowd(cs.DENSITY, "crowd-dense")[True]
    _, _, seen = cs.capture_frame(step, state, cs.crowd_kernels(True))
    k5b = seen["K5b"][0]
    empty = (k4[0], k4[1] * 0, k4[2] * 0) + tuple(k4[3:])
    want = tr.raster_tiles_ms(*k4) + tr.raster_tiles_ms_multi(*k5b)

    lib = _build.lib()
    real = {n: getattr(lib, n) for n in ENTRY_POINTS}
    built = {}
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed:\n{log[-3000:]}")
        regs = re.findall(r"raster_tiles_ms\w*kernel.*?Used (\d+) registers",
                          log, re.S)
        handle = ctypes.CDLL(so)
        for n in ENTRY_POINTS:
            fn = getattr(handle, n)
            fn.argtypes, fn.restype = _build.SIGNATURES[n], ctypes.c_int
        built[name] = (handle, regs)

    def best(fn):
        return min(cs.cuda_ms(fn, 20) for _ in range(6))

    try:
        for rnd in range(2):
            for name, (handle, regs) in built.items():
                for n in ENTRY_POINTS:
                    setattr(lib, n, getattr(handle, n))
                got = tr.raster_tiles_ms(*k4) + tr.raster_tiles_ms_multi(*k5b)
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                if VARIANTS[name][1] and not same:
                    raise AssertionError(f"variant {name} changes the bits")
                print(f"round {rnd}, {name}: K4 "
                      f"{best(lambda: tr.raster_tiles_ms(*k4)):.4f} ms, K5b "
                      f"{best(lambda: tr.raster_tiles_ms_multi(*k5b)):.4f} "
                      f"ms, K4 on empty bins "
                      f"{best(lambda: tr.raster_tiles_ms(*empty)):.4f} ms; "
                      f"same bits as the real kernel: {same}; registers "
                      f"(K5b, K4) {regs}", flush=True)
    finally:
        for n in ENTRY_POINTS:
            setattr(lib, n, real[n])
    return 0


if __name__ == "__main__":
    sys.exit(main())
