"""Command-line renderer, on the card by default.

Port of `simple_mmd_renderer_tpu/app/cli.py`, the headless equivalent of
the reference app's `sokol_main` entry: arguments containing `.pmx` (or
`.pmd`) pick the model, `.vmd` the motion, `.vpd` a pose, plus flags for
the frame count, resolution and output. Renders PNG frames instead of a
window.

Usage:
    python -m simple_mmd_renderer_tpu_torch.app.cli model.pmx dance.vmd \\
        --frames 90 --out /tmp/frames --width 1280 --height 720
    python -m simple_mmd_renderer_tpu_torch.app.cli --sample --frames 30

Every flag of the reference's means the same here. `--device` (default
cuda) is the port's counterpart of the reference's platform choice: with
no card the run stops unless `--device cpu` is passed. Each frame is one
replay of the scene's compiled step (`Scene.jit_step`: a CUDA graph on the
card) and the eager render. The kernel libraries are kept in the persistent
cache of `utils.cache.enable_compilation_cache` (`<repo>/build/kernels`),
so only the first process builds them; `--warm` builds the kernels into
it, captures the step, renders one frame and exits (the counterpart of the
reference's compilation-cache warm-up). `--out` writes PNGs with the port's
own encoder (`utils/png.py`); `--gif` and `--watch` need Pillow.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import threading
import time

import numpy as np


def _pillow(flag: str):
    """PIL.Image, or an error naming Pillow and the flag that needs it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{flag} needs Pillow (the PIL package), which "
                           "is not installed") from e
    return Image


def ansi_frame(img: "np.ndarray", cols: int = 96) -> str:
    """[H,W,3] float image -> 24-bit-color half-block (U+2580) terminal
    frame: each character cell shows two vertical pixels (fg=upper,
    bg=lower). A live preview that works over any terminal, no window
    system required."""
    h, w = img.shape[:2]
    rows = max(2, (int(cols * h / w * 0.5) // 2) * 2)
    Image = _pillow("--watch")
    small = np.asarray(Image.fromarray(
        (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)).resize(
            (cols, rows), Image.BILINEAR), np.uint8)
    lines = []
    for y in range(0, rows, 2):
        cells = []
        for x in range(cols):
            tr, tg, tb = small[y, x]
            br, bg_, bb = small[y + 1, x]
            cells.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                         f"\x1b[48;2;{br};{bg_};{bb}m▀")
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


class OrbitRig:
    """Keyboard orbit camera for --watch: the headless counterpart of the
    reference's live mouse controller (LMB rotate with pitch clamped short
    of the poles, wheel zoom clamped 0.5-20 m, WASDQE fly, R reset). State
    lives host-side; the rendering takes the camera as an argument
    (`camera_override`), so steering changes no captured step."""

    def __init__(self, rcfg):
        self._home = (np.array(rcfg.camera_pos, np.float32).copy(),
                      np.array(rcfg.camera_target, np.float32).copy())
        self.reset()

    def reset(self):
        self.eye = self._home[0].copy()
        self.target = self._home[1].copy()

    def orbit(self, dyaw, dpitch):
        off = self.eye - self.target
        r = float(np.linalg.norm(off))
        yaw = float(np.arctan2(off[0], off[2])) + dyaw
        pitch = float(np.arcsin(np.clip(off[1] / max(r, 1e-6), -1.0, 1.0)))
        pitch = float(np.clip(pitch + dpitch, -1.55, 1.55))
        self.eye = self.target + r * np.array(
            [np.cos(pitch) * np.sin(yaw), np.sin(pitch),
             np.cos(pitch) * np.cos(yaw)], np.float32)

    def zoom(self, dr):
        off = self.eye - self.target
        r = float(np.linalg.norm(off))
        r2 = float(np.clip(r + dr, 0.5, 20.0))
        self.eye = self.target + off / max(r, 1e-6) * r2

    def move(self, fwd=0.0, right=0.0, up=0.0):
        f = self.target - self.eye
        f[1] = 0.0
        n = float(np.linalg.norm(f))
        f = f / n if n > 1e-6 else np.array([0, 0, 1], np.float32)
        rvec = np.array([f[2], 0.0, -f[0]], np.float32)
        d = (f * fwd + rvec * right
             + np.array([0, 1, 0], np.float32) * up).astype(np.float32)
        self.eye = self.eye + d
        self.target = self.target + d


KEY_HELP = "[arrows] orbit  [+/-] zoom  [wasdqe] fly  [r] reset  [x] quit"


def apply_keys(rig: OrbitRig, data: bytes) -> bool:
    """Apply pending key bytes to the rig; returns True on quit.

    An arrow key is 3 bytes (ESC [ X) and the poll boundary can split it;
    an incomplete trailing escape is stashed on the rig and prepended to
    the next call so fast key repeat never drops orbit presses."""
    data = getattr(rig, "_pending_keys", b"") + data
    rig._pending_keys = b""
    quit_ = False
    i = 0
    while i < len(data):
        c = data[i:i + 1]
        if c == b"\x1b" and len(data) - i < 3 \
                and data[i + 1:i + 2] in (b"", b"["):
            rig._pending_keys = data[i:]   # split escape — finish next poll
            break
        if c == b"\x1b" and data[i + 1:i + 2] == b"[":
            k = data[i + 2:i + 3]
            i += 3
            if k == b"A":
                rig.orbit(0.0, 0.12)
            elif k == b"B":
                rig.orbit(0.0, -0.12)
            elif k == b"C":
                rig.orbit(0.12, 0.0)
            elif k == b"D":
                rig.orbit(-0.12, 0.0)
            continue
        i += 1
        if c in (b"+", b"="):
            rig.zoom(-0.3)
        elif c == b"-":
            rig.zoom(0.3)
        elif c == b"w":
            rig.move(fwd=0.2)
        elif c == b"s":
            rig.move(fwd=-0.2)
        elif c == b"a":
            rig.move(right=-0.2)
        elif c == b"d":
            rig.move(right=0.2)
        elif c == b"q":
            rig.move(up=-0.2)
        elif c == b"e":
            rig.move(up=0.2)
        elif c in (b"r", b"R"):
            rig.reset()
        elif c in (b"x", b"X", b"\x03"):
            quit_ = True
    return quit_


class _RawStdin:
    """cbreak-mode stdin with non-blocking polling (restored on exit)."""

    def __enter__(self):
        import termios
        import tty
        self._termios = termios
        self.fd = sys.stdin.fileno()
        self.saved = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        return self

    def poll(self) -> bytes:
        import select
        out = b""
        while select.select([sys.stdin], [], [], 0)[0]:
            chunk = os.read(self.fd, 64)
            if not chunk:
                break
            out += chunk
        return out

    def __exit__(self, *exc):
        self._termios.tcsetattr(self.fd, self._termios.TCSADRAIN, self.saved)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="*",
                    help=".pmx model and/or .vmd motion path")
    ap.add_argument("--sample", action="store_true",
                    help="use the procedural sample character + dance")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--out", default=None, help="PNG output directory")
    ap.add_argument("--gif", default=None,
                    help="write an animated GIF (needs Pillow)")
    ap.add_argument("--use-camera", action="store_true",
                    help="drive the camera from the VMD camera track")
    ap.add_argument("--use-light", action="store_true",
                    help="drive the directional light from the VMD light "
                         "track")
    ap.add_argument("--watch", action="store_true",
                    help="live ANSI preview in the terminal while rendering "
                         "(the headless stand-in for a window; needs "
                         "Pillow)")
    ap.add_argument("--watch-cols", type=int, default=96,
                    help="terminal preview width in character cells")
    ap.add_argument("--hdr", default=None, help="equirect .hdr environment")
    ap.add_argument("--no-physics", action="store_true")
    ap.add_argument("--no-shadows", action="store_true")
    ap.add_argument("--shadow-size", type=int, default=2048)
    ap.add_argument("--msaa", type=int, default=1, choices=(1, 4),
                    help="4 = per-sample MSAA (the reference app's native "
                         "quality)")
    ap.add_argument("--sdef", action="store_true",
                    help="true spherical SDEF skinning (default is the "
                         "reference app's BDEF2 fallback)")
    ap.add_argument("--edges", action="store_true",
                    help="toon edge outlines from the PMX edge data")
    ap.add_argument("--edge-scale", type=float, default=1.0)
    ap.add_argument("--double-sided", action="store_true",
                    help="honor MAT_DOUBLE_FACE (skirts/ribbons render from "
                         "both sides)")
    ap.add_argument("--mmd-shading", action="store_true",
                    help="toon ramps + SPH/SPA sphere maps")
    ap.add_argument("--density", type=float, default=1.0,
                    help="sample mesh density")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a profile of the render loop (host and "
                         "card, torch.profiler) to DIR/trace.json, a Chrome "
                         "trace; render passes appear under their "
                         "pass_scope labels")
    ap.add_argument("--save-state", default=None, metavar="PATH",
                    help="write the sim state (time + physics) to PATH.npz "
                         "when the run ends; --resume continues from it "
                         "bit-identically")
    ap.add_argument("--save-every", type=int, default=0, metavar="N",
                    help="with --save-state: also checkpoint every N "
                         "frames (crash-safe long renders)")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="restore the sim state saved by --save-state and "
                         "continue from it")
    ap.add_argument("--pose", default=None, metavar="PATH",
                    help="apply a .vpd pose file (held for the whole run; "
                         "combined with a .vmd, it fills bones/morphs the "
                         "motion does not key)")
    ap.add_argument("--warm", action="store_true",
                    help="build the kernels (into the persistent cache of "
                         "utils.cache.enable_compilation_cache: later "
                         "processes load them without compiling), capture "
                         "the compiled step, render one frame and exit")
    ap.add_argument("--device", default="cuda",
                    help="the device to render on (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    return ap.parse_args(argv)


def _device(name: str):
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return dev


def build_scene(args, dev):
    """The Scene the command line describes (`parse_args`), on `dev`: the
    model and motion (or the sample), the pose, the render and physics
    settings, the skybox, the camera and light tracks, the MMD maps."""
    from ..config import AppConfig, RenderConfig
    from ..core import anim as anim_mod
    from ..core import model as model_mod
    from ..core import physics as phys_mod
    from ..core.scene import Scene
    from ..formats import pmx as pmx_mod
    from ..formats import vmd as vmd_mod
    from ..formats.hdr import load_hdr
    from ..formats.textures import load_material_textures
    from ..render import ibl

    model_path = next((p for p in args.paths
                       if ".pmx" in p.lower() or ".pmd" in p.lower()), None)
    motion_path = next((p for p in args.paths if ".vmd" in p.lower()), None)

    if args.sample or model_path is None:
        from .sample import sample_character, sample_motion
        print("using procedural sample character")
        pm = sample_character(args.density)
        motion = sample_motion(args.frames * 2)
        textures = None
        model_dir = "."
    else:
        print(f"loading model: {model_path}")
        if ".pmd" in model_path.lower():
            from ..formats.pmd import load_pmd
            pm = load_pmd(model_path)
        else:
            pm = pmx_mod.load_pmx(model_path)
        model_dir = os.path.dirname(os.path.abspath(model_path))
        motion = vmd_mod.load_vmd(motion_path) if motion_path else None
        textures = True

    pose_path = args.pose or next(
        (p for p in args.paths if ".vpd" in p.lower()), None)
    if pose_path:
        from ..formats.vpd import load_vpd
        vpd = load_vpd(pose_path)
        if motion is None:
            motion = vpd
            print(f"holding pose from {pose_path} "
                  f"({len(vpd.bone_tracks)} bones, "
                  f"{len(vpd.morph_tracks)} morphs)")
        else:
            added = sum(
                motion.bone_tracks.setdefault(n, t) is t
                for n, t in vpd.bone_tracks.items()) + sum(
                motion.morph_tracks.setdefault(n, t) is t
                for n, t in vpd.morph_tracks.items())
            print(f"pose {pose_path}: filled {added} tracks the motion "
                  f"does not key")

    static = model_mod.build_model(pm)
    print(f"model '{static.name}': {len(static.positions)} verts, "
          f"{len(static.triangles)} tris, {static.n_bones} bones, "
          f"{len(pm.rigid_bodies)} bodies, {len(pm.constraints)} joints")

    part_textures = (load_material_textures(static, model_dir)
                     if textures else None)
    mo = anim_mod.bind_motion(static, motion) if motion else None
    ps = phys_mod.build_physics(static)

    cfg = AppConfig()
    cfg.render = RenderConfig(width=args.width, height=args.height,
                              shadow_map_size=args.shadow_size,
                              shadows_enabled=not args.no_shadows,
                              msaa=args.msaa, show_edges=args.edges,
                              edge_scale=args.edge_scale,
                              double_sided=args.double_sided)
    cfg.physics.enabled = not args.no_physics
    cfg.sdef_true = args.sdef

    cubemap = None
    if args.hdr and os.path.isfile(args.hdr):
        print(f"loading HDR environment: {args.hdr}")
        cubemap = ibl.equirect_to_cubemap(load_hdr(args.hdr),
                                          cfg.render.cubemap_size,
                                          device=dev)
    else:
        cfg.render.show_skybox = cubemap is not None

    camera = None
    if args.use_camera and motion is not None and motion.camera is not None:
        from ..render.camera_anim import bind_camera
        camera = bind_camera(motion.camera, device=dev)
        print("camera driven by VMD camera track")
    light = None
    if args.use_light and motion is not None and motion.light is not None:
        from ..render.camera_anim import bind_light
        light = bind_light(motion.light, device=dev)
        print("light driven by VMD light track")
    mmd_maps = None
    if args.mmd_shading:
        from ..formats.textures import load_sphere_maps, load_toon_ramps
        sph, modes = load_sphere_maps(static, model_dir)
        mmd_maps = (sph, modes, load_toon_ramps(static, model_dir))
        print("MMD extended shading: toon ramps + sphere maps")
    return Scene(static, ps, mo, cfg, part_textures, cubemap, camera, light,
                 mmd_maps, device=dev)


def main(argv=None):
    args = parse_args(argv)
    dev = _device(args.device)

    import torch

    from ..utils.cache import enable_compilation_cache
    from ..utils.png import write_png

    enable_compilation_cache()

    scene = build_scene(args, dev)
    cfg = scene.config
    state = scene.init_state()
    if args.resume:
        from ..utils.checkpoint import load_state
        state = load_state(args.resume, state)
        print(f"resumed sim state from {args.resume} "
              f"(t={float(state.time):.3f}s)")
    # --watch on a tty gets the live orbit camera (keyboard counterpart of
    # the reference's mouse controller); the camera is an argument of the
    # rendering, after the same captured step
    interactive = args.watch and sys.stdin.isatty() and scene.camera is None
    base_step = scene.jit_step(render=True)
    if interactive:
        rig = OrbitRig(cfg.render)
        fov = float(cfg.render.camera_fov_deg)

        def step(s):
            return base_step(s, camera_override=(rig.eye, rig.target, fov))
    else:
        step = base_step

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    print(f"building kernels and capturing the step for "
          f"{args.width}x{args.height} on {dev}...")
    t0 = time.time()
    # The first frame builds the kernels (one nvcc per source) and captures
    # the step as a CUDA graph; keep a heartbeat printing so that a slow
    # build does not read as a hang.
    done = threading.Event()

    def heartbeat():
        while not done.wait(15.0):
            print(f"  ... still building and capturing ({time.time() - t0:.0f}"
                  "s elapsed; the first kernel build can take a minute)",
                  flush=True)

    hb = threading.Thread(target=heartbeat, daemon=True)
    hb.start()
    try:
        if dev.type == "cuda":
            from ..ops import _build
            _build.lib()
        state, image = step(state)
        sync()
    finally:
        done.set()
    print(f"first frame (kernel build + graph capture): "
          f"{time.time() - t0:.1f}s")
    if args.warm:
        print("kernels built and step captured; exiting (--warm)")
        return 0

    if args.out:
        os.makedirs(args.out, exist_ok=True)

    gif_frames = []
    # live frame statistics: rolling fps / frame-ms shown in the --watch
    # footer and in the final summary. tick() is called where the frame is
    # read on the host, so the numbers reflect real frame delivery.
    from ..utils.profiling import FrameStats, trace
    stats = FrameStats(window=60)

    def save(i, img):
        if args.out or args.gif or args.watch:
            frame = img.cpu().numpy()
            pixels = (frame * 255).astype(np.uint8)
            if args.out:
                write_png(os.path.join(args.out, f"frame_{i:05d}.png"),
                          pixels)
            if args.gif:
                gif_frames.append(_pillow("--gif").fromarray(pixels))
            if args.watch:
                # home the cursor and repaint in place (clear once up front)
                prefix = "\x1b[2J\x1b[H" if i == 0 else "\x1b[H"
                hud = (f"frame {i:5d}  {stats.fps:6.1f} fps  "
                       f"{stats.frame_ms:6.1f} ms/frame")
                tail = ("\n" + hud + "  " + KEY_HELP + "\n") if interactive \
                    else ("\n" + hud + "\n")
                sys.stdout.write(prefix + ansi_frame(frame, args.watch_cols)
                                 + tail)
                sys.stdout.flush()
        stats.tick()

    def checkpoint(i, force=False):
        # `state` is the compiled step's own buffer: saved here, before the
        # next step overwrites it
        if args.save_state and (force or (args.save_every
                                          and i % args.save_every == 0)):
            from ..utils.checkpoint import save_state
            save_state(args.save_state, state)

    save(0, image)
    t0 = time.time()
    tracer = trace(args.trace) if args.trace else contextlib.nullcontext()
    with tracer:
        if interactive:
            with _RawStdin() as keys:
                for i in range(1, args.frames):
                    if apply_keys(rig, keys.poll()):
                        break
                    state, image = step(state)
                    save(i, image)
                    checkpoint(i)
        else:
            for i in range(1, args.frames):
                state, image = step(state)
                save(i, image)
                checkpoint(i)
        sync()
    dt = time.time() - t0
    n = max(args.frames - 1, 1)
    print(f"{n} frames in {dt:.2f}s -> {n / dt:.1f} fps"
          + (f" (rolling: {stats.fps:.1f} fps, {stats.frame_ms:.1f} "
             f"ms/frame)" if stats.times else ""))
    if args.trace:
        print(f"profile written to {args.trace}")
    checkpoint(args.frames - 1, force=True)
    if args.save_state:
        print(f"sim state saved to {args.save_state} "
              f"(t={float(state.time):.3f}s); continue with "
              f"--resume {args.save_state}")
    if args.gif and gif_frames:
        gif_frames[0].save(args.gif, save_all=True,
                           append_images=gif_frames[1:],
                           duration=int(1000 / 30), loop=0)
        print(f"wrote {args.gif} ({len(gif_frames)} frames)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
