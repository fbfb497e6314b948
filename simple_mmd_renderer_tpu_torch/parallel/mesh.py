"""Multi-instance (crowd) execution on one device.

Port of `crowd_init` and `crowd_step_fn` of `simple_mmd_renderer_tpu/
parallel/mesh.py`: many instances of one character, each at its own point
of one motion, stepped and rendered by one batched program. The reference
gets the instance axis from `jax.vmap(scene.step_pose)`; here
`Scene.step_pose` takes the crowd state itself and runs every stage once on
instance-major rows (`core.model.CrowdModelTables`,
`core.physics.CrowdPhysicsTables`), and `render.pipeline.
crowd_render_frame` rasterizes all instances in one binning and one kernel
launch per pass. The reference jits the crowd step; here `crowd_step_fn`
replays the scene's compiled step (`Scene.jit_step`: one CUDA graph for
the crowd's shape, one replay a crowd frame) and renders eagerly after it.

The multi-device entry points keep the reference's names and signatures.
`make_mesh` gives a `Mesh`: an ordered tuple of torch devices, one shard
per entry, and the axis name. An entry may repeat a device
(`make_mesh(["cuda:0"] * 4)`, `["cpu"] * 4`): shards that share a device
run one after another on it. This is the counterpart of the virtual
devices XLA makes with `--xla_force_host_platform_device_count`, which the
reference's tests run on. A value split over a mesh is a `Sharded`: one
tensor or state per entry, on that entry's device, concatenated along the
instance axis of a crowd or the row axis of a frame by `gather` (the
counterpart of a `jax.Array` sharded by `NamedSharding(mesh, P(axis))`).

- `shard_crowd` splits a `crowd_init` state into equal shards;
- `crowd_jit` runs `crowd_step_fn` on each shard, on a replica of the
  scene on that shard's device (`Scene.replica`, one per distinct device,
  built once; the packed atlas packed once and copied to each device);
- `frame_jit` splits one frame's rows into bands, each rendered through
  `band_transform` on its entry's device.

As in the reference, nothing moves a shard off its device inside a step:
there are no collectives on the hot path. The shards and bands are driven
in turn from one host thread; their overlap across separate GPUs is not
measured.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import sys

import torch

from ..core.physics import PhysicsState
from ..core.scene import Scene, SimState
from ..render.pipeline import (build_packed_atlas, crowd_render_frame,
                               crowd_render_supported, render_frame)
from ..utils.graph import tree_leaves, tree_map


def crowd_init(scene: Scene, n: int, phase_frames: float = 7.0) -> SimState:
    """n instance states with staggered animation clocks (independent-
    looking motion from one motion track): every leaf of `init_state`
    repeated along a leading [n] axis, `time = arange(n) * phase_frames /
    fps`."""
    base = scene.init_state()
    physics = PhysicsState(**{
        f.name: getattr(base.physics, f.name)[None].repeat(
            (n,) + (1,) * getattr(base.physics, f.name).dim())
        for f in dataclasses.fields(base.physics)})
    times = torch.arange(n, dtype=torch.float32, device=scene.device) \
        * (phase_frames / scene.config.fps)
    return SimState(time=times, physics=physics)


_FALLBACK_NOTICED: set = set()

# the render config's fields a camera or light track sets
_TRACK_FIELDS = ("camera_pos", "camera_target", "camera_fov_deg",
                 "camera_orthographic", "light_color", "light_direction")


def crowd_step_fn(scene: Scene, render: bool = True, width=None,
                  height=None, atlas_arg: bool = False):
    """Per-frame crowd function over the instance axis: state -> (state',
    pose, positions, normals) without rendering, state -> (state', images
    [I,H,W,3]) with it.

    With textures (`scene.part_textures`) every instance samples one
    shared atlas: with `atlas_arg=True` the one the caller passes, state,
    atlas -> (state', images) (e.g. `scene.packed_atlas()`, whose mip
    chain selects each triangle's level per instance); else one packed
    from the scene's textures without mips when the function is made (the
    atlas the reference's jitted step holds as a constant). The scene's
    skybox (`scene.cubemap`) and MMD maps (`scene.mmd_device_maps()`,
    packed once) go into every crowd frame. With
    `config.apply_extended_morphs` each instance's UV and material morphs
    apply at its own leaf rates (`Scene.extended_morphs` on the batched
    pose: [I, V, 2] offsets and [I, P, 3] factors), under the reference's
    static gate.

    With a VMD camera track (`scene.camera`) the crowd leaves the fused
    frame for the per-instance one, as the reference's does, each instance
    rendered with its own clock's camera and light samples
    (`Scene.frame_config`). The fused frame does not read a light track:
    the reference's fused step passes the scene's render config as it is,
    and so does this one.

    Posing and physics always run batched, as one replay of the scene's
    compiled step on the crowd state (`Scene.jit_step(render=False,
    donate=False)`; on a CPU scene the same capturable step, eagerly). Its
    outputs are copies, so that steps of several crowds may share the
    scene's graph. Rendering goes through the
    fused multi-instance frame when the config allows it
    (`crowd_render_supported`); the supersampled MSAA, a camera track and
    the scan raster, which it does not cover, render instance by instance
    through `render_frame`, with a one-line notice once per process."""
    pose_step = scene.jit_step(render=False, donate=False)
    if not render:
        return pose_step

    cfg_r = scene.config.render
    textures = scene.part_textures
    own = (None if atlas_arg or textures is None
           else build_packed_atlas(textures, device=scene.device))
    look = dict(cubemap=scene.cubemap, mmd_maps=scene.mmd_device_maps())

    def bind(step):
        return step if atlas_arg else (lambda state: step(state, own))

    if crowd_render_supported(cfg_r, camera=scene.camera):
        def step(state, atlas=None):
            state, pose, positions, normals = pose_step(state)
            uv_off, part_color = scene.extended_morphs(pose.leaf_rates)
            images = crowd_render_frame(scene.rig, positions, normals, cfg_r,
                                        width, height, part_textures=textures,
                                        atlas=atlas, uv_offsets=uv_off,
                                        part_color=part_color, **look)
            return state, images
        return bind(step)

    reasons = [r for r, on in (
        ("msaa_supersample", bool(cfg_r.msaa >= 4 and cfg_r.msaa_supersample)),
        ("vmd_camera", scene.camera is not None),
        ("scan_raster", cfg_r.raster_mode == "scan"),
    ) if on]
    key = tuple(reasons)
    if key not in _FALLBACK_NOTICED:
        _FALLBACK_NOTICED.add(key)
        print(f"# crowd: vmap(render_frame) fallback (fused path excluded "
              f"by: {', '.join(reasons) or 'unknown config'})",
              file=sys.stderr)

    def step_fallback(state, atlas=None):
        state, pose, positions, normals = pose_step(state)
        uv_off, part_color = scene.extended_morphs(pose.leaf_rates)
        # the tracks sampled once at every instance's clock ([I] leading)
        batched = scene.frame_config(state.time)
        sampled = [f for f in _TRACK_FIELDS
                   if getattr(batched, f) is not getattr(cfg_r, f)]

        def instance_cfg(i):
            return dataclasses.replace(
                batched, **{f: getattr(batched, f)[i] for f in sampled})
        images = torch.stack([
            render_frame(scene.rig, positions[i], normals[i],
                         instance_cfg(i),
                         part_textures=textures, width=width, height=height,
                         atlas=atlas,
                         uv_offsets=None if uv_off is None else uv_off[i],
                         part_color=(None if part_color is None else
                                     (part_color[0][i], part_color[1][i])),
                         **look)
            for i in range(positions.shape[0])])
        return state, images
    return bind(step_fallback)


# ---------------------------------------------------------------------------
# Device meshes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: `devices[k]` holds shard k; `axis` names the
    mesh's one axis. A device may appear more than once."""
    devices: tuple
    axis: str = "data"

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        """The mesh's devices, each once, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))


def _mesh_device(device, devices) -> torch.device:
    """One mesh entry as a torch.device (a CUDA device with its index); a
    CUDA entry with no card present raises, naming `devices`."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"devices={devices!r}: no CUDA device is available (pass "
            "devices=['cpu'] * n to run on the CPU)")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"devices={devices!r}: cuda:{index} does not "
                         f"exist ({torch.cuda.device_count()} CUDA devices)")
    return torch.device("cuda", index)


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    """The mesh over `devices` (torch devices or their names, in shard
    order), by default every CUDA device. With no card, `devices=None` and
    every CUDA entry raise, naming the argument: nothing falls back to the
    CPU unless the CPU is named. An entry may repeat a device (e.g.
    `["cuda:0"] * 4` on one card, `["cpu"] * 4` in CPU tests): each entry
    is one shard, and shards that share a device run one after another on
    it, as XLA's virtual host devices stand in for chips in the
    reference's tests."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "devices=None: no CUDA device is available (pass "
                "devices=['cpu'] * n to run on the CPU)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh_devices = tuple(_mesh_device(d, devices) for d in devices)
    if not mesh_devices:
        raise ValueError("devices: a mesh needs at least one device")
    return Mesh(mesh_devices, axis)


@dataclasses.dataclass
class Sharded:
    """A value split over a mesh: `shards[k]` (a tensor, or a tree of
    them such as a SimState) lies on `devices[k]`, and the whole value is
    every leaf's shards concatenated along `dim` (0: the instance axis of a
    crowd's state and images, the row axis of a frame)."""
    shards: list
    devices: tuple
    dim: int = 0

    def __len__(self) -> int:
        return len(self.shards)

    def gather(self, device=None):
        """The whole value on `device` (default: the first shard's), in
        instance or row order."""
        dev = self.devices[0] if device is None else torch.device(device)
        leaves = [tree_leaves(s) for s in self.shards]
        whole = iter([torch.cat([ls[j].to(dev) for ls in leaves], self.dim)
                      for j in range(len(leaves[0]))])
        return tree_map(lambda _: next(whole), self.shards[0])


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r}: the mesh's axis is {mesh.axis!r}")


def _on(device: torch.device):
    """The body runs with `device` as the current CUDA device (where the
    hand kernels launch and a graph is captured); a no-op for the CPU."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _replicas(scene: Scene, mesh: Mesh) -> dict:
    """{device: the scene there} for each distinct device of the mesh: the
    scene itself on its own device, else `scene.replica(device)`."""
    return {dev: scene if dev == scene.device else scene.replica(dev)
            for dev in mesh.distinct}


def _atlas_to(atlas, device):
    """A PackedAtlas's tensors on `device` (the same atlas when they are
    there already), or None."""
    if atlas is None:
        return None
    return dataclasses.replace(atlas, **{
        f.name: getattr(atlas, f.name).to(device)
        for f in dataclasses.fields(atlas)
        if isinstance(getattr(atlas, f.name), torch.Tensor)})


def shard_crowd(state: SimState, mesh: Mesh, axis: str = "data") -> Sharded:
    """A crowd state (`crowd_init`) split along the instance axis into
    len(mesh) equal shards, shard k copied to `mesh.devices[k]`; an
    instance count the mesh does not divide raises, as a NamedSharding
    does."""
    _check_axis(mesh, axis)
    if state.time.dim() != 1:
        raise ValueError("shard_crowd takes a crowd state (time [I])")
    n_inst, n = state.time.shape[0], len(mesh)
    if n_inst % n:
        raise ValueError(f"{n_inst} instances do not split into {n} equal "
                         f"shards over the mesh's axis {axis!r}")
    per = n_inst // n
    return Sharded([tree_map(lambda t: t[k * per:(k + 1) * per].to(
        dev, copy=True), state) for k, dev in enumerate(mesh.devices)],
        mesh.devices)


def band_transform(n_bands: int, band_index):
    """Clip-space window transform selecting horizontal band `band_index`
    (0 = top rows) of an `n_bands`-way row split of the full frame: the
    float32 identity with [1, 1] = n and [1, 3] = -(n - 1 - 2b).

    Screen rows map linearly to NDC y, so band b's local NDC y' relates to
    the full-frame NDC y by y = (y' + c) / n with c = n - 1 - 2b; the
    inverse y'_clip = n*y_clip - c*w_clip is linear in clip space and
    therefore a plain 4x4 left-multiplied onto the projection matrix.
    `band_index` may be a tensor (the result then lies on its device)."""
    i = torch.as_tensor(band_index, dtype=torch.float32)
    c = torch.tensor(float(n_bands - 1), dtype=torch.float32,
                     device=i.device) - 2.0 * i
    out = torch.eye(4, dtype=torch.float32, device=i.device)
    out[1, 1] = float(n_bands)
    out[1, 3] = -c
    return out


def _with_render(scene: Scene, **render) -> Scene:
    """A shallow copy of `scene` (the same tables and graphs) whose render
    config differs in `render`."""
    other = copy.copy(scene)
    other.config = dataclasses.replace(
        scene.config, render=dataclasses.replace(scene.config.render,
                                                 **render))
    return other


def frame_jit(scene: Scene, mesh: Mesh, width=None, height=None,
              axis: str = "data"):
    """Tile-parallel SINGLE-frame rendering: state -> (state', image), the
    image a `Sharded` of len(mesh) row bands (gather: [H, W, 3]). Band b
    is rendered at height H / n on `mesh.devices[b]` through
    `band_transform(n, b)` with the full frame's aspect W / H, so the
    per-pixel work splits n ways with no collective: the bands ARE the
    output rows.

    The pose + physics + deform step (one replay of the compiled step,
    `Scene.replay_step`) runs once per distinct device of the mesh, on
    that device's replica of the scene, and every band on the device
    renders from its output. The reference replicates the step on every
    device; this computes the same value once a device. state' is the
    first entry's copy.

    The downsampled ground-shadow lookup keeps one geometric halo row
    beyond each band edge (`ground_pass(row0=-1, rows=lh + 2)`), so the
    bands join without a seam. Bands whose height the downsample factor
    does not divide (or a width it does not divide) render with the exact
    per-pixel lookup (`shadow_lookup_downsample=1`), as the reference's
    do; the single-device frame keys its choice off the full height."""
    _check_axis(mesh, axis)
    n = len(mesh)
    W = width or scene.config.render.width
    H = height or scene.config.render.height
    assert H % n == 0, f"height {H} must split over {n} devices"
    ds = max(int(scene.config.render.shadow_lookup_downsample), 1)
    if ds > 1 and ((H // n) % ds or W % ds):
        scene = _with_render(scene, shadow_lookup_downsample=1)
    replicas = _replicas(scene, mesh)
    atlas = scene.packed_atlas()
    atlases = {dev: _atlas_to(atlas, dev) for dev in replicas}
    transforms = [band_transform(n, b).to(dev)
                  for b, dev in enumerate(mesh.devices)]

    def step(state):
        posed = {}
        for dev, rep in replicas.items():
            with _on(dev):
                posed[dev] = rep.replay_step(
                    tree_map(lambda t: t.to(dev), state))
        bands = []
        for b, dev in enumerate(mesh.devices):
            with _on(dev):
                s, pose, positions, normals = posed[dev]
                bands.append(replicas[dev]._render(
                    s.time, pose, positions, normals, W, H // n,
                    atlases[dev], proj_transform=transforms[b],
                    aspect=W / H))
        # the graph's buffers: the next replay overwrites them
        state = tree_map(torch.clone, posed[mesh.devices[0]][0])
        return state, Sharded(bands, mesh.devices)
    return step


def crowd_jit(scene: Scene, mesh: Mesh, render: bool = True, width=None,
              height=None, axis: str = "data"):
    """The crowd step with the instance axis sharded over the mesh:
    state -> (state', images) with `render`, else state -> (state', pose,
    positions, normals), every value a `Sharded` (a plain crowd state is
    sharded first by `shard_crowd`). Each shard runs `crowd_step_fn` on
    the scene's replica on its device (`Scene.replica`, one per distinct
    device, built once): one replay of the replica's compiled step for the
    shard's shape, then the fused crowd frame (or the per-instance
    fallback where the reference falls back). Shards on one device share
    its replica's graph; the step returns copies, so no shard's outputs
    are overwritten by the next. With textures the scene's atlas
    (`Scene.packed_atlas`) is packed once and copied to each device, as
    the reference passes it replicated to every device."""
    _check_axis(mesh, axis)
    replicas = _replicas(scene, mesh)
    atlas = scene.packed_atlas() if render else None
    fns = {dev: crowd_step_fn(rep, render=render, width=width,
                              height=height, atlas_arg=True)
           for dev, rep in replicas.items()}
    atlases = {dev: _atlas_to(atlas, dev) for dev in replicas}

    def step(state):
        if not isinstance(state, Sharded):
            state = shard_crowd(state, mesh, axis)
        if tuple(state.devices) != mesh.devices:
            raise ValueError("the state is sharded over another mesh")
        outs = []
        for shard, dev in zip(state.shards, mesh.devices):
            with _on(dev):
                outs.append(fns[dev](shard, atlases[dev]) if render
                            else fns[dev](shard))
        return tuple(Sharded([out[j] for out in outs], mesh.devices)
                     for j in range(len(outs[0])))
    return step
