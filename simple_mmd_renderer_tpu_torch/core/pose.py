"""Posing pipeline: morphs -> level-parallel FK -> CCD IK -> skinning
matrices -> deform.

Port of `simple_mmd_renderer_tpu/core/pose.py`. The rig program (FK levels,
IK groups) comes from `ModelTables`; per-frame inputs are the sampled bone
poses and morph rates. Functions are pure: each returns a new PoseArrays.

The extended morphs (`uv_morph_offsets`, `ext_uv_morph_offsets`,
`material_morph_factors`) read the pose's leaf rates, [M] for one frame or
[I, M] for a crowd, and return their tables with the same leading axes.
Repeated targets sum (or multiply) in entry order, one occurrence pass at a
time, as the vertex morphs do: no float atomics. `deform(sdef=True)`
overwrites the SDEF vertices (spherical deform) from the device tables
`ModelTables` gathered once (`sdef_*`), with an index copy: no host read,
so it runs inside the captured step.

An IK group's CCD solve (`_solve_ik_group`) is one launch of a
hand-written kernel on the card (`ops/ccd.py`, `csrc/ccd.cu`) and the plain
loop `solve_ik_group_plain` elsewhere; both give the same bits on the card.
The plain loop's early exit (every chain converged) reads a device flag
once per iteration, a host synchronisation. The posing functions take
`capturable=True` for the form a CUDA graph can hold (`Scene.jit_step`):
every one of the group's `loop` iterations runs, masked by `active`. A
chain that has converged is frozen either way (`done` only grows and every
write is `torch.where(active, new, old)`), so both forms give the same
bits; the kernel runs the masked form, captured or not.

A crowd is posed by the same functions on the rig's instance-major view
(`ModelTables.crowd(n)`, see `CrowdModelTables`): the state then holds
n_inst * B bone rows and n_inst * N vertex rows, an IK group n_inst * G
chains (each converges, and is frozen, on its own), and one FK level, CCD
step or morph pass serves every instance. Only the products with a table
the instances share (`morph_expand`, the dense skin weights) see the
instance axis, as one batched product.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..utils import math3d as m3
from ..utils import profiling
from .model import FIX_ALL, FIX_NONE, FIX_X, FIX_Y, FIX_Z, ModelTables

_EPS = 1e-8


@dataclass
class PoseArrays:
    """Pose state (the reference's per-bone BoneImage fields + vertex morph
    accumulator)."""
    world: torch.Tensor          # [B,4,4] chain matrices (local_matrix_)
    skin: torch.Tensor           # [B,4,4] skinning matrices
    total_rot: torch.Tensor      # [B,4]
    total_trans: torch.Tensor    # [B,3]
    pre_ik_rot: torch.Tensor     # [B,4]
    ik_rot: torch.Tensor         # [B,4]
    vertex_offsets: torch.Tensor  # [N,3] vertex morph accumulator
    leaf_rates: torch.Tensor     # [M] group-expanded morph rates

    def replace(self, **kw) -> "PoseArrays":
        return dataclasses.replace(self, **kw)


def _set(t, idx, val):
    """Out-of-place t.at[idx].set(val)."""
    out = t.clone()
    out[idx] = val
    return out


def _ordered_add(t, idx, val, passes, op=torch.add):
    """Out-of-place t.at[idx].add(val) along dim -2 of t [..., R, C]
    (leading instance axes pass through): rows idx [K] combined with val
    [..., K, C] by `op` (torch.add, or torch.mul for .multiply) in entry
    order, one occurrence pass at a time (no index repeats within a pass),
    each written with an index copy: deterministic on every device, with
    no float atomics."""
    for entries in passes:
        i = idx[entries]
        t = t.index_copy(-2, i, op(t.index_select(-2, i),
                                   val.index_select(-2, entries)))
    return t


def init_pose(static: ModelTables) -> PoseArrays:
    b = static.n_bones
    n = static.n_vertices
    dev = static.device
    eye = torch.eye(4, dtype=torch.float32, device=dev).expand(b, 4, 4)
    return PoseArrays(
        world=eye.clone(), skin=eye.clone(),
        total_rot=m3.quat_identity((b,), device=dev),
        total_trans=torch.zeros((b, 3), dtype=torch.float32, device=dev),
        pre_ik_rot=m3.quat_identity((b,), device=dev),
        ik_rot=m3.quat_identity((b,), device=dev),
        vertex_offsets=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        leaf_rates=torch.zeros((static.n_morphs,), dtype=torch.float32,
                               device=dev),
    )


# ---------------------------------------------------------------------------
# Morphs
# ---------------------------------------------------------------------------

def apply_morphs(static: ModelTables, morph_rates):
    """-> (vertex_offsets [N,3], morph_rot [B,4], morph_trans [B,3],
    leaf_rates [M]). Group morphs are pre-expanded into leaf rates; the
    reference's `rate < eps` skip applies to the summed leaf rate."""
    n = static.n_vertices
    b = static.n_bones
    dev = static.device
    n_inst = static.n_inst
    vertex_offsets = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    morph_rot = m3.quat_identity((b,), device=dev)
    morph_trans = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    if static.n_morphs == 0:
        return vertex_offsets, morph_rot, morph_trans, torch.zeros(
            (0,), dtype=torch.float32, device=dev)

    # per instance: rates [I, M] @ the shared expansion matrix
    leaf = (morph_rates.reshape(n_inst, -1)
            @ static.morph_expand).reshape(-1)
    leaf = torch.where(leaf >= _EPS, leaf, torch.zeros_like(leaf))

    if static.vm_morph.shape[0]:
        rates = leaf[static.vm_morph]
        vertex_offsets = _ordered_add(
            vertex_offsets, static.vm_vertex,
            static.vm_offset * rates[:, None], static.passes("vm"))

    if static.bm_morph.shape[0]:
        rates = leaf[static.bm_morph]
        bones = static.bm_bone
        morph_trans = _ordered_add(morph_trans, bones,
                                   static.bm_trans * rates[:, None],
                                   static.passes("bm"))
        # rotations compose in morph order:
        # morph_rotation = morph_rotation ⊗ slerp(id, q, rate)
        # (entry k of every instance in one step: [I] rows)
        ident = m3.quat_identity((n_inst,), device=dev)
        bones_i = bones.reshape(n_inst, -1)
        rot_i = static.bm_rot.reshape(n_inst, -1, 4)
        rates_i = rates.reshape(n_inst, -1)
        for k in range(bones_i.shape[1]):
            bone, q, rate = bones_i[:, k], rot_i[:, k], rates_i[:, k]
            delta = m3.quat_slerp(ident, q, rate)
            delta = torch.where((rate >= _EPS)[:, None], delta, ident)
            morph_rot = _set(morph_rot, bone,
                             m3.quat_mul(morph_rot[bone], delta))

    return vertex_offsets, morph_rot, morph_trans, leaf


def _zeros(static, leaf_rates, shape):
    return torch.zeros(tuple(leaf_rates.shape[:-1]) + shape,
                       dtype=torch.float32, device=static.device)


def uv_morph_offsets(static: ModelTables, leaf_rates):
    """[..., N, 2] UV offsets from the MORPH_UV entries at the leaf rates
    [..., M] (beyond the original app, which parses UV morphs and never
    applies them; gated by AppConfig.apply_extended_morphs)."""
    out = _zeros(static, leaf_rates, (static.n_vertices, 2))
    if static.um_morph.shape[0] == 0 or static.n_morphs == 0:
        return out
    val = static.um_offset * leaf_rates[..., static.um_morph, None]
    return _ordered_add(out, static.um_vertex, val, static.passes("um"))


def ext_uv_morph_offsets(static: ModelTables, leaf_rates):
    """[..., N, E, 4] offsets from the MORPH_EXT_UV_1..4 entries at the leaf
    rates (E: the model's extra-UV channel count). The built-in shader
    samples no extra-UV channel; `Scene.morphed_extra_uvs` serves them to
    custom-effect consumers."""
    n, e = static.n_vertices, static.extra_uvs.shape[1]
    out = _zeros(static, leaf_rates, (n * e, 4))
    if static.xum_morph.shape[0] and static.n_morphs and e:
        val = static.xum_offset * leaf_rates[..., static.xum_morph, None]
        out = _ordered_add(out, static.xum_vertex * e + static.xum_channel,
                           val, static.passes("xum"))
    return out.reshape(out.shape[:-2] + (n, e, 4))


def material_morph_factors(static: ModelTables, leaf_rates):
    """-> (mul [..., P, 3], add [..., P, 3]) albedo modifiers from the
    material morphs at the leaf rates [..., M].

    PMX material-morph semantics per entry of weight w: a multiply entry
    sets v *= lerp(1, payload, w), an additive one v += payload * w; the
    payload's diffuse RGB (floats 0:3) and texture tint RGB (16:19) both
    scale the sampled albedo here, so their effects combine. Entries of one
    part apply in table order (multiplies compose, adds add), as the
    reference's scan; beyond the original app, which applies none."""
    pn = static.part_base.shape[0]
    mul = _zeros(static, leaf_rates, (pn, 3)) + 1.0
    add = _zeros(static, leaf_rates, (pn, 3))
    if static.mm_morph.shape[0] == 0 or static.n_morphs == 0:
        return mul, add
    w = leaf_rates[..., static.mm_morph, None]                   # [..., K, 1]
    diff = static.mm_payload[:, 0:3]
    tint = static.mm_payload[:, 16:19]
    is_mul = static.mm_is_mul[:, None]
    factor = torch.where(is_mul, (1 + w * (diff - 1)) * (1 + w * (tint - 1)),
                         1.0)
    term = torch.where(is_mul, 0.0, w * (diff + tint))
    passes = static.passes("mm")
    return (_ordered_add(mul, static.mm_part, factor, passes, torch.mul),
            _ordered_add(add, static.mm_part, term, passes))


# ---------------------------------------------------------------------------
# FK (UpdateBoneTransform)
# ---------------------------------------------------------------------------

def _fk_bones(static: ModelTables, pose: PoseArrays, idx, anim_rot,
              anim_trans, morph_rot, morph_trans, active=None) -> PoseArrays:
    """Batched FK update of the bones in `idx` (an index tensor; same level:
    dependencies are already up to date in `pose`). `active` ([len(idx)]
    bool) gates writes per bone (grouped IK solves freeze converged
    chains)."""
    parent = static.bone_parent[idx]
    app = static.append_parent[idx]
    app_ratio = static.append_ratio[idx][:, None]
    app_rot_m = static.append_rotate[idx][:, None]
    app_trn_m = static.append_translate[idx][:, None]
    is_link = static.is_ik_link[idx][:, None]
    offset = static.local_offset[idx]

    total_rot = m3.quat_mul(morph_rot[idx], anim_rot[idx])
    total_trans = morph_trans[idx] + anim_trans[idx]

    app_safe = torch.clamp(app, min=0)
    ident = m3.quat_identity((idx.shape[0],), device=idx.device)
    app_q = m3.quat_slerp(ident, pose.total_rot[app_safe], app_ratio[:, 0])
    has_app = (app >= 0)[:, None]
    total_rot = torch.where(app_rot_m & has_app,
                            m3.quat_mul(total_rot, app_q), total_rot)
    total_trans = total_trans + torch.where(
        app_trn_m & has_app, app_ratio * pose.total_trans[app_safe],
        torch.zeros_like(total_trans))

    pre_ik = torch.where(is_link, total_rot, pose.pre_ik_rot[idx])
    total_rot = torch.where(is_link, m3.quat_mul(pose.ik_rot[idx], total_rot),
                            total_rot)

    local = m3.affine(m3.quat_to_mat3(total_rot), total_trans + offset)
    parent_safe = torch.clamp(parent, min=0)
    eye = torch.eye(4, dtype=torch.float32, device=idx.device)
    pw = torch.where((parent >= 0)[:, None, None], pose.world[parent_safe],
                     eye)
    world = pw @ local

    if active is not None:
        a1 = active[:, None]
        world = torch.where(active[:, None, None], world, pose.world[idx])
        total_rot = torch.where(a1, total_rot, pose.total_rot[idx])
        total_trans = torch.where(a1, total_trans, pose.total_trans[idx])
        pre_ik = torch.where(a1, pre_ik, pose.pre_ik_rot[idx])

    return pose.replace(
        world=_set(pose.world, idx, world),
        total_rot=_set(pose.total_rot, idx, total_rot),
        total_trans=_set(pose.total_trans, idx, total_trans),
        pre_ik_rot=_set(pose.pre_ik_rot, idx, pre_ik),
    )


def _limit_euler(euler, emin, emax, mirror: bool):
    """LimitEulerAngle; `mirror` is the i<ikt flag."""
    def clamp_lo(e):
        tf = 2 * emin - e
        return torch.where(e < emin, torch.where((tf <= emax) & mirror, tf,
                                                 emin), e)

    def clamp_hi(e):
        tf = 2 * emax - e
        return torch.where(e > emax, torch.where((tf >= emin) & mirror, tf,
                                                 emax), e)

    return clamp_hi(clamp_lo(euler))


def _still_active(done, out=None):
    """The chains not yet converged (~done), written into `out` when given:
    a row of the CCD counter's buffer."""
    return ~done if out is None else torch.bitwise_not(done, out=out)


def _solve_ik_group(static: ModelTables, pose: PoseArrays, seg, anim_rot,
                    anim_trans, morph_rot, morph_trans,
                    capturable: bool = False, actives=None) -> PoseArrays:
    """CCD IK of the group `seg`: on the card one launch of the CUDA solve
    (`ops.ccd.solve_ik_group_cuda`: every iteration, converged chains
    frozen, the same bits captured or not, no host read), elsewhere the
    plain loop. `actives` (bool [loop * G]) receives each iteration's
    active chains."""
    if pose.world.is_cuda:
        from ..ops import ccd
        world, total_rot, total_trans, pre_ik_rot, ik_rot = \
            ccd.solve_ik_group_cuda(static, pose.world, pose.total_rot,
                                    pose.total_trans, pose.pre_ik_rot,
                                    pose.ik_rot, seg, anim_rot, anim_trans,
                                    morph_rot, morph_trans, actives)
        return pose.replace(world=world, total_rot=total_rot,
                            total_trans=total_trans, pre_ik_rot=pre_ik_rot,
                            ik_rot=ik_rot)
    return solve_ik_group_plain(static, pose, seg, anim_rot, anim_trans,
                                morph_rot, morph_trans, capturable, actives)


def solve_ik_group_plain(static: ModelTables, pose: PoseArrays, seg,
                         anim_rot, anim_trans, morph_rot, morph_trans,
                         capturable: bool = False,
                         actives=None) -> PoseArrays:
    """CCD IK batched over a group of independent same-shaped chains
    (`seg`: an IKSegment). The link loop is unrolled per iteration; the
    iteration loop exits when every chain has converged (the reference's
    early return), or with `capturable` runs all `seg.loop` iterations
    with converged chains frozen (no host read). `actives` (bool [loop *
    G], with `capturable`) receives each iteration's active chains."""
    g = seg.links.shape[0]
    nl = seg.n_links
    dev = seg.links.device
    links = seg.links                                   # [G,L]
    targets = seg.targets
    loop = seg.loop
    ikt = loop // 2
    angle_limit = seg.angle_limit
    eye4 = torch.eye(4, dtype=torch.float32, device=dev)

    ident_g = m3.quat_identity((g * nl,), device=dev)
    pose = pose.replace(ik_rot=_set(pose.ik_rot, links.reshape(-1), ident_g))
    ik_position = pose.world[seg.goal_bones][:, :3, 3]               # [G,3]
    for jj in range(nl - 1, -1, -1):
        pose = _fk_bones(static, pose, links[:, jj], anim_rot, anim_trans,
                         morph_rot, morph_trans)
    pose = _fk_bones(static, pose, targets, anim_rot, anim_trans,
                     morph_rot, morph_trans)
    target_pos = pose.world[targets][:, :3, 3]                       # [G,3]

    err = ik_position - target_pos
    done = torch.sum(err * err, -1) < _EPS                           # [G]

    def parent_world(world, k):
        return torch.where(seg.link_has_parent[:, k, None, None],
                           world[seg.link_parent_safe[:, k]], eye4)

    world, total_rot, ik_rot = pose.world, pose.total_rot, pose.ik_rot
    pre_ik_rot = pose.pre_ik_rot
    if actives is not None:
        actives = actives.view(loop, g)
    for i in range(loop):
        if not capturable and not bool((~done).any()):   # host sync
            break
        active = _still_active(done, None if actives is None
                               else actives[i])                     # [G]
        mirror = i < ikt
        for j in range(nl):
            if seg.fix_types[j] == FIX_ALL:
                continue
            b = links[:, j]
            link_pos = world[b][:, :3, 3]
            target_dir = link_pos - target_pos
            ik_dir = link_pos - ik_position
            target_dir = target_dir / torch.clamp(torch.linalg.vector_norm(
                target_dir, dim=-1, keepdim=True), min=_EPS)
            ik_dir = ik_dir / torch.clamp(torch.linalg.vector_norm(
                ik_dir, dim=-1, keepdim=True), min=_EPS)

            axis = m3.cross(target_dir, ik_dir)
            axis = torch.where(torch.abs(axis) < _EPS,
                               torch.full_like(axis, _EPS), axis)
            loc = parent_world(world, j)

            if seg.limited[j] and seg.fix_types[j] != FIX_NONE:
                # axis pinned to the parent-local fixed axis while i < ikt
                if mirror:
                    ai = {FIX_X: 0, FIX_Y: 1, FIX_Z: 2}[seg.fix_types[j]]
                    sign = torch.where(
                        torch.sum(axis * loc[:, :3, ai], -1) >= 0,
                        1.0, -1.0)
                    axis = torch.zeros((g, 3), dtype=torch.float32,
                                       device=dev)
                    axis[:, ai] = sign
                else:
                    axis = torch.einsum("gji,gj->gi", loc[:, :3, :3], axis)
                    axis = axis / torch.clamp(torch.linalg.vector_norm(
                        axis, dim=-1, keepdim=True), min=_EPS)
            else:
                axis = torch.einsum("gji,gj->gi", loc[:, :3, :3], axis)
                axis = axis / torch.clamp(torch.linalg.vector_norm(
                    axis, dim=-1, keepdim=True), min=_EPS)

            cosang = torch.clamp(torch.sum(target_dir * ik_dir, -1),
                                 -1.0, 1.0)
            angle = torch.minimum(torch.acos(cosang), angle_limit * (j + 1))
            q = m3.axis_angle_to_quat(axis, angle)
            new_ik = m3.quat_mul(q, ik_rot[b])

            if seg.limited[j]:
                local_rotation = m3.quat_mul(new_ik, pre_ik_rot[b])
                order = seg.orders[j]
                euler = m3.quat_to_euler(local_rotation, order)
                euler = _limit_euler(euler, seg.limits_min[:, j],
                                     seg.limits_max[:, j], mirror)
                local_rotation = m3.euler_to_quat(euler, order)
                new_ik = m3.quat_mul(local_rotation,
                                     m3.quat_conj(pre_ik_rot[b]))
            ik_rot = _set(ik_rot, b, torch.where(active[:, None], new_ik,
                                                 ik_rot[b]))

            # refresh chain worlds from this link down to links[0]
            for k in range(j, -1, -1):
                bk = links[:, k]
                tr = m3.quat_mul(ik_rot[bk], pre_ik_rot[bk])
                local = m3.affine(m3.quat_to_mat3(tr),
                                  pose.total_trans[bk] + static.local_offset[bk])
                new_world = parent_world(world, k) @ local
                world = _set(world, bk, torch.where(active[:, None, None],
                                                    new_world, world[bk]))
                total_rot = _set(total_rot, bk, torch.where(
                    active[:, None], tr, total_rot[bk]))
            tmp = pose.replace(world=world, total_rot=total_rot,
                               ik_rot=ik_rot)
            tmp = _fk_bones(static, tmp, targets, anim_rot, anim_trans,
                            morph_rot, morph_trans, active=active)
            world, total_rot = tmp.world, tmp.total_rot
            tp = world[targets][:, :3, 3]
            target_pos = torch.where(active[:, None], tp, target_pos)

        err = ik_position - target_pos
        done = done | (torch.sum(err * err, -1) < _EPS)
    return pose.replace(world=world, total_rot=total_rot, ik_rot=ik_rot)


def _run_segments(static: ModelTables, pose: PoseArrays, segments,
                  anim_rot, anim_trans, morph_rot, morph_trans,
                  capturable: bool = False, name: str = "") -> PoseArrays:
    """The segments in order; with `capturable`, inside a compiled step,
    every CCD iteration's active chains go into the step's counter of
    posing pass `name` (`profiling.ccd_actives`), one buffer for the
    pass."""
    iks = [seg for seg in segments if seg.kind != "fk"]
    sizes = [seg.loop * seg.links.shape[0] for seg in iks]
    actives = (profiling.ccd_actives(name, sum(sizes), pose.world.device)
               if capturable else None)
    bufs = iter(actives.split(sizes) if actives is not None
                else [None] * len(iks))
    for seg in segments:
        if seg.kind == "fk":
            for level in seg.levels:
                pose = _fk_bones(static, pose, level, anim_rot, anim_trans,
                                 morph_rot, morph_trans)
        else:
            pose = _fk_bones(static, pose, seg.goal_bones, anim_rot,
                             anim_trans, morph_rot, morph_trans)
            pose = _solve_ik_group(static, pose, seg, anim_rot, anim_trans,
                                   morph_rot, morph_trans, capturable,
                                   next(bufs))
    return pose


def _update_skin(static: ModelTables, pose: PoseArrays, bones) -> PoseArrays:
    """skinning = world @ T(-rest), for the listed bones only (physics-
    written matrices of other bones must survive)."""
    if bones.shape[0] == 0:
        return pose
    w = pose.world[bones]
    rest = static.bone_rest[bones]
    trans = w[:, :3, 3] - torch.einsum("bij,bj->bi", w[:, :3, :3], rest)
    skin = w.clone()
    skin[:, :3, 3] = trans
    return pose.replace(skin=_set(pose.skin, bones, skin))


def pre_physics_posing(static: ModelTables, anim_rot, anim_trans,
                       morph_rates, capturable: bool = False) -> PoseArrays:
    """PrePhysicsPosing: clear, morphs, FK+IK over pre-physics bones,
    skinning matrices for those bones (`capturable`: `_solve_ik_group`)."""
    pose = init_pose(static)
    vertex_offsets, morph_rot, morph_trans, leaf = apply_morphs(static,
                                                                morph_rates)
    pose = pose.replace(vertex_offsets=vertex_offsets, leaf_rates=leaf)
    pose = _run_segments(static, pose, static.pre_segments,
                         anim_rot, anim_trans, morph_rot, morph_trans,
                         capturable, "pre_physics")
    return _update_skin(static, pose, static.pre_bones)


def post_physics_posing(static: ModelTables, pose: PoseArrays, anim_rot,
                        anim_trans, morph_rates,
                        capturable: bool = False) -> PoseArrays:
    """PostPhysicsPosing (`capturable`: `_solve_ik_group`)."""
    if static.n_morphs:
        _, morph_rot, morph_trans, _ = apply_morphs(static, morph_rates)
    else:
        morph_rot = m3.quat_identity((static.n_bones,), device=static.device)
        morph_trans = torch.zeros((static.n_bones, 3), dtype=torch.float32,
                                  device=static.device)
    pose = _run_segments(static, pose, static.post_segments,
                         anim_rot, anim_trans, morph_rot, morph_trans,
                         capturable, "post_physics")
    return _update_skin(static, pose, static.post_bones)


# ---------------------------------------------------------------------------
# Deform: uniform 4-wide linear blend skinning, spherical SDEF on request
# ---------------------------------------------------------------------------

def deform(static: ModelTables, pose: PoseArrays, use_matmul=None,
           sdef=False):
    """-> (positions [N,3], normals [N,3]) in MMD units. BDEF1/2/4 and the
    SDEF->BDEF2 matrix-lerp fallback all reduce to M = sum_k w_k skin[b_k];
    with the dense weight matrix this is a bone-palette matmul. On a crowd
    view the mesh and weights are shared and the skin matrices and morph
    offsets carry the instances: -> [I,N,3] each, from one batched
    product.

    sdef=True deforms the vertices that kept SDEF through Model::Normalize
    spherically (`_sdef_overwrite`, each instance of a crowd with its own
    matrices); sdef=False is the matrix-lerp fallback the original app
    ships."""
    skin, offsets = pose.skin, pose.vertex_offsets
    if static.n_inst > 1:
        skin = skin.reshape(static.n_inst, -1, 4, 4)
        offsets = offsets.reshape(static.n_inst, -1, 3)
    if use_matmul is None:
        use_matmul = static.skin_weight_dense is not None
    if use_matmul and static.skin_weight_dense is not None:
        from ..ops.skinning import skin_matmul
        out_pos, out_nrm = skin_matmul(static.skin_weight_dense, skin,
                                       static.positions, offsets,
                                       static.normals)
    else:
        mats = skin[..., static.skin_bones, :, :]       # [N,4,4,4]
        blend = torch.einsum("nk,...nkij->...nij", static.skin_weights, mats)
        p = static.positions + offsets
        out_pos = (torch.einsum("...nij,...nj->...ni", blend[..., :3, :3], p)
                   + blend[..., :3, 3])
        out_nrm = torch.einsum("...nij,nj->...ni", blend[..., :3, :3],
                               static.normals)
    if sdef and static.n_sdef:
        out_pos, out_nrm = _sdef_overwrite(static, skin, offsets, out_pos,
                                           out_nrm)
    return out_pos, out_nrm


def _sdef_overwrite(static: ModelTables, skin, offsets, out_pos, out_nrm):
    """Spherical SDEF for the SDEF vertex subset (the rig's `sdef_*`
    tables; `skin` [..., B, 4, 4] and `offsets` [..., N, 3] may carry a
    leading instance axis).

    Rotation is the slerp of the two bone rotations; translation anchors
    through the centre point C with the R0/R1 correction, so the skin
    bulges around the joint instead of collapsing like the linear
    matrix-lerp:

        rw  = w0*R0 + w1*R1
        cr0 = (C + (C + R0 - rw)) / 2,  cr1 = (C + (C + R1 - rw)) / 2
        p'  = slerp(q0, q1, w1) * (p - C) + w0*(M0 @ cr0) + w1*(M1 @ cr1)

    The rows are written back with an index copy."""
    idx = static.sdef_idx
    w0 = static.sdef_w0[:, None]                      # [S,1]
    w1 = 1.0 - w0
    m0 = skin[..., static.sdef_b0, :, :]              # [..., S, 4, 4]
    m1 = skin[..., static.sdef_b1, :, :]
    q0 = m3.mat3_to_quat(m0[..., :3, :3])
    q1 = m3.mat3_to_quat(m1[..., :3, :3])
    qb = m3.quat_slerp(q0, q1, w1[:, 0])

    c, r0, r1 = static.sdef_c, static.sdef_r0, static.sdef_r1
    rw = r0 * w0 + r1 * w1
    cr0 = c + (r0 - rw) * 0.5
    cr1 = c + (r1 - rw) * 0.5

    def apply(m, v):
        return torch.einsum("...nij,nj->...ni", m[..., :3, :3], v) \
            + m[..., :3, 3]

    p = static.positions[idx] + offsets.index_select(-2, idx)
    pos = m3.quat_rotate(qb, p - c) + w0 * apply(m0, cr0) \
        + w1 * apply(m1, cr1)
    nrm = m3.quat_rotate(qb, static.normals[idx].expand(pos.shape))
    return out_pos.index_copy(-2, idx, pos), out_nrm.index_copy(-2, idx, nrm)
