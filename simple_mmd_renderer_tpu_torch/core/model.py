"""Model build: PMX parse output -> static rig program + device tables.

The host half is the port's copy of `simple_mmd_renderer_tpu/core/model.py`
(the role of libmmd's `Model` plus the precomputation half of `Poser`'s
constructor, `motion/poser_impl.inl:16-128`): the dataclasses `IKProgram`,
`Segment` and `ModelStatic`, the FIX_*/ORDER_* constants, IK limit
classification, group-morph expansion and the NumPy builder `build_model`
(with `Model::Normalize`, `model/model_impl.inl:405-452`).

`ModelTables` is the device form of a `ModelStatic`: an `nn.Module` whose
buffers hold every array the per-frame pose, skinning and render code reads,
with the FK levels and IK programs as sub-modules of index buffers. Host
values that steer control flow (counts, IK loop lengths, fix types, euler
orders) stay Python values.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch
from torch import nn

from ..formats import pmx as P
from ..ops.skinning import build_weight_matrix
from ..utils.device import resolve_device

__all__ = ["FIX_ALL", "FIX_NONE", "FIX_X", "FIX_Y", "FIX_Z", "ORDER_XYZ",
           "ORDER_YZX", "ORDER_ZXY", "IKProgram", "ModelStatic", "Segment",
           "build_model", "ModelTables", "register_arrays"]

# IK link fix types (BoneImage::FIX_*)
FIX_NONE, FIX_X, FIX_Y, FIX_Z, FIX_ALL = 0, 1, 2, 3, 4
# IK euler clamp orders (BoneImage::ORDER_*)
ORDER_YZX, ORDER_ZXY, ORDER_XYZ = "yzx", "zxy", "xyz"
# the six Euler orders in the numbering of `IKSegment.codes`
EULER_ORDERS = ("xyz", "xzy", "yxz", "yzx", "zxy", "zyx")

_EPS = 1e-8
_HALF_PI = math.pi * 0.5


@dataclass
class IKProgram:
    """Static CCD program for one IK bone (poser_impl.inl:59-98, 168-310)."""
    bone: int                 # the IK effector-goal bone itself
    target: int               # bone chasing the goal
    links: np.ndarray         # [L] int, links[0] nearest the target
    link_parents: np.ndarray  # [L] int (-1 = none)
    limited: np.ndarray       # [L] bool
    limits_min: np.ndarray    # [L,3] f32
    limits_max: np.ndarray    # [L,3] f32
    fix_types: np.ndarray     # [L] int
    orders: list[str]         # [L] euler order names
    loop: int                 # ccd iterate limit, clamped to 256
    angle_limit: float


@dataclass
class Segment:
    """A run of non-IK FK bones (grouped in parallel levels) or a group of
    mutually-independent, same-shaped IK chains solved batched (e.g. the two
    legs)."""
    kind: str                  # "fk" | "ik"
    levels: list[np.ndarray] = field(default_factory=list)  # for "fk"
    iks: list[IKProgram] = field(default_factory=list)      # for "ik"


@dataclass
class ModelStatic:
    name: str
    # --- geometry (NumPy; ModelTables moves what a frame reads to a device)
    positions: np.ndarray      # [N,3] f32, MMD units
    normals: np.ndarray        # [N,3]
    uvs: np.ndarray            # [N,2]
    triangles: np.ndarray      # [T,3] i32
    skin_bones: np.ndarray     # [N,4] i32 (NONE -> 0)
    skin_weights: np.ndarray   # [N,4] f32 (slot weight 0 where padded)
    skin_type: np.ndarray      # [N] u8 (post-Normalize)
    sdef_c: np.ndarray
    sdef_r0: np.ndarray
    sdef_r1: np.ndarray
    # --- bones
    n_bones: int
    bone_names: list[str]
    bone_rest: np.ndarray      # [B,3]
    bone_parent: np.ndarray    # [B] i32 (-1 root)
    local_offset: np.ndarray   # [B,3] rest - parent_rest (or rest)
    append_parent: np.ndarray  # [B] i32 (-1 none)
    append_ratio: np.ndarray   # [B] f32
    append_rotate: np.ndarray  # [B] bool
    append_translate: np.ndarray  # [B] bool
    is_ik_link: np.ndarray     # [B] bool
    post_physics: np.ndarray   # [B] bool
    pre_segments: list[Segment]
    post_segments: list[Segment]
    # --- morphs
    morph_names: list[str]
    n_morphs: int
    # group-expansion: effective leaf rate_j = sum_i expand[i,j] * rate_i
    morph_expand: np.ndarray   # [M,M] f32
    vm_morph: np.ndarray       # [KV] i32 leaf morph id per vertex-morph entry
    vm_vertex: np.ndarray      # [KV] i32
    vm_offset: np.ndarray      # [KV,3] f32
    bm_morph: np.ndarray       # [KB] i32 (sorted by morph id = application order)
    bm_bone: np.ndarray        # [KB] i32
    bm_trans: np.ndarray       # [KB,3] f32
    bm_rot: np.ndarray         # [KB,4] f32
    # UV morphs (primary channel and the four extra-UV channels) and
    # material morphs
    um_morph: np.ndarray       # [KU] i32 leaf morph id
    um_vertex: np.ndarray      # [KU] i32
    um_offset: np.ndarray      # [KU,2] f32 (du, dv)
    xum_morph: np.ndarray      # [KX] i32 leaf morph id
    xum_vertex: np.ndarray     # [KX] i32
    xum_channel: np.ndarray    # [KX] i32 channel 0-3
    xum_offset: np.ndarray     # [KX,4] f32
    extra_uvs: np.ndarray      # [N,E,4] f32 rest-pose extra UV channels
    mm_morph: np.ndarray       # [KM] i32 leaf morph id (part-expanded)
    mm_part: np.ndarray        # [KM] i32 (the -1 = all-materials form expanded)
    mm_method: np.ndarray      # [KM] i32 0=mul 1=add
    mm_payload: np.ndarray     # [KM,28] f32 (pmx material-morph field order)
    # --- parts / materials (render)
    part_base: np.ndarray      # [Pn] i32 first triangle
    part_count: np.ndarray     # [Pn] i32
    part_tex: np.ndarray       # [Pn] i32 texture table index (-1 none)
    # edge/outline data (inverted-hull pass)
    edge_mag: np.ndarray       # [N] f32 vertex edge_scale x material edge_size
    edge_tris: np.ndarray      # [Te,3] i32 triangles of edge-flagged parts
    edge_tri_part: np.ndarray  # [Te] i32 owning part per edge triangle
    edge_colors: np.ndarray    # [Pn,4] f32 material edge colors
    nocull_tris: np.ndarray    # [T] bool — triangles of MAT_DOUBLE_FACE parts
    materials: list[P.Material]
    textures: list[str]
    # --- physics
    rigid_bodies: list[P.RigidBody]
    constraints: list[P.Constraint]
    # dense [N,B] LBS weight matrix (ops/skinning); None when N*B exceeds
    # the builder's size budget
    skin_weight_dense: np.ndarray | None = None


def _classify_ik_link(lo: np.ndarray, hi: np.ndarray) -> tuple[str, int, np.ndarray, np.ndarray]:
    """Euler-order + fix-type classification (poser_impl.inl:74-91)."""
    lmin = np.minimum(lo, hi).astype(np.float32)
    lmax = np.maximum(lo, hi).astype(np.float32)
    order = ORDER_YZX
    if lmin[0] > -_HALF_PI and lmax[0] < _HALF_PI:
        order = ORDER_ZXY
    elif lmin[1] > -_HALF_PI and lmax[1] < _HALF_PI:
        order = ORDER_XYZ
    z = lambda i: abs(lmin[i]) < _EPS and abs(lmax[i]) < _EPS
    zx, zy, zz = z(0), z(1), z(2)
    if zx and zy and zz:
        fix = FIX_ALL
    elif zy and zz:
        fix = FIX_X
    elif zx and zz:
        fix = FIX_Y
    elif zx and zy:
        fix = FIX_Z
    else:
        fix = FIX_NONE
    return order, fix, lmin, lmax


def _expand_group_morphs(morphs: list[P.Morph]) -> np.ndarray:
    """Expansion matrix E: effective leaf rates = rates @ E.

    Mirrors the recursion in UpdateMorphTransform for MORPH_TYPE_GROUP
    (poser_impl.inl:334-339); cycles are cut (the reference would recurse
    forever on a cyclic group, which valid files don't contain).
    """
    m = len(morphs)
    expand = np.zeros((m, m), np.float32)

    def visit(root: int, idx: int, rate: float, depth: int):
        if depth > 8 or abs(rate) < _EPS:
            return
        mo = morphs[idx]
        if mo.type == P.MORPH_GROUP:
            for child, crate in zip(mo.group_indices, mo.group_rates):
                if 0 <= child < m:
                    visit(root, int(child), rate * float(crate), depth + 1)
        else:
            expand[root, idx] += rate

    for i in range(m):
        visit(i, i, 1.0, 0)
    return expand


def build_model(pm: P.PmxModel) -> ModelStatic:
    n_bones = len(pm.bones)

    # --- Model::Normalize (model_impl.inl:405-452): canonicalize skin tables
    skin_type = pm.skin_type.copy()
    skin_bones = pm.skin_bones.copy()
    skin_weights = pm.skin_weights.copy()
    parent_of = np.array([b.parent for b in pm.bones], np.int32) if n_bones else np.zeros(0, np.int32)
    for i in range(len(skin_type)):
        st = skin_type[i]
        if st == P.BDEF2:
            w = skin_weights[i, 0]
            if w == 0.0:
                skin_type[i] = P.BDEF1
                skin_bones[i] = [skin_bones[i, 1], -1, -1, -1]
                skin_weights[i] = [1, 0, 0, 0]
            elif w == 1.0:
                skin_type[i] = P.BDEF1
                skin_bones[i, 1:] = -1
                skin_weights[i] = [1, 0, 0, 0]
        elif st == P.SDEF:
            b0, b1 = skin_bones[i, 0], skin_bones[i, 1]
            ok = (0 <= b0 < n_bones and 0 <= b1 < n_bones and
                  (parent_of[b0] == b1 or parent_of[b1] == b0))
            if not ok:
                w = skin_weights[i, 0]
                if w == 0.0:
                    skin_type[i] = P.BDEF1
                    skin_bones[i] = [b1, -1, -1, -1]
                    skin_weights[i] = [1, 0, 0, 0]
                elif w == 1.0:
                    skin_type[i] = P.BDEF1
                    skin_bones[i, 1:] = -1
                    skin_weights[i] = [1, 0, 0, 0]
                else:
                    skin_type[i] = P.BDEF2

    # padded bone slots must be valid gather indices; weight 0 keeps them inert
    skin_bones_safe = np.where(skin_bones < 0, 0, skin_bones).astype(np.int32)

    # --- bone images
    rest = np.stack([b.position for b in pm.bones]) if n_bones else np.zeros((0, 3), np.float32)
    parent = parent_of
    local_offset = rest.copy()
    has_parent = parent >= 0
    local_offset[has_parent] -= rest[parent[has_parent]]

    append_parent = np.full(n_bones, -1, np.int32)
    append_ratio = np.zeros(n_bones, np.float32)
    append_rotate = np.zeros(n_bones, bool)
    append_translate = np.zeros(n_bones, bool)
    post_physics = np.zeros(n_bones, bool)
    is_ik_link = np.zeros(n_bones, bool)

    ik_programs: dict[int, IKProgram] = {}
    for i, b in enumerate(pm.bones):
        ar = b.has(P.BONE_APPEND_ROTATE)
        at = b.has(P.BONE_APPEND_TRANSLATE)
        if (ar or at) and 0 <= b.append_parent < n_bones:
            append_parent[i] = b.append_parent
            append_ratio[i] = b.append_ratio
            append_rotate[i] = ar
            append_translate[i] = at
        post_physics[i] = b.has(P.BONE_POST_PHYSICS)
        if b.has(P.BONE_HAS_IK) and b.ik_target >= 0 and b.ik_links:
            links = np.array([l.bone for l in b.ik_links], np.int32)
            limited = np.array([l.has_limit for l in b.ik_links], bool)
            orders, fixes, lmins, lmaxs = [], [], [], []
            for l in b.ik_links:
                if l.has_limit:
                    order, fix, lmin, lmax = _classify_ik_link(l.lo, l.hi)
                else:
                    order, fix = ORDER_YZX, FIX_NONE
                    lmin = lmax = np.zeros(3, np.float32)
                orders.append(order)
                fixes.append(fix)
                lmins.append(lmin)
                lmaxs.append(lmax)
                is_ik_link[l.bone] = True
            ik_programs[i] = IKProgram(
                bone=i, target=b.ik_target, links=links,
                link_parents=parent[links].astype(np.int32),
                limited=limited,
                limits_min=np.stack(lmins).astype(np.float32),
                limits_max=np.stack(lmaxs).astype(np.float32),
                fix_types=np.array(fixes, np.int32), orders=orders,
                loop=min(b.ik_loop, 256), angle_limit=float(b.ik_angle))

    # --- processing order: (transform_level, index), split pre/post physics
    levels_key = np.array([b.transform_level for b in pm.bones], np.int64)
    order_all = np.lexsort((np.arange(n_bones), levels_key))
    pre_order = [i for i in order_all if not post_physics[i]]
    post_order = [i for i in order_all if post_physics[i]]

    def _ancestors(b: int) -> set[int]:
        out = set()
        seen = 0
        while b >= 0 and seen < n_bones:
            out.add(b)
            b = int(parent[b])
            seen += 1
        return out

    def _signature(ik: IKProgram):
        return (len(ik.links), ik.loop, tuple(ik.fix_types.tolist()),
                tuple(ik.orders), tuple(ik.limited.tolist()))

    def _independent(a: IKProgram, b: IKProgram) -> bool:
        """Solving a and b simultaneously == sequentially: neither reads or
        writes state the other touches (incl. FK reads of ancestors)."""
        mod_a = set(a.links.tolist()) | {a.target}
        mod_b = set(b.links.tolist()) | {b.target}
        reads_b = set().union(*(
            _ancestors(x) for x in ([b.bone, b.target] + b.links.tolist())))
        reads_a = set().union(*(
            _ancestors(x) for x in ([a.bone, a.target] + a.links.tolist())))
        return not (mod_a & reads_b) and not (mod_b & reads_a)

    def _group_iks(run: list[IKProgram]) -> list[list[IKProgram]]:
        """Greedy batching of an adjacent run of IK segments: an IK joins an
        earlier group iff its shape matches and it is independent of EVERY
        chain between (reordering across dependents would change results —
        e.g. toe IKs depend on their leg IK and stay behind it)."""
        groups: list[list[IKProgram]] = []
        for ik in run:
            placed = False
            for gi in range(len(groups) - 1, -1, -1):
                g = groups[gi]
                indep = all(_independent(ik, other) for other in g)
                if not indep:
                    break  # cannot reorder past a dependent group
                if _signature(g[0]) == _signature(ik):
                    g.append(ik)
                    placed = True
                    break
            if not placed:
                groups.append([ik])
        return groups

    def build_segments(order: list[int]) -> list[Segment]:
        segments: list[Segment] = []
        fk_run: list[int] = []
        ik_run: list[IKProgram] = []

        def flush_ik():
            for group in _group_iks(ik_run):
                segments.append(Segment("ik", iks=group))
            ik_run.clear()

        def flush_fk():
            if fk_run:
                segments.append(Segment("fk", levels=_levelize(fk_run)))
                fk_run.clear()

        def _levelize(run: list[int]) -> list[np.ndarray]:
            """Group a sequential FK run into parallel levels: a bone may join
            level L only if its parent and append parent are not pending in
            level >= L within this run. Bones whose parent appears later in
            the run read its stale (pre-pass) matrix, matching the sequential
            reference; they can be placed immediately."""
            pos = {b: k for k, b in enumerate(run)}
            level_of: dict[int, int] = {}
            levels: list[list[int]] = []
            for k, b in enumerate(run):
                lv = 0
                for dep in (int(parent[b]), int(append_parent[b])):
                    if dep >= 0 and dep in pos and pos[dep] < k:
                        lv = max(lv, level_of[dep] + 1)
                level_of[b] = lv
                while len(levels) <= lv:
                    levels.append([])
                levels[lv].append(b)
            return [np.array(l, np.int32) for l in levels]

        for b in order:
            if b in ik_programs:
                flush_fk()
                ik_run.append(ik_programs[b])
            else:
                flush_ik()
                fk_run.append(b)
        flush_fk()
        flush_ik()
        return segments

    # --- morph tables
    morphs = pm.morphs
    expand = _expand_group_morphs(morphs)
    vm_m, vm_v, vm_o = [], [], []
    bm_m, bm_b, bm_t, bm_r = [], [], [], []
    um_m, um_v, um_o = [], [], []
    xum_m, xum_v, xum_c, xum_o = [], [], [], []
    mm_m, mm_p, mm_me, mm_pl = [], [], [], []
    n_parts = len(pm.materials)
    extra_uvs = getattr(pm, "extra_uvs", None)
    if extra_uvs is None:
        extra_uvs = np.zeros((len(pm.positions), 0, 4), np.float32)
    n_extra_uv = extra_uvs.shape[1]
    for mi, mo in enumerate(morphs):
        if mo.type == P.MORPH_VERTEX:
            vm_m.append(np.full(len(mo.vertex_indices), mi, np.int32))
            vm_v.append(mo.vertex_indices.astype(np.int32))
            vm_o.append(mo.vertex_offsets.astype(np.float32))
        elif mo.type == P.MORPH_BONE:
            bm_m.append(np.full(len(mo.bone_indices), mi, np.int32))
            bm_b.append(mo.bone_indices.astype(np.int32))
            bm_t.append(mo.bone_translations.astype(np.float32))
            bm_r.append(mo.bone_rotations.astype(np.float32))
        elif mo.type == P.MORPH_UV and mo.uv_vertex_indices is not None:
            um_m.append(np.full(len(mo.uv_vertex_indices), mi, np.int32))
            um_v.append(mo.uv_vertex_indices.astype(np.int32))
            um_o.append(mo.uv_offsets[:, :2].astype(np.float32))
        elif (mo.type in (P.MORPH_EXT_UV_1, P.MORPH_EXT_UV_2,
                          P.MORPH_EXT_UV_3, P.MORPH_EXT_UV_4)
              and mo.uv_vertex_indices is not None):
            ch = mo.type - P.MORPH_EXT_UV_1
            if ch < n_extra_uv:   # drop channels the model doesn't declare
                k = len(mo.uv_vertex_indices)
                xum_m.append(np.full(k, mi, np.int32))
                xum_v.append(mo.uv_vertex_indices.astype(np.int32))
                xum_c.append(np.full(k, ch, np.int32))
                xum_o.append(mo.uv_offsets[:, :4].astype(np.float32))
        elif mo.type == P.MORPH_MATERIAL and mo.material_indices is not None:
            for j in range(len(mo.material_indices)):
                parts = (range(n_parts) if mo.material_indices[j] < 0
                         else [int(mo.material_indices[j])])
                for p in parts:
                    mm_m.append(mi)
                    mm_p.append(p)
                    mm_me.append(int(mo.material_methods[j]))
                    mm_pl.append(mo.material_payload[j].astype(np.float32))
    cat = lambda xs, shape, dt: (np.concatenate(xs) if xs else np.zeros(shape, dt))

    # --- parts
    part_base = np.array([mt.base_shift for mt in pm.materials], np.int32)
    part_count = np.array([mt.n_triangles for mt in pm.materials], np.int32)
    part_tex = np.array([mt.texture for mt in pm.materials], np.int32)

    # --- edge/outline tables (MAT_DRAW_EDGE parts only)
    n_all_verts = len(pm.positions)
    edge_mag = np.zeros(n_all_verts, np.float32)
    e_tris, e_part = [], []
    vertex_edge = (pm.edge_scale if pm.edge_scale is not None
                   else np.ones(n_all_verts, np.float32))
    for p, mt in enumerate(pm.materials):
        if not (mt.draw_flags & P.MAT_DRAW_EDGE) or mt.edge_size <= 0:
            continue
        tri_p = pm.triangles[mt.base_shift:mt.base_shift + mt.n_triangles]
        vids = np.unique(tri_p)
        edge_mag[vids] = np.maximum(edge_mag[vids],
                                    vertex_edge[vids] * mt.edge_size)
        e_tris.append(tri_p.astype(np.int32))
        e_part.append(np.full(len(tri_p), p, np.int32))
    edge_tris = (np.concatenate(e_tris) if e_tris
                 else np.zeros((0, 3), np.int32))
    edge_tri_part = (np.concatenate(e_part) if e_part
                     else np.zeros(0, np.int32))
    edge_colors = np.stack([np.asarray(mt.edge_color, np.float32)
                            for mt in pm.materials]) if pm.materials else \
        np.zeros((0, 4), np.float32)
    nocull_tris = np.zeros(len(pm.triangles), bool)
    for mt in pm.materials:
        if mt.draw_flags & P.MAT_DOUBLE_FACE:
            nocull_tris[mt.base_shift:mt.base_shift + mt.n_triangles] = True

    n_verts = len(pm.positions)
    skin_weight_dense = None
    if n_bones and n_verts and n_verts * n_bones <= 64_000_000:
        skin_weight_dense = build_weight_matrix(
            skin_bones_safe, skin_weights.astype(np.float32), n_bones)

    return ModelStatic(
        name=pm.name,
        positions=pm.positions.astype(np.float32),
        normals=pm.normals.astype(np.float32),
        uvs=pm.uvs.astype(np.float32),
        triangles=pm.triangles.astype(np.int32),
        skin_bones=skin_bones_safe,
        skin_weights=skin_weights.astype(np.float32),
        skin_type=skin_type,
        sdef_c=pm.sdef_c, sdef_r0=pm.sdef_r0, sdef_r1=pm.sdef_r1,
        n_bones=n_bones,
        bone_names=[b.name for b in pm.bones],
        bone_rest=rest.astype(np.float32),
        bone_parent=parent.astype(np.int32),
        local_offset=local_offset.astype(np.float32),
        append_parent=append_parent, append_ratio=append_ratio,
        append_rotate=append_rotate, append_translate=append_translate,
        is_ik_link=is_ik_link, post_physics=post_physics,
        pre_segments=build_segments(pre_order),
        post_segments=build_segments(post_order),
        morph_names=[mo.name for mo in morphs],
        n_morphs=len(morphs),
        morph_expand=expand,
        vm_morph=cat(vm_m, (0,), np.int32),
        vm_vertex=cat(vm_v, (0,), np.int32),
        vm_offset=cat(vm_o, (0, 3), np.float32),
        bm_morph=cat(bm_m, (0,), np.int32),
        bm_bone=cat(bm_b, (0,), np.int32),
        bm_trans=cat(bm_t, (0, 3), np.float32),
        bm_rot=cat(bm_r, (0, 4), np.float32),
        um_morph=cat(um_m, (0,), np.int32),
        um_vertex=cat(um_v, (0,), np.int32),
        um_offset=cat(um_o, (0, 2), np.float32),
        xum_morph=cat(xum_m, (0,), np.int32),
        xum_vertex=cat(xum_v, (0,), np.int32),
        xum_channel=cat(xum_c, (0,), np.int32),
        xum_offset=cat(xum_o, (0, 4), np.float32),
        extra_uvs=extra_uvs.astype(np.float32),
        mm_morph=np.asarray(mm_m, np.int32),
        mm_part=np.asarray(mm_p, np.int32),
        mm_method=np.asarray(mm_me, np.int32),
        mm_payload=(np.stack(mm_pl).astype(np.float32) if mm_pl
                    else np.zeros((0, 28), np.float32)),
        part_base=part_base, part_count=part_count, part_tex=part_tex,
        edge_mag=edge_mag, edge_tris=edge_tris,
        edge_tri_part=edge_tri_part, edge_colors=edge_colors,
        nocull_tris=nocull_tris,
        materials=pm.materials, textures=pm.textures,
        rigid_bodies=pm.rigid_bodies, constraints=pm.constraints,
        skin_weight_dense=skin_weight_dense,
    )


def register_arrays(module: nn.Module, src, names, device) -> None:
    """Register src.<name> (NumPy) as a buffer of `module` on `device`:
    floats as float32, integers as int64 (index tensors), bools as bool."""
    for name in names:
        arr = np.asarray(getattr(src, name))
        if arr.dtype == np.bool_:
            t = torch.as_tensor(arr, dtype=torch.bool)
        elif np.issubdtype(arr.dtype, np.integer):
            t = torch.as_tensor(arr.astype(np.int64))
        else:
            t = torch.as_tensor(arr.astype(np.float32))
        module.register_buffer(name, t.to(device))


def _segment_bones(segments) -> list[int]:
    out = []
    for seg in segments:
        if seg.kind == "fk":
            for level in seg.levels:
                out.extend(int(b) for b in level)
        else:
            out.extend(ik.bone for ik in seg.iks)
    return out


class FKSegment(nn.Module):
    """A run of FK bones in parallel levels: buffer `level{i}` [n_i]."""
    kind = "fk"

    def __init__(self, seg: Segment, device=None):
        super().__init__()
        self.n_levels = len(seg.levels)
        for i, lvl in enumerate(seg.levels):
            self.register_buffer(f"level{i}", torch.as_tensor(
                np.asarray(lvl, np.int64), device=device))

    @property
    def levels(self):
        return [getattr(self, f"level{i}") for i in range(self.n_levels)]


class IKSegment(nn.Module):
    """A group of independent, same-shaped CCD chains solved batched.

    `codes` (int32 [3, L]) packs the per-link lists that the CUDA solve
    (`ops/ccd.py`) reads, once: the fix types, the limited flags and the
    Euler orders (their index in `EULER_ORDERS`)."""
    kind = "ik"

    def __init__(self, seg: Segment, device=None):
        super().__init__()
        iks = seg.iks
        self.iks = iks                       # host programs
        self.n_links = len(iks[0].links)
        self.loop = int(iks[0].loop)
        self.fix_types = [int(f) for f in iks[0].fix_types]
        self.orders = list(iks[0].orders)
        self.limited = [bool(x) for x in iks[0].limited]
        link_parents = np.stack([ik.link_parents for ik in iks])
        tables = dict(
            links=np.stack([ik.links for ik in iks]).astype(np.int64),
            link_parent_safe=np.maximum(link_parents, 0).astype(np.int64),
            link_has_parent=link_parents >= 0,
            targets=np.asarray([ik.target for ik in iks], np.int64),
            goal_bones=np.asarray([ik.bone for ik in iks], np.int64),
            angle_limit=np.asarray([ik.angle_limit for ik in iks],
                                   np.float32),
            limits_min=np.stack([ik.limits_min for ik in iks]),
            limits_max=np.stack([ik.limits_max for ik in iks]),
            codes=np.array([self.fix_types, self.limited,
                            [EULER_ORDERS.index(o) for o in self.orders]],
                           np.int32).reshape(3, self.n_links))
        for name, arr in tables.items():
            self.register_buffer(name, torch.as_tensor(arr, device=device))


def _segments(segments, device):
    return nn.ModuleList([FKSegment(s, device) if s.kind == "fk"
                          else IKSegment(s, device) for s in segments])


def _occurrence_passes(targets: np.ndarray) -> list[np.ndarray]:
    """Entry indices split into passes by occurrence: pass k holds, in
    entry order, each target's k-th entry. No pass names a target twice, so
    summing pass after pass needs no atomics and adds every target's
    entries in entry order."""
    seen: dict[int, int] = {}
    rank = np.empty(len(targets), np.int64)
    for e, t in enumerate(targets.tolist()):
        rank[e] = seen.get(t, 0)
        seen[t] = rank[e] + 1
    n_passes = int(rank.max()) + 1 if len(rank) else 0
    return [np.flatnonzero(rank == k) for k in range(n_passes)]


class ModelTables(nn.Module):
    """Device tables of a ModelStatic (see the module docstring)."""

    ARRAYS = ("positions", "normals", "uvs", "triangles", "skin_bones",
              "skin_weights", "bone_rest", "bone_parent", "local_offset",
              "append_parent", "append_ratio", "append_rotate",
              "append_translate", "is_ik_link", "morph_expand", "vm_morph",
              "vm_vertex", "vm_offset", "bm_morph", "bm_bone", "bm_trans",
              "bm_rot")

    def __init__(self, static: ModelStatic, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.host = static
        self.n_bones = static.n_bones
        self.n_morphs = static.n_morphs
        register_arrays(self, static, self.ARRAYS, device)
        # parts are contiguous triangle ranges from their first triangle
        # (reader/pmx_reader_impl.inl:185-189): the first triangles (int32,
        # as the triangle ids they are searched with) and each triangle's part
        part_base = np.asarray(static.part_base, np.int32)
        tri_part = np.searchsorted(part_base, np.arange(len(static.triangles)),
                                   side="right") - 1
        self.register_buffer("part_base", torch.as_tensor(part_base,
                                                          device=device))
        self.register_buffer("tri_part", torch.as_tensor(
            np.maximum(tri_part, 0).astype(np.int64), device=device))
        # the edge hull's and the double-sided materials' tables, and the
        # host facts the render's per-frame gates read (no device read)
        register_arrays(self, static, ("edge_mag", "edge_tris",
                                       "edge_tri_part", "edge_colors",
                                       "nocull_tris"), device)
        self.n_edge_tris = len(static.edge_tris)
        self.has_nocull = bool(np.asarray(static.nocull_tris).any())
        if static.skin_weight_dense is not None:
            register_arrays(self, static, ("skin_weight_dense",), device)
        else:
            self.skin_weight_dense = None
        self.pre_segments = _segments(static.pre_segments, device)
        self.post_segments = _segments(static.post_segments, device)
        # the extended morphs' tables (UV, extra-UV and material morphs)
        register_arrays(self, static, ("um_morph", "um_vertex", "um_offset",
                                       "xum_morph", "xum_vertex",
                                       "xum_channel", "xum_offset",
                                       "extra_uvs", "mm_morph", "mm_part",
                                       "mm_payload"), device)
        self.register_buffer("mm_is_mul", torch.as_tensor(
            np.asarray(static.mm_method) == 0, device=device))
        self._register_sdef(static, device)
        n_extra = np.asarray(static.extra_uvs).shape[1]
        for name, targets in (
                ("vm", static.vm_vertex), ("bm", static.bm_bone),
                ("um", static.um_vertex), ("mm", static.mm_part),
                ("xum", np.asarray(static.xum_vertex, np.int64) * n_extra
                 + np.asarray(static.xum_channel, np.int64))):
            passes = _occurrence_passes(np.asarray(targets))
            setattr(self, f"n_{name}_passes", len(passes))
            for k, entries in enumerate(passes):
                self.register_buffer(f"{name}_pass{k}", torch.as_tensor(
                    entries, device=device))
        for name, segs in (("pre_bones", static.pre_segments),
                           ("post_bones", static.post_segments)):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(_segment_bones(segs), np.int64), device=device))

    def _register_sdef(self, static: ModelStatic, device):
        """The SDEF vertex subset (skin type SDEF after Model::Normalize)
        and its gathered tables, found on the host once, here, so that the
        per-frame deform does no `nonzero` and no host->device copy:
        `sdef_idx` [S], the two bones `sdef_b0`/`sdef_b1` [S], the first
        weight `sdef_w0` [S] and `sdef_c`/`sdef_r0`/`sdef_r1` [S,3]."""
        idx = np.flatnonzero(np.asarray(static.skin_type) == P.SDEF)
        self.n_sdef = len(idx)
        bones = np.asarray(static.skin_bones)[idx]
        tables = dict(
            sdef_idx=idx.astype(np.int64), sdef_b0=bones[:, 0],
            sdef_b1=bones[:, 1],
            sdef_w0=np.asarray(static.skin_weights)[idx, 0],
            sdef_c=np.asarray(static.sdef_c, np.float32).reshape(-1, 3)[idx],
            sdef_r0=np.asarray(static.sdef_r0, np.float32).reshape(-1, 3)[idx],
            sdef_r1=np.asarray(static.sdef_r1, np.float32).reshape(-1, 3)[idx])
        register_arrays(self, SimpleNamespace(**tables), tables, device)

    n_inst = 1      # one instance; `crowd(n)` gives the view of n

    @property
    def device(self):
        return self.positions.device

    @property
    def n_vertices(self):
        return self.positions.shape[0]

    def passes(self, name: str) -> list[torch.Tensor]:
        """The occurrence passes of the vertex ("vm"), bone ("bm"), UV
        ("um"), extra-UV ("xum", by vertex and channel) or material ("mm",
        by part) morph entries (`_occurrence_passes`)."""
        return [getattr(self, f"{name}_pass{k}")
                for k in range(getattr(self, f"n_{name}_passes"))]

    def instance_rows(self, k: int) -> torch.Tensor:
        """Row of bone `k` in every instance's block of the per-bone state:
        [k] for the rig itself."""
        return torch.full((1,), k, dtype=torch.int64, device=self.device)

    def crowd(self, n_inst: int) -> "CrowdModelTables":
        """The instance-major view of this rig for `n_inst` instances
        (built once per count and device)."""
        key = (n_inst, str(self.device))
        cache = self.__dict__.setdefault("_crowd_views", {})
        if key not in cache:
            cache[key] = CrowdModelTables(self, n_inst)
        return cache[key]


def tile_rows(t: torch.Tensor, n_inst: int) -> torch.Tensor:
    """[K, ...] -> [n_inst*K, ...], instance-major."""
    return t.repeat((n_inst,) + (1,) * (t.dim() - 1))


def tile_index(t: torch.Tensor, n_inst: int, stride: int) -> torch.Tensor:
    """An index table [K, ...] into rows of one instance -> [n_inst*K, ...]
    into instance-major rows: instance i's copy is offset by i*stride;
    negative entries ("none") stay as they are."""
    off = torch.arange(n_inst, device=t.device) * stride
    out = t[None] + off.reshape((n_inst,) + (1,) * t.dim())
    out = torch.where(t[None] < 0, t[None], out)
    return out.reshape((n_inst * t.shape[0],) + t.shape[1:])


class _CrowdFK:
    kind = "fk"

    def __init__(self, seg: FKSegment, n_inst, n_bones):
        self.levels = [tile_index(lv, n_inst, n_bones) for lv in seg.levels]


class _CrowdIK:
    """An IKSegment's group of G chains repeated for every instance: I*G
    independent chains of one shape, solved in the same batched steps."""
    kind = "ik"

    def __init__(self, seg: IKSegment, n_inst, n_bones):
        for name in ("n_links", "loop", "fix_types", "orders", "limited",
                     "codes"):
            setattr(self, name, getattr(seg, name))
        for name in ("links", "link_parent_safe", "targets", "goal_bones"):
            setattr(self, name, tile_index(getattr(seg, name), n_inst,
                                           n_bones))
        for name in ("link_has_parent", "angle_limit", "limits_min",
                     "limits_max"):
            setattr(self, name, tile_rows(getattr(seg, name), n_inst))


class CrowdModelTables:
    """Instance-major view of a ModelTables for a crowd of `n_inst`
    instances of one rig.

    The posing code works on rows gathered and scattered by index tensors
    (bones of a level, chains of an IK group, morph entries), so a crowd is
    posed by the same code on `n_inst * B` bone rows: every per-bone table
    is the rig's repeated per instance, and every index table is the rig's
    repeated with instance i's copy offset by i * B (bones), i * N
    (vertices) or i * M (leaf morph rates). One FK level, one CCD step or
    one morph pass then handles all instances in the launches it takes for
    one. Tables that all instances share (the mesh, the dense skin weights,
    the morph expansion matrix) stay the rig's; the functions that use them
    reshape the state to [n_inst, ...] for one batched product."""

    PER_BONE = ("bone_rest", "local_offset", "append_ratio", "append_rotate",
                "append_translate", "is_ik_link")
    SHARED = ("positions", "normals", "uvs", "triangles", "part_base",
              "tri_part", "skin_bones", "skin_weights", "skin_weight_dense",
              "morph_expand", "n_sdef", "sdef_idx", "sdef_b0", "sdef_b1",
              "sdef_w0", "sdef_c", "sdef_r0", "sdef_r1")

    def __init__(self, rig: ModelTables, n_inst: int):
        b, n = rig.n_bones, rig.n_vertices
        self.rig = rig
        self.host = rig.host
        self.n_inst = n_inst
        self.n_bones = n_inst * b
        self.n_morphs = n_inst * rig.n_morphs
        self.n_vertices = n_inst * n
        self.device = rig.device
        for name in self.SHARED:
            setattr(self, name, getattr(rig, name))
        for name in self.PER_BONE:
            setattr(self, name, tile_rows(getattr(rig, name), n_inst))
        for name in ("bone_parent", "append_parent", "pre_bones",
                     "post_bones", "bm_bone"):
            setattr(self, name, tile_index(getattr(rig, name), n_inst, b))
        n_leaf = rig.morph_expand.shape[1] if rig.n_morphs else 0
        self.vm_morph = tile_index(rig.vm_morph, n_inst, n_leaf)
        self.bm_morph = tile_index(rig.bm_morph, n_inst, n_leaf)
        self.vm_vertex = tile_index(rig.vm_vertex, n_inst, n)
        for name in ("vm_offset", "bm_trans", "bm_rot"):
            setattr(self, name, tile_rows(getattr(rig, name), n_inst))
        self._passes = {
            "vm": [tile_index(e, n_inst, rig.vm_vertex.shape[0])
                   for e in rig.passes("vm")],
            "bm": [tile_index(e, n_inst, rig.bm_bone.shape[0])
                   for e in rig.passes("bm")]}
        self.pre_segments = self._segments(rig.pre_segments, b)
        self.post_segments = self._segments(rig.post_segments, b)

    def _segments(self, segments, n_bones):
        return [(_CrowdFK if seg.kind == "fk" else _CrowdIK)(
            seg, self.n_inst, n_bones) for seg in segments]

    def passes(self, name: str) -> list[torch.Tensor]:
        return self._passes[name]

    def instance_rows(self, k: int) -> torch.Tensor:
        return k + torch.arange(self.n_inst, device=self.device) \
            * self.rig.n_bones
