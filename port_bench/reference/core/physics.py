"""Batched rigid-body physics (XPBD, Jacobi-averaged) for MMD hair/skirts.

Port of `simple_mmd_renderer_tpu/core/physics.py`, same semantics: world
gravity 9.8 * direction * 10 ("world is scaled by 10"), a static ground
plane y=0 (friction 0.265, restitution 0), kinematic bodies driven from
their bones, 6DOF spring joints as positional constraint rows, sphere /
capsule / box contacts (box-box pairs by a separating-axis test with
up-to-4-point corner manifolds), positional Coulomb friction, a contact
velocity pass, then the skinning write-back (Synchronize) and the strict
bodies' translation fix (Fix).

`PhysicsStatic` and `build_physics` are the reference's NumPy build code,
copied (the port imports nothing of the reference). `PhysicsTables` holds
the static tables on the device. Per-body accumulation of constraint rows
stays a dense matmul with the static, count-scaled incidence matrices, as
in the reference: deterministic, with no float atomics.

A crowd is stepped by the same functions on the instance-major view of the
tables (`PhysicsTables.crowd(n)`, see `CrowdPhysicsTables`): n_inst * R
body rows, n_inst * K candidate pairs and n_inst * C joints, every index
table the rig's with instance i's copy offset by i * R. Every contact,
manifold and sort acts along the last axis of one pair's or one body's
row, so no instance sees another. The incidence sums apply the rig's
shared [R, K] matrices to each instance's rows (`_incidence_sum`, one
batched product), never a block-diagonal matrix.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..formats import pmx as P
from ..utils import math3d as m3
from ..utils.device import resolve_device
from .model import (ModelStatic, ModelTables, register_arrays, tile_index,
                    tile_rows)
from .pose import PoseArrays, _set

_EPS = 1e-9


# ---------------------------------------------------------------------------
# Static build (NumPy, copied from the reference)
# ---------------------------------------------------------------------------

@dataclass
class PhysicsStatic:
    n_bodies: int
    n_joints: int
    bone: np.ndarray          # [R] i32 (safe index; -1 -> 0)
    has_bone: np.ndarray      # [R] bool
    kinematic: np.ndarray     # [R] bool
    strict: np.ndarray        # [R] bool
    ghost: np.ndarray         # [R] bool
    shape: np.ndarray         # [R] i32
    dims: np.ndarray          # [R,3]
    inv_mass: np.ndarray      # [R]
    inv_inertia: np.ndarray   # [R,3] local diagonal
    lin_damp: np.ndarray      # [R]
    ang_damp: np.ndarray      # [R]
    friction: np.ndarray      # [R]
    restitution: np.ndarray   # [R]
    rest_quat: np.ndarray     # [R,4] body frame rotation (YXZ euler)
    rest_pos: np.ndarray      # [R,3] body frame origin
    writeback: np.ndarray     # [R] bool — dynamic, non-ghost, last body on bone
    pair_i: np.ndarray        # [Pn] i32 candidate collision pairs
    pair_j: np.ndarray        # [Pn]
    # joints
    j_a: np.ndarray           # [C] i32
    j_b: np.ndarray           # [C]
    j_qa: np.ndarray          # [C,4] constraint frame rotation in body a
    j_ta: np.ndarray          # [C,3] constraint frame origin in body a
    j_qb: np.ndarray          # [C,4]
    j_tb: np.ndarray          # [C,3]
    j_lin_lo: np.ndarray      # [C,3]
    j_lin_hi: np.ndarray      # [C,3]
    j_ang_lo: np.ndarray      # [C,3]
    j_ang_hi: np.ndarray      # [C,3]
    j_k_lin: np.ndarray       # [C,3] spring stiffness
    j_k_ang: np.ndarray       # [C,3]
    body_joint_count: np.ndarray  # [R] joints touching each body (Jacobi avg)
    body_pair_count: np.ndarray   # [R] candidate contacts per body
    # static incidence matrices: constraint topology is static, so
    # S[r, k] = count_scale[r] when row k touches body r turns every Jacobi
    # accumulation into one [R, K] @ [K, 3] matmul — deterministic, where a
    # scatter-add with duplicate indices would sum in no fixed order.
    s_joint_a: np.ndarray     # [R, 6C] (count-scaled, joint row -> body a)
    s_joint_b: np.ndarray     # [R, 6C]
    s_pair_a: np.ndarray      # [R, Pn]
    s_pair_b: np.ndarray      # [R, Pn]


def _shape_inertia(shape, dims, mass):
    """Local diagonal inertia like Bullet's calculateLocalInertia."""
    if mass <= 0:
        return np.zeros(3, np.float32)
    x, y, z = float(dims[0]), float(dims[1]), float(dims[2])
    if shape == P.SHAPE_SPHERE:
        i = 0.4 * mass * x * x
        return np.array([i, i, i], np.float32)
    if shape == P.SHAPE_BOX:
        return (mass / 3.0) * np.array(
            [y * y + z * z, x * x + z * z, x * x + y * y], np.float32)
    # capsule (radius x, cylinder height y, axis Y) — Bullet's approximation
    r, h = x, y
    # treat as box-ish like btCapsuleShape::calculateLocalInertia
    half = np.array([r, r + 0.5 * h, r], np.float32)
    lx, ly, lz = 2 * half
    return (mass / 12.0) * np.array(
        [ly * ly + lz * lz, lx * lx + lz * lz, lx * lx + ly * ly], np.float32)


def _yxz_quat(e):
    """YXZ euler -> quat (body/constraint frames, mmd-bullet_impl.inl:183)."""
    cx, sx = np.cos(e[0] * 0.5), np.sin(e[0] * 0.5)
    cy, sy = np.cos(e[1] * 0.5), np.sin(e[1] * 0.5)
    cz, sz = np.cos(e[2] * 0.5), np.sin(e[2] * 0.5)
    return np.array([
        sx * cy * cz + cx * sy * sz,
        cx * sy * cz - sx * cy * sz,
        cx * cy * sz - sx * sy * cz,
        cx * cy * cz + sx * sy * sz], np.float32)


def _q_conj_np(q):
    return np.array([-q[0], -q[1], -q[2], q[3]], np.float32)


def _q_mul_np(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by + ay * bw + az * bx - ax * bz,
        aw * bz + az * bw + ax * by - ay * bx,
        aw * bw - (ax * bx + ay * by + az * bz)], np.float32)


def _q_rot_np(q, v):
    qv = q[:3]
    t = 2.0 * np.cross(qv, v)
    return v + q[3] * t + np.cross(qv, t)


def build_physics(static: ModelStatic) -> PhysicsStatic:
    bodies = static.rigid_bodies
    joints = static.constraints
    r = len(bodies)
    c = len(joints)

    bone = np.zeros(r, np.int32)
    has_bone = np.zeros(r, bool)
    kin = np.zeros(r, bool)
    strict = np.zeros(r, bool)
    ghost = np.zeros(r, bool)
    shape = np.zeros(r, np.int32)
    dims = np.zeros((r, 3), np.float32)
    inv_mass = np.zeros(r, np.float32)
    inv_inertia = np.zeros((r, 3), np.float32)
    lin_damp = np.zeros(r, np.float32)
    ang_damp = np.zeros(r, np.float32)
    friction = np.zeros(r, np.float32)
    restitution = np.zeros(r, np.float32)
    rest_quat = np.tile(np.array([0, 0, 0, 1], np.float32), (r, 1))
    rest_pos = np.zeros((r, 3), np.float32)
    group = np.zeros(r, np.int32)
    mask = np.zeros(r, np.int32)

    for i, b in enumerate(bodies):
        bone[i] = max(b.bone, 0)
        has_bone[i] = b.bone >= 0
        kin[i] = b.type == P.RIGID_KINEMATIC
        strict[i] = b.type == P.RIGID_PHYSICS_STRICT
        ghost[i] = b.type == P.RIGID_PHYSICS_GHOST
        shape[i] = b.shape
        dims[i] = b.dimensions
        if not kin[i] and b.mass > 0:
            inv_mass[i] = 1.0 / b.mass
            inertia = _shape_inertia(b.shape, b.dimensions, b.mass)
            inv_inertia[i] = np.where(inertia > 0, 1.0 / np.maximum(inertia, 1e-12), 0.0)
        lin_damp[i] = b.linear_damping
        ang_damp[i] = b.angular_damping
        friction[i] = b.friction
        restitution[i] = b.restitution
        rest_quat[i] = _yxz_quat(b.rotation)
        rest_pos[i] = b.position
        group[i] = b.group
        mask[i] = b.mask

    # last dynamic non-ghost body per bone wins the skinning write-back
    writeback = np.zeros(r, bool)
    seen = set()
    for i in range(r - 1, -1, -1):
        if (not kin[i]) and (not ghost[i]) and has_bone[i]:
            bi = int(bone[i])
            if bi not in seen:
                writeback[i] = True
                seen.add(bi)

    # candidate pairs with the reference's Bullet-style filter:
    # (1<<group_a) & mask_b  and  (1<<group_b) & mask_a, at least one dynamic
    pi, pj = [], []
    for i in range(r):
        for j in range(i + 1, r):
            if kin[i] and kin[j]:
                continue
            if ((1 << group[i]) & mask[j]) and ((1 << group[j]) & mask[i]):
                pi.append(i)
                pj.append(j)

    j_a = np.zeros(c, np.int32)
    j_b = np.zeros(c, np.int32)
    j_qa = np.tile(np.array([0, 0, 0, 1], np.float32), (c, 1))
    j_ta = np.zeros((c, 3), np.float32)
    j_qb = np.tile(np.array([0, 0, 0, 1], np.float32), (c, 1))
    j_tb = np.zeros((c, 3), np.float32)
    j_lin_lo = np.zeros((c, 3), np.float32)
    j_lin_hi = np.zeros((c, 3), np.float32)
    j_ang_lo = np.zeros((c, 3), np.float32)
    j_ang_hi = np.zeros((c, 3), np.float32)
    j_k_lin = np.zeros((c, 3), np.float32)
    j_k_ang = np.zeros((c, 3), np.float32)

    for i, jt in enumerate(joints):
        a = max(jt.body_a, 0)
        b = max(jt.body_b, 0)
        j_a[i], j_b[i] = a, b
        qc = _yxz_quat(jt.rotation)
        tc = jt.position.astype(np.float32)
        # localize the constraint frame into each body's rest frame
        for q_out, t_out, body in ((j_qa, j_ta, a), (j_qb, j_tb, b)):
            qi = _q_conj_np(rest_quat[body])
            q_out[i] = _q_mul_np(qi, qc)
            t_out[i] = _q_rot_np(qi, tc - rest_pos[body])
        j_lin_lo[i], j_lin_hi[i] = jt.pos_lo, jt.pos_hi
        j_ang_lo[i], j_ang_hi[i] = jt.rot_lo, jt.rot_hi
        j_k_lin[i] = jt.spring_translate
        j_k_ang[i] = jt.spring_rotate

    body_joint_count = np.ones(r, np.float32)
    for i in range(c):
        body_joint_count[j_a[i]] += 1
        body_joint_count[j_b[i]] += 1
    body_pair_count = np.ones(r, np.float32)
    for a, b in zip(pi, pj):
        body_pair_count[a] += 1
        body_pair_count[b] += 1

    def incidence(idx, count):
        s = np.zeros((r, len(idx)), np.float32)
        s[idx, np.arange(len(idx))] = 1.0 / count[idx]
        return s

    # joint rows are laid out axis-major then (hard, spring):
    # [x*C, y*C, z*C] twice — matching _joint_pass's rows3/tile order
    idx6_a = np.tile(np.tile(j_a, 3), 2)
    idx6_b = np.tile(np.tile(j_b, 3), 2)
    pi_arr = np.asarray(pi, np.int32)
    pj_arr = np.asarray(pj, np.int32)

    return PhysicsStatic(
        n_bodies=r, n_joints=c, bone=bone, has_bone=has_bone, kinematic=kin,
        strict=strict, ghost=ghost, shape=shape, dims=dims, inv_mass=inv_mass,
        inv_inertia=inv_inertia, lin_damp=lin_damp, ang_damp=ang_damp,
        friction=friction, restitution=restitution,
        rest_quat=rest_quat, rest_pos=rest_pos,
        writeback=writeback,
        pair_i=pi_arr, pair_j=pj_arr,
        j_a=j_a, j_b=j_b, j_qa=j_qa, j_ta=j_ta, j_qb=j_qb, j_tb=j_tb,
        j_lin_lo=j_lin_lo, j_lin_hi=j_lin_hi, j_ang_lo=j_ang_lo,
        j_ang_hi=j_ang_hi, j_k_lin=j_k_lin, j_k_ang=j_k_ang,
        body_joint_count=body_joint_count, body_pair_count=body_pair_count,
        s_joint_a=incidence(idx6_a, body_joint_count),
        s_joint_b=incidence(idx6_b, body_joint_count),
        s_pair_a=incidence(pi_arr, body_pair_count),
        s_pair_b=incidence(pj_arr, body_pair_count))


@dataclass
class PhysicsState:
    pos: torch.Tensor     # [R,3]
    quat: torch.Tensor    # [R,4]
    vel: torch.Tensor     # [R,3]
    omega: torch.Tensor   # [R,3]


class PhysicsTables(nn.Module):
    """Device tables of a PhysicsStatic, plus the host-static subsets the
    step reads (write-back bodies, box-box pairs, shape flags)."""

    ARRAYS = ("bone", "shape", "dims", "inv_mass", "inv_inertia",
              "lin_damp", "ang_damp", "friction", "restitution", "rest_quat",
              "rest_pos", "pair_i", "pair_j", "j_a", "j_b", "j_qa", "j_ta",
              "j_qb", "j_tb", "j_lin_lo", "j_lin_hi", "j_ang_lo",
              "j_ang_hi", "j_k_lin", "j_k_ang", "s_joint_a", "s_joint_b",
              "s_pair_a", "s_pair_b")

    def __init__(self, ps: PhysicsStatic, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.host = ps
        self.n_bodies = ps.n_bodies
        self.n_joints = ps.n_joints
        self.n_pairs = len(ps.pair_i)
        register_arrays(self, ps, self.ARRAYS, device)
        sh = np.asarray(ps.shape)
        self.has_box = bool((sh == P.SHAPE_BOX).any())
        self.has_cap = bool((sh == P.SHAPE_CAPSULE).any())
        wb = np.nonzero(ps.writeback)[0]
        bb = np.nonzero((sh[ps.pair_i] == P.SHAPE_BOX)
                        & (sh[ps.pair_j] == P.SHAPE_BOX))[0] \
            if len(ps.pair_i) else np.zeros(0, np.int64)
        extra = dict(wb_idx=wb.astype(np.int64),
                     wb_bone=np.asarray(ps.bone)[wb].astype(np.int64),
                     box_pairs=bb.astype(np.int64))
        for name, arr in extra.items():
            self.register_buffer(name, torch.as_tensor(arr, device=device))
        self.register_buffer("corner_signs", torch.as_tensor(_CORNER_SIGNS,
                                                             device=device))
        self.strict_ids = [i for i in range(ps.n_bodies)
                           if ps.strict[i] and ps.writeback[i]]

    n_inst = 1      # one instance; `crowd(n)` gives the view of n

    @property
    def device(self):
        return self.inv_mass.device

    def crowd(self, n_inst: int, n_bones: int) -> "CrowdPhysicsTables":
        """The instance-major view for `n_inst` instances of a rig of
        `n_bones` bones (built once per count and device)."""
        key = (n_inst, n_bones, str(self.device))
        cache = self.__dict__.setdefault("_crowd_views", {})
        if key not in cache:
            cache[key] = CrowdPhysicsTables(self, n_inst, n_bones)
        return cache[key]


class CrowdPhysicsTables:
    """Instance-major view of a PhysicsTables for a crowd: per-body,
    per-pair and per-joint tables repeated per instance, body indices
    offset by i * R, bone indices by i * B and box-pair indices by i * K.
    The incidence matrices stay the rig's [R, K]: `_incidence_sum` applies
    them per instance."""

    PER_ROW = ("shape", "dims", "inv_mass", "inv_inertia", "lin_damp",
               "ang_damp", "friction", "restitution", "rest_quat", "rest_pos",
               "j_qa", "j_ta", "j_qb", "j_tb", "j_lin_lo", "j_lin_hi",
               "j_ang_lo", "j_ang_hi", "j_k_lin", "j_k_ang")
    SHARED = ("s_joint_a", "s_joint_b", "s_pair_a", "s_pair_b", "has_box",
              "has_cap", "strict_ids", "host", "device", "corner_signs")

    def __init__(self, ps: PhysicsTables, n_inst: int, n_bones: int):
        self.n_inst = n_inst
        self.n_bodies = n_inst * ps.n_bodies
        self.n_joints = n_inst * ps.n_joints
        self.n_pairs = n_inst * ps.n_pairs
        for name in self.SHARED:
            setattr(self, name, getattr(ps, name))
        for name in self.PER_ROW:
            setattr(self, name, tile_rows(getattr(ps, name), n_inst))
        for name in ("pair_i", "pair_j", "j_a", "j_b", "wb_idx"):
            setattr(self, name, tile_index(getattr(ps, name), n_inst,
                                           ps.n_bodies))
        for name in ("bone", "wb_bone"):
            setattr(self, name, tile_index(getattr(ps, name), n_inst,
                                           n_bones))
        self.box_pairs = tile_index(ps.box_pairs, n_inst, ps.n_pairs)


def _incidence_sum(ps, s, rows, groups):
    """Per-body sum of constraint rows through the count-scaled incidence
    matrix s [R, groups*K] -> [R, D]. `rows` [groups*K, D] are laid out
    group-major (axis or manifold slot), then the rig's K constraints. On a
    crowd view the rows are [groups, n_inst, K] and every instance's
    [groups*K] rows meet the same shared matrix in one batched product ->
    [n_inst*R, D]."""
    if ps.n_inst == 1:
        return s @ rows
    d = rows.shape[-1]
    per_inst = rows.reshape(groups, ps.n_inst, -1, d).transpose(0, 1)
    return (s @ per_inst.reshape(ps.n_inst, -1, d)).reshape(-1, d)


def _vec(values, like):
    """Small constant vector on `like`'s device, made there by fills (no
    host copy: `out[i] = v` would copy a host scalar and synchronise)."""
    out = torch.zeros(len(values), dtype=torch.float32, device=like.device)
    for i, v in enumerate(values):
        if v:
            out[i].fill_(float(v))
    return out


def _top_k(x, k):
    """lax.top_k over the last axis: descending, ties keep index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take3(p, idx):
    """p [..., N, 3] gathered at idx [..., K] along N -> [..., K, 3]."""
    return torch.gather(p, -2, idx[..., None].expand(idx.shape + (3,)))


# ---------------------------------------------------------------------------
# Animation-driven body targets (PoserMotionState::Reset)
# ---------------------------------------------------------------------------

def _mat_to_quat(m):
    """Rotation 3x3 -> quaternion (x,y,z,w)."""
    t = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    qw = torch.sqrt(torch.clamp(1.0 + t, min=1e-12)) * 0.5
    den = 4 * torch.clamp(qw, min=1e-6)
    qx = (m[..., 2, 1] - m[..., 1, 2]) / den
    qy = (m[..., 0, 2] - m[..., 2, 0]) / den
    qz = (m[..., 1, 0] - m[..., 0, 1]) / den
    return m3.quat_normalize(torch.stack([qx, qy, qz, qw], -1))


def body_targets(ps: PhysicsTables, pose: PoseArrays):
    """World transform each body would have if rigidly following its
    animated bone: W = skin[bone] @ rest_frame."""
    skin = pose.skin[ps.bone]
    rot = skin[:, :3, :3]
    pos = torch.einsum("rij,rj->ri", rot, ps.rest_pos) + skin[:, :3, 3]
    quat = m3.quat_mul(_mat_to_quat(rot), ps.rest_quat)
    return pos, quat


def physics_reset(ps: PhysicsTables, pose: PoseArrays) -> PhysicsState:
    """Seed body states from the current animation pose, zero velocities."""
    pos, quat = body_targets(ps, pose)
    return PhysicsState(pos=pos, quat=quat, vel=torch.zeros_like(pos),
                        omega=torch.zeros_like(pos))


# ---------------------------------------------------------------------------
# Contacts
# ---------------------------------------------------------------------------

def _capsule_segment(dims, pos, quat):
    """Capsule axis endpoints (axis = local Y, half-length h/2)."""
    half = dims[..., 1:2] * 0.5
    axis = m3.quat_rotate(quat, _vec((0.0, 1.0, 0.0), pos).expand(pos.shape))
    return pos - axis * half, pos + axis * half


def _closest_on_segment(p, a, b):
    ab = b - a
    t = torch.sum((p - a) * ab, -1) / torch.clamp(torch.sum(ab * ab, -1),
                                                  min=_EPS)
    t = torch.clamp(t, 0.0, 1.0)
    return a + t[..., None] * ab


def _segment_segment(a0, a1, b0, b1):
    """Approximate closest points between segments (iterative projection)."""
    p = (a0 + a1) * 0.5
    q = _closest_on_segment(p, b0, b1)
    for _ in range(3):
        p = _closest_on_segment(q, a0, a1)
        q = _closest_on_segment(p, b0, b1)
    return p, q


def _point_box_depth(p_local, half):
    """Penetration of a point into an axis-aligned box (local frame) ->
    (depth, normal_local): depth > 0 when inside."""
    d = half - torch.abs(p_local)
    inside = torch.all(d > 0, -1)
    axis = torch.argmin(d, -1)
    sgn = torch.sign(torch.gather(p_local, -1, axis[..., None]))[..., 0]
    n_local = (torch.nn.functional.one_hot(axis, 3).to(p_local.dtype)
               * sgn[..., None])
    depth_in = torch.gather(d, -1, axis[..., None])[..., 0]
    clamped = torch.minimum(torch.maximum(p_local, -half), half)
    out_vec = p_local - clamped
    out_dist = torch.linalg.vector_norm(out_vec, dim=-1)
    n_out = out_vec / torch.clamp(out_dist, min=_EPS)[..., None]
    depth = torch.where(inside, depth_in, -out_dist)
    normal = torch.where(inside[..., None], n_local, n_out)
    return depth, normal


def _sphere_rad(shape, dims):
    zero = torch.zeros_like(dims[..., 0])
    return torch.where(shape == P.SHAPE_SPHERE, dims[..., 0],
                       torch.where(shape == P.SHAPE_CAPSULE, dims[..., 0],
                                   zero))


# manifold slots per candidate pair / per ground contact (Bullet's
# persistent manifolds hold up to 4 points)
PAIR_MANIFOLD = 4
GROUND_MANIFOLD = 4
_NO_CONTACT = -1e9   # inactive-slot depth: stays negative under any motion

# Jacobi rounds of the post-solve contact velocity pass
VELOCITY_PASS_ITERS = 4

# a box's corners in units of its half extents (`PhysicsTables.corner_signs`)
_CORNER_SIGNS = np.asarray(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
    np.float32)  # [8,3]


def _box_box_manifold(xi, qi, di, xj, qj, dj, corners):
    """SAT + corner manifold for box-box pairs (vectorized over K; `corners`
    the [8,3] corner signs) -> (point [K,4,3], normal [K,4,3] oriented
    j->i, depth [K,4]), deepest slot first, signed."""
    ri = m3.quat_to_mat3(qi)            # [K,3,3], columns = local axes
    rj = m3.quat_to_mat3(qj)
    d = xi - xj
    k = xi.shape[0]

    face_i = ri.transpose(1, 2)         # rows = world axes
    face_j = rj.transpose(1, 2)
    cross = m3.cross(face_i[:, :, None, :], face_j[:, None, :, :])
    axes = torch.cat([face_i, face_j, cross.reshape(-1, 9, 3)], 1)
    norm = torch.linalg.vector_norm(axes, dim=-1)                 # [K,15]
    unit = axes / torch.clamp(norm, min=_EPS)[..., None]
    ext_i = torch.sum(di[:, None, :] * torch.abs(
        torch.einsum("kna,kab->knb", unit, ri)), -1)
    ext_j = torch.sum(dj[:, None, :] * torch.abs(
        torch.einsum("kna,kab->knb", unit, rj)), -1)
    sep = torch.abs(torch.einsum("kna,ka->kn", unit, d))
    overlap = ext_i + ext_j - sep
    overlap = torch.where(norm > 1e-6, overlap,
                          torch.full_like(overlap, float("inf")))
    k_min = torch.argmin(overlap, dim=1)
    sat_depth = torch.gather(overlap, 1, k_min[:, None])[:, 0]
    axis = unit[torch.arange(k, device=xi.device), k_min]
    axis = axis * torch.where(torch.sum(axis * d, -1) >= 0, 1.0, -1.0)[:, None]

    cj_w = xj[:, None, :] + torch.einsum(
        "kab,knb->kna", rj, corners[None] * dj[:, None, :])       # [K,8,3]
    ci_w = xi[:, None, :] + torch.einsum(
        "kab,knb->kna", ri, corners[None] * di[:, None, :])
    lj_in_i = torch.einsum("kba,knb->kna", ri, cj_w - xi[:, None, :])
    dj_in_i, _ = _point_box_depth(lj_in_i, di[:, None, :])
    li_in_j = torch.einsum("kba,knb->kna", rj, ci_w - xj[:, None, :])
    di_in_j, _ = _point_box_depth(li_in_j, dj[:, None, :])
    cand_p = torch.cat([cj_w, ci_w], 1)                           # [K,16,3]
    cand_d = torch.minimum(torch.cat([dj_in_i, di_in_j], 1),
                           sat_depth[:, None])

    vals, idx = _top_k(cand_d, PAIR_MANIFOLD)                     # [K,4]
    pts = _take3(cand_p, idx)
    any_corner = vals[:, 0] > 0
    mid = (xi + xj) * 0.5
    depth0 = torch.where(any_corner, vals[:, 0], sat_depth)
    point0 = torch.where(any_corner[:, None], pts[:, 0], mid)
    rest_d = torch.where(any_corner[:, None], vals[:, 1:],
                         torch.full_like(vals[:, 1:], _NO_CONTACT))
    depth = torch.cat([depth0[:, None], rest_d], 1)
    point = torch.cat([point0[:, None], pts[:, 1:]], 1)
    normal = axis[:, None, :].expand(point.shape)
    return point, normal, depth


def pair_contacts(ps: PhysicsTables, pos, quat):
    """Manifold contacts per candidate pair -> (point [K,M,3], normal
    [K,M,3] i<-j, depth [K,M]), deepest slot first, signed. M is 1 when no
    candidate pair is box-box, else PAIR_MANIFOLD."""
    dev = pos.device
    if ps.n_pairs == 0:
        z = torch.zeros((0, 1, 3), dtype=torch.float32, device=dev)
        return z, z, torch.zeros((0, 1), dtype=torch.float32, device=dev)
    i, j = ps.pair_i, ps.pair_j
    si, sj = ps.shape[i], ps.shape[j]
    di, dj = ps.dims[i], ps.dims[j]
    xi, xj = pos[i], pos[j]
    qi, qj = quat[i], quat[j]

    # representative segment per body: capsule -> its axis, else its centre
    a0i, a1i = _capsule_segment(di, xi, qi)
    a0j, a1j = _capsule_segment(dj, xj, qj)
    cap_i = (si == P.SHAPE_CAPSULE)[..., None]
    cap_j = (sj == P.SHAPE_CAPSULE)[..., None]
    a0i = torch.where(cap_i, a0i, xi)
    a1i = torch.where(cap_i, a1i, xi)
    a0j = torch.where(cap_j, a0j, xj)
    a1j = torch.where(cap_j, a1j, xj)
    pi_, pj_ = _segment_segment(a0i, a1i, a0j, a1j)

    ri = _sphere_rad(si, di)
    rj = _sphere_rad(sj, dj)

    delta = pi_ - pj_
    dist = torch.linalg.vector_norm(delta, dim=-1)
    n_ss = delta / torch.clamp(dist, min=_EPS)[..., None]
    depth_ss = ri + rj - dist
    point_ss = (pi_ + pj_) * 0.5

    def vs_box(box_x, box_q, box_half, other_p, other_r):
        local = m3.quat_rotate(m3.quat_conj(box_q), other_p - box_x)
        depth, n_local = _point_box_depth(local, box_half)
        return depth + other_r, m3.quat_rotate(box_q, n_local)

    box_i = si == P.SHAPE_BOX
    box_j = sj == P.SHAPE_BOX
    depth_ib, n_ib = vs_box(xi, qi, di, pj_, rj)
    depth_jb, n_jb = vs_box(xj, qj, dj, pi_, ri)

    jb = box_j & ~box_i
    ib = box_i & ~box_j
    depth1 = torch.where(jb, depth_jb, torch.where(ib, depth_ib, depth_ss))
    normal1 = torch.where(jb[..., None], n_jb,
                          torch.where(ib[..., None], -n_ib, n_ss))
    point1 = point_ss

    if ps.box_pairs.shape[0] == 0:
        return point1[:, None, :], normal1[:, None, :], depth1[:, None]

    bb = ps.box_pairs
    pm, nm, dm = _box_box_manifold(xi[bb], qi[bb], di[bb],
                                   xj[bb], qj[bb], dj[bb], ps.corner_signs)
    k = depth1.shape[0]
    depth = torch.cat([depth1[:, None], torch.full(
        (k, PAIR_MANIFOLD - 1), _NO_CONTACT, dtype=torch.float32,
        device=dev)], 1)
    point = point1[:, None, :].expand(k, PAIR_MANIFOLD, 3).clone()
    normal = normal1[:, None, :].expand(k, PAIR_MANIFOLD, 3).clone()
    depth[bb] = dm
    point[bb] = pm
    normal[bb] = nm
    return point, normal, depth


def ground_contacts(ps: PhysicsTables, pos, quat):
    """Manifold contacts against the static y=0 plane -> (depth [R,G],
    point [R,G,3]), deepest slot first, signed. G is 4 with boxes in the
    rig, 2 with capsules, else 1."""
    shape, dims = ps.shape, ps.dims
    r = _sphere_rad(shape, dims)
    is_cap = shape == P.SHAPE_CAPSULE
    is_box = shape == P.SHAPE_BOX
    is_sph = ~is_cap & ~is_box
    g_slots = GROUND_MANIFOLD if ps.has_box else (2 if ps.has_cap else 1)

    a0, a1 = _capsule_segment(dims, pos, quat)
    ends = torch.stack([a0, a1], 1)                               # [R,2,3]
    d_cap = r[:, None] - ends[..., 1]
    d_sph = (r - pos[..., 1])[:, None]
    cand_p = [ends, pos[:, None, :]]
    cand_d = [torch.where(is_cap[:, None], d_cap,
                          torch.full_like(d_cap, _NO_CONTACT)),
              torch.where(is_sph[:, None], d_sph,
                          torch.full_like(d_sph, _NO_CONTACT))]
    if ps.has_box:
        local = ps.corner_signs[None, :, :] * dims[:, None, :]
        world = m3.quat_rotate(quat[:, None, :], local) + pos[:, None, :]
        cand_p.insert(0, world)
        cand_d.insert(0, torch.where(is_box[:, None], -world[..., 1],
                                     torch.full_like(world[..., 1],
                                                     _NO_CONTACT)))
    cand_p = torch.cat(cand_p, 1)
    cand_d = torch.cat(cand_d, 1)
    depth, idx = _top_k(cand_d, g_slots)                          # [R,G]
    return depth, _take3(cand_p, idx)


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------

def _inv_inertia_world(ps, quat):
    rot = m3.quat_to_mat3(quat)
    return torch.einsum("rij,rj,rkj->rik", rot, ps.inv_inertia, rot)


def _quad(v, m):
    """einsum('ki,kij,kj->k', v, m, v)."""
    return torch.einsum("ki,kij,kj->k", v, m, v)


def _mv(m, v):
    """einsum('kij,kj->ki', m, v)."""
    return torch.einsum("kij,kj->ki", m, v)


def _apply_position_corrections(ps, pos, quat, idx_a, idx_b, n, c, r_a, r_b,
                                alpha, scat, dt, iiw=None):
    """Batched XPBD positional constraint projection with Jacobi averaging:
    per-body accumulation is a dense matmul with the count-scaled static
    incidence matrices `scat` = (S_a [R,K], S_b [R,K], row groups in K; see
    `_incidence_sum`)."""
    inv_m = ps.inv_mass
    if iiw is None:
        iiw = _inv_inertia_world(ps, quat)
    s_a, s_b, groups = scat
    ra_x_n = m3.cross(r_a, n)
    rb_x_n = m3.cross(r_b, n)
    w_a = inv_m[idx_a] + _quad(ra_x_n, iiw[idx_a])
    w_b = inv_m[idx_b] + _quad(rb_x_n, iiw[idx_b])
    denom = w_a + w_b + alpha / (dt * dt)
    lam = -c / torch.clamp(denom, min=_EPS)
    p = lam[..., None] * n

    dpos_a = p * inv_m[idx_a][..., None]
    dpos_b = -p * inv_m[idx_b][..., None]
    dw_a = _mv(iiw[idx_a], m3.cross(r_a, p))
    dw_b = -_mv(iiw[idx_b], m3.cross(r_b, p))
    acc = _incidence_sum(ps, s_a, torch.cat([dpos_a, dw_a], -1), groups) \
        + _incidence_sum(ps, s_b, torch.cat([dpos_b, dw_b], -1), groups)
    pos = pos + acc[:, :3]
    quat = _apply_small_rotation(quat, acc[:, 3:])
    return pos, quat


def _apply_ground_correction(ps, pos, quat, n, c, r, g_slots, dt, iiw):
    """Positional correction against the static ground: flat manifold rows
    [R*G] (slot-minor, row k belongs to body k // G) apply directly."""
    inv_m = ps.inv_mass
    im = torch.repeat_interleave(inv_m, g_slots)
    iiw_r = torch.repeat_interleave(iiw, g_slots, dim=0)
    r_x_n = m3.cross(r, n)
    w = im + _quad(r_x_n, iiw_r)
    lam = -c / torch.clamp(w, min=_EPS)
    p = lam[..., None] * n
    dp = (p * im[..., None]).reshape(-1, g_slots, 3).sum(1)
    pos = pos + dp
    torque = m3.cross(r, p).reshape(-1, g_slots, 3).sum(1)
    dw = _mv(iiw, torque)
    return pos, _apply_small_rotation(quat, dw)


def _apply_velocity_corrections(ps, vel, omega, idx_a, idx_b, n, dv, r_a,
                                r_b, scat, iiw):
    """Velocity-level impulse rows with the same incidence aggregation."""
    inv_m = ps.inv_mass
    s_a, s_b, groups = scat
    ra_x_n = m3.cross(r_a, n)
    rb_x_n = m3.cross(r_b, n)
    w_a = inv_m[idx_a] + _quad(ra_x_n, iiw[idx_a])
    w_b = inv_m[idx_b] + _quad(rb_x_n, iiw[idx_b])
    lam = dv / torch.clamp(w_a + w_b, min=_EPS)
    p = lam[..., None] * n
    dvel_a = p * inv_m[idx_a][..., None]
    dvel_b = -p * inv_m[idx_b][..., None]
    dw_a = _mv(iiw[idx_a], m3.cross(r_a, p))
    dw_b = -_mv(iiw[idx_b], m3.cross(r_b, p))
    acc = _incidence_sum(ps, s_a, torch.cat([dvel_a, dw_a], -1), groups) \
        + _incidence_sum(ps, s_b, torch.cat([dvel_b, dw_b], -1), groups)
    return vel + acc[:, :3], omega + acc[:, 3:]


def _apply_small_rotation(quat, w):
    dq = m3.quat_mul(torch.cat([w, torch.zeros_like(w[..., :1])], -1), quat)
    return m3.quat_normalize(quat + 0.5 * dq)


def _apply_angular_corrections(ps, quat, idx_a, idx_b, axis, c, alpha,
                               scat, dt, iiw=None):
    if iiw is None:
        iiw = _inv_inertia_world(ps, quat)
    s_a, s_b, groups = scat
    w_a = _quad(axis, iiw[idx_a])
    w_b = _quad(axis, iiw[idx_b])
    denom = w_a + w_b + alpha / (dt * dt)
    lam = -c / torch.clamp(denom, min=_EPS)
    p = lam[..., None] * axis
    dw_a = _mv(iiw[idx_a], p)
    dw_b = -_mv(iiw[idx_b], p)
    return _apply_small_rotation(
        quat, _incidence_sum(ps, s_a, dw_a, groups)
        + _incidence_sum(ps, s_b, dw_b, groups))


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _joint_pass(ps: PhysicsTables, pos, quat, dt, iiw=None):
    """All 6DOF joint axes as batched constraint rows: 6C linear rows (3 hard
    limit + 3 spring), then 6C angular rows."""
    if ps.n_joints == 0:
        return pos, quat
    a, b = ps.j_a, ps.j_b
    c_n = ps.n_joints
    scat = (ps.s_joint_a, ps.s_joint_b, 6)   # rows: (hard, spring) x axis

    qa = m3.quat_mul(quat[a], ps.j_qa)                 # constraint frame (A)
    qb = m3.quat_mul(quat[b], ps.j_qb)
    pa = pos[a] + m3.quat_rotate(quat[a], ps.j_ta)
    pb = pos[b] + m3.quat_rotate(quat[b], ps.j_tb)
    frame = m3.quat_to_mat3(qa)                        # columns = axes

    lo, hi, k_lin = ps.j_lin_lo, ps.j_lin_hi, ps.j_k_lin
    e = _mv(frame.transpose(1, 2), pb - pa)
    free = lo > hi
    target = _clip(e, torch.minimum(lo, hi), torch.maximum(lo, hi))
    zero = torch.zeros_like(e)
    viol = torch.where(free, zero, e - target)
    spring_on = k_lin > 0
    spring_viol = torch.where(spring_on & (torch.abs(viol) < 1e-12),
                              e - 0.0, zero)
    alpha_spring = torch.where(spring_on,
                               1.0 / torch.clamp(k_lin, min=1e-6),
                               torch.full_like(k_lin, 1e12))

    r_a = pa - pos[a]
    r_b = pb - pos[b]
    axes = frame.transpose(1, 2)                       # [C,3(axis),3]

    def rows3(vals):   # [C,3] -> [3C], axis-major
        return vals.T.reshape(-1)

    def rows3v(vals):  # [C,3,3] by axis -> [3C,3]
        return vals.transpose(0, 1).reshape(-1, 3)

    idx6_a = a.repeat(3).repeat(2)
    idx6_b = b.repeat(3).repeat(2)
    zeros3 = torch.zeros(3 * c_n, dtype=torch.float32, device=pos.device)
    n_rows = torch.cat([rows3v(axes), rows3v(axes)])
    pos, quat = _apply_position_corrections(
        ps, pos, quat, idx6_a, idx6_b, n_rows,
        torch.cat([-rows3(viol), -rows3(spring_viol)]),
        rows3v(r_a[:, None, :].expand(c_n, 3, 3)).repeat(2, 1),
        rows3v(r_b[:, None, :].expand(c_n, 3, 3)).repeat(2, 1),
        torch.cat([zeros3, rows3(alpha_spring)]), scat, dt, iiw=iiw)

    # angular: relative rotation decomposed on the A-frame axes (XYZ euler)
    q_rel = m3.quat_mul(m3.quat_conj(qa), qb)
    ang = m3.quat_to_euler(q_rel, "xyz")
    alo, ahi, k_ang = ps.j_ang_lo, ps.j_ang_hi, ps.j_k_ang
    afree = alo > ahi
    atarget = _clip(ang, torch.minimum(alo, ahi), torch.maximum(alo, ahi))
    zero = torch.zeros_like(ang)
    aviol = torch.where(afree, zero, ang - atarget)
    aspring_on = k_ang > 0
    aspring_viol = torch.where(aspring_on & (torch.abs(aviol) < 1e-12),
                               ang, zero)
    aalpha = torch.where(aspring_on, 1.0 / torch.clamp(k_ang, min=1e-6),
                         torch.full_like(k_ang, 1e12))
    quat = _apply_angular_corrections(
        ps, quat, idx6_a, idx6_b, n_rows,
        torch.cat([-rows3(aviol), -rows3(aspring_viol)]),
        torch.cat([zeros3, rows3(aalpha)]), scat, dt, iiw=iiw)
    return pos, quat


def _slot_rows(ps, c_point, c_n, c_depth0):
    """Pair contact rows, [K, M] manifold slots flattened slot-major ->
    (i, j, normal [MK,3], point [MK,3], depth0 [MK], incidence, M), with
    M = 0 for single-slot rigs (no slot axis)."""
    if c_depth0.dim() == 2:
        m = c_depth0.shape[1]
        return (ps.pair_i.repeat(m), ps.pair_j.repeat(m),
                c_n.transpose(0, 1).reshape(-1, 3),
                c_point.transpose(0, 1).reshape(-1, 3),
                c_depth0.T.reshape(-1),
                (ps.s_pair_a.repeat(1, m), ps.s_pair_b.repeat(1, m), m), m)
    return (ps.pair_i, ps.pair_j, c_n, c_point, c_depth0,
            (ps.s_pair_a, ps.s_pair_b, 1), 0)


def _contact_pass(ps: PhysicsTables, pos, quat, cfg, dt, cache,
                  pos_detect, pos_prev, iiw=None):
    """Resolve the substep's cached contact set (detected once per
    substep): penetration re-estimated per iteration, friction as the
    positional Coulomb model capped at mu * normal correction."""
    inv_m = ps.inv_mass
    fric = ps.friction
    (c_point, c_n, c_depth0, c_la, c_lb, g_depth0, g_point, g_l,
     g_reff) = cache
    if ps.n_pairs:
        i, j, n_f, p_f, d0_f, scat, m_slots = _slot_rows(
            ps, c_point, c_n, c_depth0)
        if c_la is not None:
            la_f = (c_la.transpose(0, 1).reshape(-1, 3) if m_slots else c_la)
            lb_f = (c_lb.transpose(0, 1).reshape(-1, 3) if m_slots else c_lb)
            pt_a = pos[i] + m3.quat_rotate(quat[i], la_f)
            pt_b = pos[j] + m3.quat_rotate(quat[j], lb_f)
            depth_raw = d0_f - torch.sum(n_f * (pt_a - pt_b), -1)
            r_a = pt_a - pos[i]
            r_b = pt_b - pos[j]
        else:
            moved = torch.sum(n_f * ((pos[i] - pos_detect[i])
                                     - (pos[j] - pos_detect[j])), -1)
            depth_raw = d0_f - moved
            r_a = p_f - pos[i]
            r_b = p_f - pos[j]
        if m_slots:
            act = (depth_raw > 0).reshape(m_slots, -1)
            inv_act = (1.0 / torch.clamp(act.to(torch.float32).sum(0),
                                         min=1.0)).repeat(m_slots)
            depth = torch.clamp(depth_raw, min=0.0) * inv_act
        else:
            inv_act = None
            depth = torch.clamp(depth_raw, min=0.0)
        pos, quat = _apply_position_corrections(
            ps, pos, quat, i, j, n_f, -depth, r_a, r_b,
            torch.zeros_like(depth), scat, dt, iiw=iiw)
        # friction: combined mu = mu_i * mu_j (Bullet's combination rule)
        mu = fric[i] * fric[j]
        rel = (pos[i] - pos_prev[i]) - (pos[j] - pos_prev[j])
        t_vec = rel - torch.sum(rel * n_f, -1, keepdim=True) * n_f
        t_len = torch.linalg.vector_norm(t_vec, dim=-1)
        t_dir = t_vec / torch.clamp(t_len, min=_EPS)[..., None]
        corr = torch.minimum(t_len if inv_act is None else t_len * inv_act,
                             mu * depth)
        corr = torch.where(depth > 0, corr, torch.zeros_like(corr))
        pos, quat = _apply_position_corrections(
            ps, pos, quat, i, j, t_dir, corr, r_a, r_b,
            torch.zeros_like(corr), scat, dt, iiw=iiw)
    # ground plane: G manifold slots per body as flat [R*G] rows
    g_slots = g_depth0.shape[1]
    gd0 = g_depth0.reshape(-1)
    gp_f = g_point.reshape(-1, 3)
    if g_l is not None:
        gl_f = g_l.reshape(-1, 3)
        quat_r = torch.repeat_interleave(quat, g_slots, dim=0)
        pos_r = torch.repeat_interleave(pos, g_slots, dim=0)
        feat = pos_r + m3.quat_rotate(quat_r, gl_f)
        depth = g_reff.reshape(-1) - feat[..., 1]
        r_g = feat - pos_r
    else:
        depth = gd0 - torch.repeat_interleave(pos[:, 1] - pos_detect[:, 1],
                                              g_slots)
        r_g = gp_f - torch.repeat_interleave(pos_detect, g_slots, dim=0)
    depth = (torch.clamp(depth, min=0.0) if cfg.has_floor
             else torch.zeros_like(depth))
    dyn = inv_m > 0
    inv_act_g = 1.0 / torch.clamp(
        (depth > 0).reshape(-1, g_slots).to(torch.float32).sum(1), min=1.0)
    push = torch.where(torch.repeat_interleave(dyn, g_slots), depth,
                       torch.zeros_like(depth)) \
        * torch.repeat_interleave(inv_act_g, g_slots)
    n_up = _vec((0.0, 1.0, 0.0), push).expand(push.shape + (3,))
    if iiw is None:
        iiw = _inv_inertia_world(ps, quat)
    pos, quat = _apply_ground_correction(ps, pos, quat, n_up, -push, r_g,
                                         g_slots, dt, iiw)
    # ground friction at the same anchors: tangential drift cancelled,
    # Coulomb-capped at mu * (normal correction at each point)
    mu_g = fric * cfg.floor_friction
    slide = (pos - pos_prev) * _vec((1.0, 0.0, 1.0), pos)
    s_len = torch.linalg.vector_norm(slide, dim=-1)
    s_dir = slide / torch.clamp(s_len, min=_EPS)[..., None]
    g_corr = torch.minimum(torch.repeat_interleave(s_len * inv_act_g, g_slots),
                           torch.repeat_interleave(mu_g, g_slots) * push)
    g_corr = torch.where((push > 0) & torch.repeat_interleave(dyn, g_slots),
                         g_corr, torch.zeros_like(g_corr))
    pos, quat = _apply_ground_correction(
        ps, pos, quat, torch.repeat_interleave(s_dir, g_slots, dim=0),
        g_corr, r_g, g_slots, dt, iiw)
    return pos, quat


def gravity(cfg, like):
    """The world gravity vector [3] of a PhysicsConfig on `like`'s device,
    made there (no host copy, so a CUDA graph can hold it)."""
    return _vec(cfg.gravity_direction, like) * cfg.gravity_strength \
        * cfg.world_scale


def physics_substep(ps: PhysicsTables, state: PhysicsState, target_pos,
                    target_quat, cfg, dt, g):
    """One substep of `dt` seconds under gravity `g` [3] (`gravity`)."""
    inv_m = ps.inv_mass
    dyn = (inv_m > 0)[:, None]

    vel = state.vel + g[None, :] * dt
    vel = vel * torch.pow(1.0 - ps.lin_damp, dt)[:, None]
    omega = state.omega * torch.pow(1.0 - ps.ang_damp, dt)[:, None]

    pos0 = torch.where(dyn, state.pos, target_pos)
    quat0 = torch.where(dyn, state.quat, target_quat)

    pos = pos0 + torch.where(dyn, vel * dt, torch.zeros_like(vel))
    quat = torch.where(dyn, _apply_small_rotation(quat0, omega * dt), quat0)

    # narrowphase once per substep; rotation-aware anchors only for rigs
    # with boxes (spheres/capsules keep the cheap centre-translation update)
    rot_aware = ps.has_box
    if ps.n_pairs:
        c_point, c_n, c_depth0 = pair_contacts(ps, pos, quat)
        if c_depth0.shape[1] == 1:
            c_point, c_n, c_depth0 = c_point[:, 0], c_n[:, 0], c_depth0[:, 0]
        if rot_aware:
            def _loc(q_b, p_b):
                if c_point.dim() == 3:
                    q_b, p_b = q_b[:, None, :], p_b[:, None, :]
                return m3.quat_rotate(m3.quat_conj(q_b), c_point - p_b)
            c_la = _loc(quat[ps.pair_i], pos[ps.pair_i])
            c_lb = _loc(quat[ps.pair_j], pos[ps.pair_j])
        else:
            c_la = c_lb = None
    else:
        z3 = torch.zeros((0, 3), dtype=torch.float32, device=pos.device)
        c_point, c_n = z3, z3
        c_depth0 = torch.zeros((0,), dtype=torch.float32, device=pos.device)
        c_la = c_lb = z3 if rot_aware else None
    g_depth0, g_point = ground_contacts(ps, pos, quat)
    if rot_aware:
        g_l = m3.quat_rotate(m3.quat_conj(quat)[:, None, :],
                             g_point - pos[:, None, :])
        g_reff = g_depth0 + g_point[..., 1]
    else:
        g_l = g_reff = None
    cache = (c_point, c_n, c_depth0, c_la, c_lb, g_depth0, g_point, g_l,
             g_reff)
    pos_detect = pos

    # world inverse inertia once per substep
    iiw = _inv_inertia_world(ps, quat)
    for _ in range(cfg.solver_iterations):
        pos, quat = _joint_pass(ps, pos, quat, dt, iiw=iiw)
        pos, quat = _contact_pass(ps, pos, quat, cfg, dt, cache,
                                  pos_detect, pos0, iiw=iiw)
        pos = torch.where(dyn, pos, target_pos)
        quat = torch.where(dyn, quat, target_quat)

    vel_new = (pos - pos0) / dt
    dq = m3.quat_mul(quat, m3.quat_conj(quat0))
    sign = torch.sign(dq[..., 3:4])
    omega_new = 2.0 * dq[..., :3] * sign / dt

    # contact velocity pass: at every active contact the normal velocity at
    # the contact point is reset to the restitution target
    e_body = ps.restitution
    g_mag = torch.linalg.vector_norm(g) + _EPS
    thresh = 2.0 * g_mag * dt
    iiw_post = _inv_inertia_world(ps, quat)

    g_slots = g_depth0.shape[1]
    e_gnd = e_body * getattr(cfg, "floor_restitution", 0.0)
    r_g = g_point.reshape(-1, 3) - torch.repeat_interleave(pos_detect,
                                                           g_slots, dim=0)
    omega_r = torch.repeat_interleave(omega, g_slots, dim=0)
    v_pre_g = torch.repeat_interleave(vel[:, 1], g_slots) \
        + m3.cross(omega_r, r_g)[..., 1]
    e_gnd_r = torch.repeat_interleave(e_gnd, g_slots)
    target_g = torch.where((v_pre_g < -thresh) & (e_gnd_r > 0),
                           -e_gnd_r * v_pre_g, torch.zeros_like(v_pre_g))
    act_g = (g_depth0.reshape(-1) > 0) \
        & torch.repeat_interleave(dyn[:, 0], g_slots)
    if not cfg.has_floor:
        act_g = torch.zeros_like(act_g)
    inv_act_g = torch.repeat_interleave(1.0 / torch.clamp(
        act_g.reshape(-1, g_slots).to(torch.float32).sum(1), min=1.0),
        g_slots)
    rxn_g = m3.cross(r_g, _vec((0.0, 1.0, 0.0), r_g).expand(r_g.shape))
    iiw_r = torch.repeat_interleave(iiw_post, g_slots, dim=0)
    im_r = torch.repeat_interleave(inv_m, g_slots)
    w_g = im_r + _quad(rxn_g, iiw_r)

    v, w = vel_new, omega_new
    for _ in range(VELOCITY_PASS_ITERS):
        v_n = torch.repeat_interleave(v[:, 1], g_slots) \
            + m3.cross(torch.repeat_interleave(w, g_slots, dim=0), r_g)[..., 1]
        dvn = torch.where(act_g, (target_g - v_n) * inv_act_g,
                          torch.zeros_like(v_n))
        lam = dvn / torch.clamp(w_g, min=_EPS)
        v = v.clone()
        v[:, 1] = v[:, 1] + lam.reshape(-1, g_slots).sum(1) * inv_m
        w = w + _mv(iiw_post, (rxn_g * lam[..., None]).reshape(
            -1, g_slots, 3).sum(1))

    if ps.n_pairs:
        i, j, n_f, p_f, d0_f, scat, m_slots = _slot_rows(
            ps, c_point, c_n, c_depth0)
        if m_slots:
            inv_act = (1.0 / torch.clamp(
                (c_depth0 > 0).to(torch.float32).sum(1), min=1.0)
            ).repeat(m_slots)
        else:
            inv_act = 1.0
        r_a = p_f - pos_detect[i]
        r_b = p_f - pos_detect[j]
        e_pair = e_body[i] * e_body[j]
        v_pre = torch.sum(n_f * ((vel[i] + m3.cross(omega[i], r_a))
                                 - (vel[j] + m3.cross(omega[j], r_b))), -1)
        target = torch.where((v_pre < -thresh) & (e_pair > 0),
                             -e_pair * v_pre, torch.zeros_like(v_pre))
        act = d0_f > 0
        for _ in range(VELOCITY_PASS_ITERS):
            v_n = torch.sum(n_f * ((v[i] + m3.cross(w[i], r_a))
                                   - (v[j] + m3.cross(w[j], r_b))), -1)
            dvn = torch.where(act, (target - v_n) * inv_act,
                              torch.zeros_like(v_n))
            v, w = _apply_velocity_corrections(ps, v, w, i, j, n_f, dvn,
                                               r_a, r_b, scat, iiw_post)

    vel = torch.where(dyn, v, torch.zeros_like(v))
    omega = torch.where(dyn, w, torch.zeros_like(w))
    return PhysicsState(pos=pos, quat=quat, vel=vel, omega=omega)


def physics_react(static: ModelTables, ps: PhysicsTables,
                  state: PhysicsState, pose: PoseArrays, cfg
                  ) -> tuple[PhysicsState, PoseArrays]:
    """Full React(step): substeps at substep_hz, then Synchronize + Fix
    write-back into the pose."""
    if ps.n_bodies == 0:
        return state, pose
    target_pos, target_quat = body_targets(ps, pose)
    sub_dt = 1.0 / cfg.substep_hz
    n_sub = min(max(1, round(cfg.dt * cfg.substep_hz)), cfg.max_substeps)
    g = gravity(cfg, target_pos)
    for _ in range(n_sub):
        state = physics_substep(ps, state, target_pos, target_quat, cfg,
                                sub_dt, g)

    # Synchronize: skin[bone] = W_body @ rest_frame^-1 for the write-back
    # bodies (at most one per bone by construction)
    wb = ps.wb_idx
    if wb.shape[0]:
        rot = m3.quat_to_mat3(m3.quat_mul(
            state.quat[wb], m3.quat_conj(ps.rest_quat[wb])))
        trans = state.pos[wb] - torch.einsum("rij,rj->ri", rot,
                                             ps.rest_pos[wb])
        skin_new = m3.affine(rot, trans)
        skin = pose.skin.clone()
        skin[ps.wb_bone] = skin_new
        pose = pose.replace(skin=skin)

    # Fix: strict bodies re-pin the bone translation (one step per strict
    # body of the rig, over that bone's row in every instance)
    for i in ps.strict_ids:
        bone = int(ps.host.bone[i])
        parent = int(static.host.bone_parent[bone])
        rows = static.instance_rows(bone)
        rest = static.bone_rest[rows]
        skin_b = pose.skin[rows]
        local = skin_b.clone()
        local[:, :3, 3] = local[:, :3, 3] + _mv(skin_b[:, :3, :3], rest)
        if parent >= 0:
            parent_world = pose.world[static.instance_rows(parent)]
            # inv_ex: inv's values without its host check of `info`
            local = torch.linalg.inv_ex(parent_world,
                                        check_errors=False)[0] @ local
        local = local.clone()
        local[:, :3, 3] = pose.total_trans[rows] + static.local_offset[rows]
        world_b = (parent_world @ local) if parent >= 0 else local
        skin_fixed = world_b.clone()
        skin_fixed[:, :3, 3] = skin_fixed[:, :3, 3] \
            - _mv(world_b[:, :3, :3], rest)
        pose = pose.replace(world=_set(pose.world, rows, world_b),
                            skin=_set(pose.skin, rows, skin_fixed))
    return state, pose
