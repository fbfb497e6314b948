"""3D math core: Hamilton quaternions (x, y, z, w), column-vector 4x4 affines.

Port of `simple_mmd_renderer_tpu/utils/math3d.py`: the same formulas in the
same order, on torch tensors, batched over leading axes. Every function
works on the device of its inputs.
"""

from __future__ import annotations

import torch

EPS = 1e-8  # mmd_math_const_eps in the reference (mmd.hxx)


# ---------------------------------------------------------------------------
# Quaternions — (..., 4) tensors, (x, y, z, w)
# ---------------------------------------------------------------------------

def quat_identity(shape=(), device=None):
    q = torch.zeros(tuple(shape) + (4,), dtype=torch.float32, device=device)
    q[..., 3].fill_(1.0)    # a fill on the device: no host scalar copied in
    return q


def quat_mul(a, b):
    """Hamilton product a ⊗ b; R(a⊗b) = R(a) @ R(b)."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by + ay * bw + az * bx - ax * bz,
            aw * bz + az * bw + ax * by - ay * bx,
            aw * bw - (ax * bx + ay * by + az * bz),
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], -1)


def quat_normalize(q):
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(n > EPS, q / torch.clamp(n, min=EPS), q)


def quat_to_mat3(q):
    """Column-convention rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, zx = x * y, y * z, z * x
    wx, wy, wz = w * x, w * y, w * z
    one = torch.ones_like(x)
    m = torch.stack(
        [
            one - 2 * (yy + zz), 2 * (xy - wz), 2 * (zx + wy),
            2 * (xy + wz), one - 2 * (zz + xx), 2 * (yz - wx),
            2 * (zx - wy), 2 * (yz + wx), one - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def axis_angle_to_quat(axis, angle):
    """Quaternion from (possibly unnormalized) axis + angle; identity when
    the axis norm is ~0."""
    norm = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = angle[..., None] * 0.5
    xyz = (torch.sin(half) / torch.clamp(norm, min=EPS)) * axis
    w = torch.cos(half) * torch.ones_like(norm)
    q = torch.cat([xyz, w], dim=-1)
    return torch.where(norm > EPS, q,
                       quat_identity(q.shape[:-1], device=q.device))


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion q."""
    qv = q[..., :3]
    t = 2.0 * cross(qv, v)
    return v + q[..., 3:4] * t + cross(qv, t)


# --- Euler conversions (six orders) ----------------------------------------

def _q_terms(q):
    x, y, z, w = q.unbind(-1)
    return dict(
        xx=x * x, yy=y * y, zz=z * z,
        wx=w * x, wy=w * y, wz=w * z,
        xy=x * y, zx=z * x, yz=y * z,
    )


def _asin_safe(v):
    return torch.asin(torch.clamp(v, -1.0, 1.0))


def quat_to_euler(q, order):
    t = _q_terms(q)
    at2, asn = torch.atan2, _asin_safe
    if order == "xyz":
        e = (at2(2 * (t["wx"] - t["yz"]), 1 - 2 * (t["xx"] + t["yy"])),
             asn(2 * (t["wy"] + t["zx"])),
             at2(2 * (t["wz"] - t["xy"]), 1 - 2 * (t["yy"] + t["zz"])))
    elif order == "xzy":
        e = (at2(2 * (t["wx"] + t["yz"]), 1 - 2 * (t["xx"] + t["zz"])),
             at2(2 * (t["wy"] + t["zx"]), 1 - 2 * (t["yy"] + t["zz"])),
             asn(2 * (t["wz"] - t["xy"])))
    elif order == "yxz":
        e = (asn(2 * (t["wx"] - t["yz"])),
             at2(2 * (t["wy"] + t["zx"]), 1 - 2 * (t["xx"] + t["yy"])),
             at2(2 * (t["wz"] + t["xy"]), 1 - 2 * (t["xx"] + t["zz"])))
    elif order == "yzx":
        e = (at2(2 * (t["wx"] - t["yz"]), 1 - 2 * (t["xx"] + t["zz"])),
             at2(2 * (t["wy"] - t["zx"]), 1 - 2 * (t["yy"] + t["zz"])),
             asn(2 * (t["wz"] + t["xy"])))
    elif order == "zxy":
        e = (asn(2 * (t["wx"] + t["yz"])),
             at2(2 * (t["wy"] - t["zx"]), 1 - 2 * (t["xx"] + t["yy"])),
             at2(2 * (t["wz"] - t["xy"]), 1 - 2 * (t["xx"] + t["zz"])))
    elif order == "zyx":
        e = (at2(2 * (t["wx"] + t["yz"]), 1 - 2 * (t["xx"] + t["yy"])),
             asn(2 * (t["wy"] - t["zx"])),
             at2(2 * (t["wz"] + t["xy"]), 1 - 2 * (t["yy"] + t["zz"])))
    else:
        raise ValueError(f"unknown euler order {order!r}")
    return torch.stack(e, dim=-1)


def euler_to_quat(euler, order):
    cx = torch.cos(euler[..., 0] * 0.5)
    sx = torch.sin(euler[..., 0] * 0.5)
    cy = torch.cos(euler[..., 1] * 0.5)
    sy = torch.sin(euler[..., 1] * 0.5)
    cz = torch.cos(euler[..., 2] * 0.5)
    sz = torch.sin(euler[..., 2] * 0.5)
    if order == "xyz":
        q = (sx * cy * cz + cx * sy * sz, cx * sy * cz - sx * cy * sz,
             sx * sy * cz + cx * cy * sz, cx * cy * cz - sx * sy * sz)
    elif order == "xzy":
        q = (sx * cy * cz - cx * sy * sz, cx * sy * cz - sx * cy * sz,
             cx * cy * sz + sx * sy * cz, cx * cy * cz + sx * sy * sz)
    elif order == "yxz":
        q = (sx * cy * cz + cx * sy * sz, cx * sy * cz - sx * cy * sz,
             cx * cy * sz - sx * sy * cz, cx * cy * cz + sx * sy * sz)
    elif order == "yzx":
        q = (sx * cy * cz + cx * sy * sz, cx * sy * cz + sx * cy * sz,
             cx * cy * sz - sx * sy * cz, cx * cy * cz - sx * sy * sz)
    elif order == "zxy":
        q = (sx * cy * cz - cx * sy * sz, cx * sy * cz + sx * cy * sz,
             cx * cy * sz + sx * sy * cz, cx * cy * cz - sx * sy * sz)
    elif order == "zyx":
        q = (sx * cy * cz - cx * sy * sz, cx * sy * cz + sx * cy * sz,
             cx * cy * sz - sx * sy * cz, cx * cy * cz + sx * sy * sz)
    else:
        raise ValueError(f"unknown euler order {order!r}")
    return torch.stack(q, dim=-1)


# --- Interpolation (the reference's Lerp/NLerp/SLerp proxies) ---------------

def lerp(a, b, t):
    """Linear interpolation with the reference's eps endpoint shortcuts."""
    t = torch.as_tensor(t, dtype=a.dtype, device=a.device)
    tt = t[..., None] if t.dim() < a.dim() else t
    out = (1.0 - tt) * a + tt * b
    out = torch.where(tt < EPS, a, out)
    return torch.where(tt > 1.0 - EPS, b, out)


def quat_nlerp(a, b, t):
    """Normalized lerp with shortest-path sign flip (NLerpProxy)."""
    t = t[..., None]
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    bb = torch.where(dot < 0, -b, b)
    raw = (1.0 - t) * a + t * bb
    out = quat_normalize(raw)
    out = torch.where(t < EPS, a, out)
    return torch.where(t > 1.0 - EPS, b, out)


def quat_slerp(a, b, t):
    """Spherical lerp (SLerpProxy<Quaternion> specialization)."""
    t = t[..., None]
    comega = torch.sum(a * b, dim=-1, keepdim=True)
    flip = comega < 0
    comega = torch.abs(comega)
    omega = torch.acos(torch.clamp(comega, -1.0, 1.0))
    small = omega <= EPS
    somega = torch.sin(torch.where(small, torch.ones_like(omega), omega))
    p = torch.sin((1.0 - t) * omega) / somega
    l = torch.sin(t * omega) / somega
    l = torch.where(flip, -l, l)
    return torch.where(small, a, a * p + b * l)


# ---------------------------------------------------------------------------
# 4x4 affines — column convention, p' = M @ p
# ---------------------------------------------------------------------------

def affine(rot3=None, trans=None, dtype=torch.float32):
    """Build 4x4 from 3x3 rotation block and/or translation (batched).
    The dtype and device come from `rot3`, else from `trans`; `affine()`
    is eye(4) of `dtype` (on the default device)."""
    device = None
    if rot3 is not None:
        batch, dtype, device = rot3.shape[:-2], rot3.dtype, rot3.device
    elif trans is not None:
        batch, dtype, device = trans.shape[:-1], trans.dtype, trans.device
    else:
        batch = ()
    m = torch.eye(4, dtype=dtype, device=device).expand(
        tuple(batch) + (4, 4)).clone()
    if rot3 is not None:
        m[..., :3, :3] = rot3
    if trans is not None:
        m[..., :3, 3] = trans
    return m


def transform_point(m, p):
    """Apply 4x4 affine(s) to 3-point(s)."""
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], p) + m[..., :3, 3]


def rotate_vec(m, v):
    """Apply the rotation block of 4x4 affine(s) to vector(s)."""
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], v)


def affine_inverse(m):
    """Inverse of a rigid/affine transform via the full inverse of its 3x3
    block."""
    r_inv = torch.linalg.inv_ex(m[..., :3, :3]).inverse   # no host sync
    t_inv = -torch.einsum("...ij,...j->...i", r_inv, m[..., :3, 3])
    return affine(r_inv, t_inv)


def mat_from_quat_trans(q, t):
    return affine(quat_to_mat3(q), t)


def mat3_to_quat(m):
    """Rotation matrix [..., 3, 3] -> quaternion (x, y, z, w).

    The branchless 4-branch conversion (largest of trace / diagonal): all
    four candidate quaternions are computed and the one with the largest
    pivot is selected with `torch.where`, so rotations near 180 deg stay
    stable and no branch reads a value on the host (SDEF runs inside the
    captured step)."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    # pivot magnitudes: 4w^2, 4x^2, 4y^2, 4z^2
    pw = 1.0 + m00 + m11 + m22
    px = 1.0 + m00 - m11 - m22
    py = 1.0 - m00 + m11 - m22
    pz = 1.0 - m00 - m11 + m22
    sw = torch.sqrt(torch.clamp(pw, min=1e-12))
    sx = torch.sqrt(torch.clamp(px, min=1e-12))
    sy = torch.sqrt(torch.clamp(py, min=1e-12))
    sz = torch.sqrt(torch.clamp(pz, min=1e-12))
    a21 = m[..., 2, 1] - m[..., 1, 2]
    a02 = m[..., 0, 2] - m[..., 2, 0]
    a10 = m[..., 1, 0] - m[..., 0, 1]
    s01 = m[..., 0, 1] + m[..., 1, 0]
    s02 = m[..., 0, 2] + m[..., 2, 0]
    s12 = m[..., 1, 2] + m[..., 2, 1]
    qw = torch.stack([a21, a02, a10, sw * sw], -1) / (2.0 * sw[..., None])
    qx = torch.stack([sx * sx, s01, s02, a21], -1) / (2.0 * sx[..., None])
    qy = torch.stack([s01, sy * sy, s12, a02], -1) / (2.0 * sy[..., None])
    qz = torch.stack([s02, s12, sz * sz, a10], -1) / (2.0 * sz[..., None])
    best = torch.argmax(torch.stack([pw, px, py, pz], -1), -1)[..., None]
    q = torch.where(best == 0, qw,
                    torch.where(best == 1, qx, torch.where(best == 2, qy, qz)))
    # canonical sign (w >= 0) keeps blends of nearby rotations consistent
    q = torch.where(q[..., 3:4] < 0.0, -q, q)
    return quat_normalize(q)
