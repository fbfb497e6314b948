"""Procedural sample character, dance, textures and sky: the benchmark's
inputs.

The repository ships no PMX/VMD/HDR asset, so every cell renders this
Miku-scale synthetic character, built from the PMX data model: a ~40-bone
humanoid skeleton with MMD-standard bone names, leg IK chains with knee
limits, append twist bones, a tube/sphere mesh (~10-40k vertices by
density), vertex/bone/group morphs, kinematic body colliders and dynamic
hair and skirt rigid-body chains with 6DOF spring joints.

A copy of the port's `app/sample.py`, kept with the benchmark so that no
change to the program changes the inputs; the dance's curves are drawn from
a seed here (`sample_motion(rng=...)`) and it comes out as VMD bytes.
"""

from __future__ import annotations

import numpy as np

from ..reference.formats import pmx as P
from ..reference.formats.writers import write_vmd

F = np.float32
ROT_VIS = P.BONE_ROTATABLE | P.BONE_VISIBLE
STD = ROT_VIS | P.BONE_MOVABLE


def _bone(name, pos, parent, flags=ROT_VIS, level=0):
    b = P.Bone(name, name, np.asarray(pos, F), parent, level, flags)
    b.child_offset = np.zeros(3, F)
    return b


def _aa_quat(axis, angle):
    axis = np.asarray(axis, F)
    axis = axis / max(np.linalg.norm(axis), 1e-9)
    return np.array([*(np.sin(angle / 2) * axis), np.cos(angle / 2)], F)


class _Mesh:
    def __init__(self):
        self.pos, self.nrm, self.uv = [], [], []
        self.sk_t, self.sk_b, self.sk_w = [], [], []
        self.tris = []

    def n(self):
        return len(self.pos)

    def add_vertex(self, p, n, uv, bones, weights, stype=P.BDEF2):
        self.pos.append(np.asarray(p, F))
        self.nrm.append(np.asarray(n, F))
        self.uv.append(np.asarray(uv, F))
        self.sk_t.append(stype)
        bb = list(bones) + [-1] * (4 - len(bones))
        ww = list(weights) + [0.0] * (4 - len(weights))
        self.sk_b.append(bb)
        self.sk_w.append(ww)

    def tube(self, p0, p1, r0, r1, bone0, bone1, rings=6, sides=12):
        """Tapered tube from p0 to p1, BDEF2-skinned bone0->bone1 by height."""
        p0, p1 = np.asarray(p0, F), np.asarray(p1, F)
        axis = p1 - p0
        length = np.linalg.norm(axis)
        if length < 1e-6:
            return
        az = axis / length
        ref = np.array([1, 0, 0], F) if abs(az[0]) < 0.9 else np.array([0, 0, 1], F)
        ax = np.cross(az, ref)
        ax /= np.linalg.norm(ax)
        ay = np.cross(az, ax)
        base = self.n()
        for i in range(rings):
            t = i / (rings - 1)
            c = p0 + axis * t
            r = r0 * (1 - t) + r1 * t
            w0 = 1.0 - t
            for j in range(sides):
                th = 2 * np.pi * j / sides
                nrm = np.cos(th) * ax + np.sin(th) * ay
                if bone1 < 0 or w0 >= 1.0:
                    self.add_vertex(c + r * nrm, nrm, (j / sides, t),
                                    [bone0], [1.0], P.BDEF1)
                else:
                    self.add_vertex(c + r * nrm, nrm, (j / sides, t),
                                    [bone0, bone1], [w0, 1.0 - w0], P.BDEF2)
        for i in range(rings - 1):
            for j in range(sides):
                a = base + i * sides + j
                b = base + i * sides + (j + 1) % sides
                c = a + sides
                d = b + sides
                self.tris += [[a, b, c], [b, d, c]]

    def sphere(self, center, radius, bone, lat=10, lon=16):
        center = np.asarray(center, F)
        base = self.n()
        for i in range(lat):
            phi = np.pi * (i + 0.5) / lat
            for j in range(lon):
                th = 2 * np.pi * j / lon
                n = np.array([np.sin(phi) * np.cos(th), np.cos(phi),
                              np.sin(phi) * np.sin(th)], F)
                self.add_vertex(center + radius * n, n, (j / lon, i / lat),
                                [bone], [1.0], P.BDEF1)
        for i in range(lat - 1):
            for j in range(lon):
                a = base + i * lon + j
                b = base + i * lon + (j + 1) % lon
                self.tris += [[a, b, a + lon], [b, b + lon, a + lon]]

    def finalize(self, pm: P.PmxModel):
        n = self.n()
        pm.positions = np.stack(self.pos) if n else np.zeros((0, 3), F)
        pm.normals = np.stack(self.nrm) if n else np.zeros((0, 3), F)
        pm.uvs = np.stack(self.uv) if n else np.zeros((0, 2), F)
        pm.extra_uvs = np.zeros((n, 0, 4), F)
        pm.skin_type = np.asarray(self.sk_t, np.uint8)
        pm.skin_bones = np.asarray(self.sk_b, np.int32)
        pm.skin_weights = np.asarray(self.sk_w, F)
        pm.sdef_c = np.zeros((n, 3), F)
        pm.sdef_r0 = np.zeros((n, 3), F)
        pm.sdef_r1 = np.zeros((n, 3), F)
        pm.edge_scale = np.ones(n, F)
        pm.triangles = np.asarray(self.tris, np.int32).reshape(-1, 3)


def sample_character(density: float = 1.0, n_parts: int = 2) -> P.PmxModel:
    """Build the flagship synthetic character (MMD units: ~20 tall).

    `n_parts` splits the triangle list into that many material parts
    (real PMX models ship 10-30 parts, each its own texture bind —
    main.cpp:2093-2146); the default 2 keeps the historical bench scene."""
    pm = P.PmxModel()
    pm.name = pm.name_en = "sample_character"
    pm.description = pm.description_en = "procedural benchmark character"
    pm.extra_uv_count = 0
    pm.textures = []

    bones: list[P.Bone] = []

    def add(name, pos, parent, flags=ROT_VIS, level=0):
        bones.append(_bone(name, pos, parent, flags, level))
        return len(bones) - 1

    # core (positions in MMD units, y up; hips ~10)
    root = add("全ての親", (0, 0, 0), P.NONE, STD)
    center = add("センター", (0, 8, 0), root, STD)
    lower = add("下半身", (0, 10, 0), center)
    upper = add("上半身", (0, 11, 0), center)
    upper2 = add("上半身2", (0, 12.5, 0), upper)
    neck = add("首", (0, 14.5, 0), upper2)
    head = add("頭", (0, 15.5, 0), neck)

    arms = {}
    for side, sx in (("左", 1.0), ("右", -1.0)):
        sh = add(f"{side}肩", (sx * 0.8, 14.0, 0), upper2)
        arm = add(f"{side}腕", (sx * 1.6, 13.8, 0), sh)
        twist = add(f"{side}腕捩", (sx * 2.4, 13.1, 0), arm,
                    ROT_VIS | P.BONE_APPEND_ROTATE)
        bones[twist].append_parent = arm
        bones[twist].append_ratio = 0.5
        elbow = add(f"{side}ひじ", (sx * 3.2, 12.4, 0), twist)
        wrist = add(f"{side}手首", (sx * 4.6, 11.2, 0), elbow)
        arms[side] = (sh, arm, elbow, wrist)

    legs = {}
    for side, sx in (("左", 1.0), ("右", -1.0)):
        hip = add(f"{side}足", (sx * 0.9, 10.0, 0), lower)
        knee = add(f"{side}ひざ", (sx * 0.9, 5.5, 0), hip)
        ankle = add(f"{side}足首", (sx * 0.9, 1.0, 0), knee)
        toe = add(f"{side}つま先", (sx * 0.9, 0.2, -1.3), ankle)
        ik = add(f"{side}足ＩＫ", (sx * 0.9, 1.0, 0), root, STD | P.BONE_HAS_IK,
                 level=1)
        bones[ik].ik_target = ankle
        bones[ik].ik_loop = 40
        bones[ik].ik_angle = 2.0
        bones[ik].ik_links = [
            P.IKLink(knee, True, np.array([-np.pi, 0, 0], F),
                     np.array([-0.008726646, 0, 0], F)),
            P.IKLink(hip, False, np.zeros(3, F), np.zeros(3, F)),
        ]
        toe_ik = add(f"{side}つま先ＩＫ", (sx * 0.9, 0.2, -1.3), ik,
                     STD | P.BONE_HAS_IK, level=1)
        bones[toe_ik].ik_target = toe
        bones[toe_ik].ik_loop = 8
        bones[toe_ik].ik_angle = 4.0
        bones[toe_ik].ik_links = [
            P.IKLink(ankle, False, np.zeros(3, F), np.zeros(3, F))]
        legs[side] = (hip, knee, ankle, toe, ik)

    # hair chains (behind the head) and skirt chains (around the hips) —
    # rest positions must clear the kinematic colliders below, or contacts
    # eject the chains at frame 0
    hair_chains = []
    for k, ang in enumerate(np.linspace(-0.9, 0.9, 5)):
        cx, cz = 1.2 * np.sin(ang), 1.2 * np.cos(ang) * 0.7 + 0.9
        chain = []
        parent = head
        for seg in range(4):
            idx = add(f"髪{k}_{seg}", (cx, 15.3 - 1.0 * (seg + 1), cz), parent)
            chain.append(idx)
            parent = idx
        hair_chains.append(chain)

    skirt_chains = []
    for k, ang in enumerate(np.linspace(0, 2 * np.pi, 8, endpoint=False)):
        cx, cz = 1.9 * np.cos(ang), 1.9 * np.sin(ang)
        chain = []
        parent = lower
        for seg in range(3):
            idx = add(f"スカート{k}_{seg}", (cx, 9.0 - 1.0 * (seg + 1), cz),
                      parent)
            chain.append(idx)
            parent = idx
        skirt_chains.append(chain)

    pm.bones = bones
    b_pos = {i: bones[i].position for i in range(len(bones))}

    # --- mesh
    mb = _Mesh()
    d = max(density, 0.2)
    rings = max(4, int(8 * d))
    sides = max(8, int(16 * d))

    def limb(b0, b1, r0, r1):
        mb.tube(b_pos[b0], b_pos[b1], r0, r1, b0, b1, rings, sides)

    limb(lower, upper, 1.3, 1.1)          # hips/waist
    limb(upper, upper2, 1.1, 1.0)
    limb(upper2, neck, 1.0, 0.5)
    mb.sphere(b_pos[head] + np.array([0, 1.0, 0], F), 1.4, head,
              lat=max(8, int(14 * d)), lon=max(12, int(22 * d)))
    for side in ("左", "右"):
        sh, arm, elbow, wrist = arms[side]
        limb(sh, arm, 0.45, 0.4)
        limb(arm, elbow, 0.4, 0.32)
        limb(elbow, wrist, 0.32, 0.25)
        hip, knee, ankle, toe, _ = legs[side]
        limb(hip, knee, 0.65, 0.45)
        limb(knee, ankle, 0.45, 0.3)
        mb.tube(b_pos[ankle], b_pos[toe], 0.35, 0.3, ankle, toe,
                max(3, rings // 2), sides)
    for chain in hair_chains:
        start = b_pos[chain[0]] + np.array([0, 1.1, 0], F)
        for i, bi in enumerate(chain):
            p0 = start if i == 0 else b_pos[chain[i - 1]]
            nxt = chain[i + 1] if i + 1 < len(chain) else -1
            mb.tube(p0, b_pos[bi], 0.22, 0.18, bi, -1,
                    max(3, rings // 2), max(6, sides // 2))
    for chain in skirt_chains:
        for i, bi in enumerate(chain):
            p0 = b_pos[chain[i - 1]] if i else (
                b_pos[bi] + np.array([0, 1.0, 0], F))
            mb.tube(p0, b_pos[bi], 0.5, 0.55, bi, -1,
                    max(3, rings // 2), max(6, sides // 2))
    mb.finalize(pm)

    n_tris = len(pm.triangles)
    half = n_tris // 2
    mat = lambda name, count, base: P.Material(
        name, name, np.array([1, 1, 1, 1], F), np.array([0.3, 0.3, 0.3], F),
        16.0, np.array([0.5, 0.5, 0.5], F),
        P.MAT_GROUND_SHADOW | P.MAT_DRAW_EDGE,
        np.array([0.1, 0.05, 0.1, 1], F), 1.0, -1, -1, 0, True, 0, "",
        count, base)
    if n_parts <= 2:
        pm.materials = [mat("body", half, 0),
                        mat("extras", n_tris - half, half)]
    else:
        bounds = np.linspace(0, n_tris, n_parts + 1).astype(int)
        pm.materials = [mat(f"part{p}", int(bounds[p + 1] - bounds[p]),
                            int(bounds[p]))
                        for p in range(n_parts)]

    # --- morphs
    head_sphere = [i for i in range(len(pm.positions))
                   if np.linalg.norm(pm.positions[i]
                                     - (b_pos[head] + [0, 1.0, 0])) < 1.45]
    blink_idx = np.asarray(head_sphere[: max(4, len(head_sphere) // 4)],
                           np.int32)
    pm.morphs = [
        P.Morph("まばたき", "blink", 2, P.MORPH_VERTEX,
                vertex_indices=blink_idx,
                vertex_offsets=np.tile(np.array([[0, -0.08, 0]], F),
                                       (len(blink_idx), 1))),
        P.Morph("うなずき", "nod", 4, P.MORPH_BONE,
                bone_indices=np.array([head], np.int32),
                bone_translations=np.zeros((1, 3), F),
                bone_rotations=_aa_quat([1, 0, 0], 0.35)[None, :]),
        P.Morph("笑い", "smile", 3, P.MORPH_GROUP,
                group_indices=np.array([0, 1], np.int32),
                group_rates=np.array([0.6, 0.4], F)),
    ]

    # --- rigid bodies + joints
    bodies: list[P.RigidBody] = []
    joints: list[P.Constraint] = []

    def body(name, bone_idx, shape, dims, pos, btype, group, mask, mass=1.0,
             damp=0.5):
        bodies.append(P.RigidBody(
            name, name, bone_idx, group, mask, shape, np.asarray(dims, F),
            np.asarray(pos, F), np.zeros(3, F), mass, damp, damp, 0.0, 0.5,
            btype))
        return len(bodies) - 1

    K = P.RIGID_KINEMATIC
    D = P.RIGID_PHYSICS
    ALL = 0xFFFF
    NO_HAIR = ALL & ~(1 << 1)
    NO_SKIRT = ALL & ~(1 << 2)

    body("体下", lower, P.SHAPE_CAPSULE, (1.0, 1.0, 0), (0, 10.5, 0), K, 0, ALL, 0)
    body("体上", upper2, P.SHAPE_CAPSULE, (0.85, 1.6, 0), (0, 13.2, 0), K, 0, ALL, 0)
    body("頭", head, P.SHAPE_SPHERE, (1.2, 0, 0), (0, 16.5, 0), K, 0, ALL, 0)
    for side in ("左", "右"):
        hip, knee, ankle, toe, _ = legs[side]
        mid_t = (b_pos[hip] + b_pos[knee]) / 2
        body(f"{side}腿", hip, P.SHAPE_CAPSULE, (0.55, 3.2, 0), mid_t, K, 0,
             ALL, 0)
        mid_s = (b_pos[knee] + b_pos[ankle]) / 2
        body(f"{side}脛", knee, P.SHAPE_CAPSULE, (0.4, 3.4, 0), mid_s, K, 0,
             ALL, 0)
        sh, arm, elbow, wrist = arms[side]
        mid_a = (b_pos[arm] + b_pos[elbow]) / 2
        body(f"{side}腕", arm, P.SHAPE_CAPSULE, (0.35, 1.2, 0), mid_a, K, 0,
             ALL, 0)

    def chain_bodies(chains, name, group, mask, radius, k_ang):
        for ci, chain in enumerate(chains):
            prev_body = 2 if name == "髪" else 0  # head or lower-body collider
            for si, bi in enumerate(chain):
                p = b_pos[bi]
                idx = body(f"{name}{ci}_{si}", bi, P.SHAPE_SPHERE,
                           (radius, 0, 0), p, D, group, mask,
                           mass=0.15, damp=0.75)
                anchor = b_pos[bi] + np.array([0, 0.5, 0], F)
                joints.append(P.Constraint(
                    f"{name}J{ci}_{si}", "", prev_body, idx, anchor,
                    np.zeros(3, F), np.zeros(3, F), np.zeros(3, F),
                    np.array([-0.8, -0.8, -0.8], F),
                    np.array([0.8, 0.8, 0.8], F),
                    np.zeros(3, F), np.asarray(k_ang, F)))
                prev_body = idx

    chain_bodies(hair_chains, "髪", 1, NO_HAIR, 0.25, (30.0, 30.0, 30.0))
    chain_bodies(skirt_chains, "スカート", 2, NO_SKIRT, 0.4, (60.0, 60.0, 60.0))

    pm.rigid_bodies = bodies
    pm.constraints = joints
    return pm


def sample_motion(length: int = 240, fps_keys: int = 5,
                  rng: np.random.Generator | None = None) -> bytes:
    """The sample dance as VMD bytes: center bob + sway, arm swings, head
    nod, IK foot steps, blink morph, a key every `fps_keys` frames up to
    `length`, linear interpolation curves. With `rng`, every curve takes a
    phase in [0, 2 pi) and an amplitude scale in [0.8, 1.2] drawn from it:
    the same bones, keys, curves and length, a different dance."""
    lin = np.array([[20, 20, 107, 107]] * 4, np.int8)
    n_curves = 14
    if rng is None:
        phase, amp = np.zeros(n_curves), np.ones(n_curves)
    else:
        phase = rng.uniform(0.0, 2 * np.pi, n_curves)
        amp = rng.uniform(0.8, 1.2, n_curves)

    def wave(k, w, t):
        return amp[k] * np.sin(w * t + phase[k])

    keys = []
    morphs = []
    for f in range(0, length + 1, fps_keys):
        t = f / 30.0
        keys.append(("センター", f,
                     np.array([0.4 * wave(0, 2.1, t), 0.35 * wave(1, 4.2, t),
                               0.0], F),
                     _aa_quat([0, 1, 0], 0.12 * wave(2, 1.3, t)), lin))
        keys.append(("上半身", f, np.zeros(3),
                     _aa_quat([0, 0, 1], 0.1 * wave(3, 2.1, t)), lin))
        keys.append(("頭", f, np.zeros(3),
                     _aa_quat([1, 0, 0], 0.15 * wave(4, 3.1, t + 1 / 3.1)),
                     lin))
        for i, (side, sx, ph) in enumerate((("左", 1.0, 0.0),
                                            ("右", -1.0, np.pi))):
            k = 5 + 4 * i
            keys.append((f"{side}腕", f, np.zeros(3),
                         _aa_quat([0, 0, sx],
                                  0.9 + 0.35 * wave(k, 2.1, t + ph / 2.1)),
                         lin))
            keys.append((f"{side}ひじ", f, np.zeros(3),
                         _aa_quat([0, sx, 0],
                                  0.3 + 0.2 * wave(k + 1, 2.1, t + ph / 2.1)),
                         lin))
            lift = max(0.0, wave(k + 2, 2.1, t + ph / 2.1)) * 1.2
            keys.append((f"{side}足ＩＫ", f,
                         np.array([0, lift,
                                   0.3 * wave(k + 3, 1.05, t + ph / 1.05)],
                                  F),
                         np.array([0, 0, 0, 1], F), lin))
        blink = max(0.0, np.sin(3.0 * t + phase[13])) ** 4
        morphs.append(("まばたき", f, float(blink)))
    return write_vmd("sample_dance", keys, morphs)


def sample_textures(sizes=(1024, 256)) -> list[np.ndarray]:
    """Procedural per-part diffuse textures for the sample character — one
    per material part, deliberately different sizes so the shelf-packed
    atlas path (render.pipeline._albedo_atlas) is exercised. The reference
    binds a real texture per part (main.cpp:2093-2146); this is the
    texture-benching stand-in for models whose textures ship as files."""
    out = []
    for p, size in enumerate(sizes):
        ys = (np.arange(size, dtype=F) + 0.5) / size
        xs = (np.arange(size, dtype=F) + 0.5) / size
        yy = ys[:, None]
        xx = xs[None, :]
        checker = ((np.floor(xx * 16) + np.floor(yy * 16)) % 2).astype(F)
        r = 0.92 - 0.28 * checker - 0.05 * p
        g = 0.72 + 0.20 * xx * (1.0 - checker) + 0.05 * p
        b = 0.82 - 0.30 * yy
        rgb = np.clip(np.stack(np.broadcast_arrays(r, g, b), -1), 0.0, 1.0)
        # quantize to the 8-bit grid: these stand in for PNG textures, and
        # 8-bit-exact sources take the u32-packed fast atlas path (floats
        # off the grid route through the exact f32x12 atlas instead)
        out.append((np.round(rgb * 255.0) / 255.0).astype(F))
    return out


def sample_equirect(height: int = 1024, width: int = 2048,
                    seed: int = 0) -> np.ndarray:
    """A procedural equirectangular HDR environment [H,W,3] float32 (linear
    radiance): a sky gradient over a darker ground, seeded soft clouds and
    a bright sun (radiance up to ~20, so the ACES tonemap sees HDR
    values)."""
    rng = np.random.default_rng(seed)
    v = (np.arange(height, dtype=F) + 0.5) / height      # 0 = up
    u = (np.arange(width, dtype=F) + 0.5) / width
    phi = (v * np.pi)[:, None]
    theta = ((u - 0.5) * 2 * np.pi)[None, :]
    d = np.stack(np.broadcast_arrays(np.sin(phi) * np.cos(theta),
                                     np.cos(phi) + 0 * theta,
                                     np.sin(phi) * np.sin(theta)), -1)
    up = np.clip(d[..., 1:2], -1.0, 1.0)
    sky = np.where(up > 0, np.array([0.35, 0.55, 1.0], F) * (0.6 + up),
                   np.array([0.25, 0.22, 0.2], F) * (1.0 + up))
    freq = rng.uniform(1.0, 4.0, (4, 2)).astype(F)
    phase = rng.uniform(0.0, 2 * np.pi, 4).astype(F)
    cloud = sum(np.sin(fx * theta + fy * phi * 2 + ph)
                for (fx, fy), ph in zip(freq, phase)) / 4.0
    sky = sky + 0.3 * np.clip(cloud, 0.0, None)[..., None] * (up > 0)
    az, el = rng.uniform(0, 2 * np.pi), rng.uniform(0.3, 1.0)
    sun = np.array([np.cos(el) * np.cos(az), np.sin(el),
                    np.cos(el) * np.sin(az)], F)
    glow = np.exp((np.sum(d * sun, -1) - 1.0) * 400.0)[..., None]
    return (sky + 20.0 * glow).astype(F)
