"""PMD 1.0 legacy model parser.

Rebuild of libmmd's PmdReader (`reader/pmd_reader_impl.inl:17-566`,
`reader/interprete/pmd_types.inl`), converting PMD conventions into the same
model representation the PMX parser produces (`formats.pmx.PmxModel`):

- all vertices are BDEF2 (two int16 bones + one byte weight / 100)
- PMD bone types map onto PMX flags (reader:210-267): type 1 -> movable,
  2/ik -> IK + movable (level 1), 5 -> append-rotate ratio 1 (level 2),
  9 -> append-rotate ratio ik_number/100, 8 -> twist (fixed axis toward the
  child), 6/7/9 invisible; transform levels then propagate down the tree
- multiple IK blocks on one bone spawn duplicate "[IK]" bones (reader:282-301)
- knee links (左ひざ/右ひざ) get the hard-coded x-rotation limit
  [-pi, -0.5deg] (reader:270-327); CCD angle limit is scaled x4 (reader:310)
- face morphs index into the "base" morph's vertex list (reader:380-399)
- rigid body positions are bone-relative in PMD -> converted to absolute
  (reader:506-510); bodies with no bone attach to センター and become ghosts

The port's own copy of `simple_mmd_renderer_tpu/formats/pmd.py` (host only,
on the port's `utils/io` and `formats/pmx`): the same rules and the same
`PmxModel` field by field.
"""

from __future__ import annotations

import math

import numpy as np

from ..utils.io import BinReader, ParseError, decode_shift_jis
from . import pmx as P

F = np.float32
_KNEE_NAMES = ("左ひざ", "右ひざ")

# PMD bone types
_ROTATE = 0
_ROTATE_TRANSLATE = 1
_IK = 2
_UNKNOWN = 3
_IK_LINK = 4
_ROTATE_EFFECT = 5
_IK_TO = 6
_INVISIBLE = 7
_TWIST = 8
_ROTATE_RATIO = 9


def _sjis(r: BinReader, n: int) -> str:
    return decode_shift_jis(r.read_bytes(n))


def parse_pmd(data: bytes) -> P.PmxModel:
    """Parse PMD 1.0 bytes. Raises utils.io.ParseError on malformed or
    truncated input (same typed-error contract as `pmx.parse_pmx`)."""
    r = BinReader(data)
    magic = r.read_bytes(3, "magic")
    version = r.read("f", "version")
    if magic != b"Pmd" or abs(version - 1.0) > 1e-6:
        raise ParseError("not a PMD 1.0 file", 0, "header")

    m = P.PmxModel()
    m.extra_uv_count = 0
    m.name = _sjis(r, 20)
    m.description = _sjis(r, 256)

    # --- vertices (fixed 38-byte records: bulk numpy)
    n_vert = r.read("I", "vertex count")
    vdt = np.dtype([("pos", "<f4", 3), ("nrm", "<f4", 3), ("uv", "<f4", 2),
                    ("bones", "<i2", 2), ("weight", "u1"), ("non_edge", "u1")])
    recs = r.read_array(vdt, n_vert, "vertices")
    m.positions = recs["pos"].astype(F)
    m.normals = recs["nrm"].astype(F)
    m.uvs = recs["uv"].astype(F)
    m.extra_uvs = np.zeros((n_vert, 0, 4), F)
    m.skin_type = np.full(n_vert, P.BDEF2, np.uint8)
    w = recs["weight"].astype(F) * F(0.01)
    m.skin_bones = np.full((n_vert, 4), -1, np.int32)
    m.skin_bones[:, 0] = recs["bones"][:, 0]
    m.skin_bones[:, 1] = recs["bones"][:, 1]
    m.skin_weights = np.zeros((n_vert, 4), F)
    m.skin_weights[:, 0] = w
    m.skin_weights[:, 1] = 1.0 - w
    m.sdef_c = np.zeros((n_vert, 3), F)
    m.sdef_r0 = np.zeros((n_vert, 3), F)
    m.sdef_r1 = np.zeros((n_vert, 3), F)
    m.edge_scale = np.where(recs["non_edge"] > 0, 0.0, 1.0).astype(F)

    # --- triangles
    n_index = r.read("I", "index count")
    if n_index % 3 != 0:
        raise ParseError(f"index count {n_index} not a multiple of 3",
                         r.pos - 4, "index count")
    tri_flat = r.read_array(np.uint16, n_index, "triangles").astype(np.int32)
    if n_index and (n_vert == 0 or int(tri_flat.max()) >= n_vert):
        raise ParseError(f"triangle index out of range [0, {n_vert})",
                         r.pos, "triangles")
    m.triangles = tri_flat.reshape(-1, 3)

    # --- materials
    n_mat = r.read("I")
    toon_ids = []
    texture_names: list[str] = []
    base_shift = 0
    for i in range(n_mat):
        vals = r.read("4ff3f3f")
        toon_id = r.read("b")
        edge_flag = r.read("B")
        vnum = r.read("I")
        tex_raw = _sjis(r, 20)
        diffuse = np.array(vals[0:4], F)
        alpha = float(diffuse[3])

        tex, sub, sub_type = -1, -1, 0
        if tex_raw:
            if "*" in tex_raw:
                t, s = tex_raw.split("*", 1)
            else:
                ext = tex_raw.rsplit(".", 1)[-1].lower() if "." in tex_raw else ""
                if ext in ("sph", "spa"):
                    t, s = "", tex_raw
                else:
                    t, s = tex_raw, ""
            if t:
                tex = _intern(texture_names, t)
            if s:
                sub = _intern(texture_names, s)
                sub_type = 2 if s.lower().endswith("a") else 1  # SPA : SPH

        flags = 0
        if alpha < 1.0:
            flags |= P.MAT_DOUBLE_FACE
        if edge_flag:
            flags |= P.MAT_GROUND_SHADOW | P.MAT_DRAW_EDGE
        if alpha > 0.98:
            flags |= P.MAT_CAST_SELF_SHADOW | P.MAT_DRAW_SELF_SHADOW

        m.materials.append(P.Material(
            name=f"material{i}", name_en="", diffuse=diffuse,
            specular=np.array(vals[5:8], F), shininess=vals[4],
            ambient=np.array(vals[8:11], F), draw_flags=flags,
            edge_color=np.array([0, 0, 0, 1], F), edge_size=1.0,
            texture=tex, sub_texture=sub, sub_texture_type=sub_type,
            toon_is_global=True, toon=max(int(toon_id), 0), meta="",
            n_triangles=vnum // 3, base_shift=base_shift))
        toon_ids.append(int(toon_id))
        base_shift += vnum // 3
    m.textures = texture_names

    # --- bones
    n_bone = r.read("H")
    raw = []
    for _ in range(n_bone):
        name = _sjis(r, 20)
        parent, child = r.read("hh")
        btype = r.read("B")
        ik_number = r.read("h")
        pos = np.array(r.read("3f"), F)
        raw.append((name, parent, child, btype, ik_number, pos))

    # --- IK blocks (read before bone construction: IK membership sets flags)
    n_ik = r.read("H")
    raw_iks = []
    ik_bone_ids = set()
    for _ in range(n_ik):
        ik_bone, target = r.read("hh")
        chain_len = r.read("B")
        iterate = r.read("H")
        angle = r.read("f")
        chain = [r.read("H") for _ in range(chain_len)]
        ik_bone_ids.add(ik_bone)
        raw_iks.append((ik_bone, target, iterate, angle, chain))
    raw_iks.sort(key=lambda ik: ik[4][0] if ik[4] else 0)

    center_index = -1
    for i, (name, parent, child, btype, ik_number, pos) in enumerate(raw):
        if name == "センター":
            center_index = i
        flags = P.BONE_ROTATABLE | P.BONE_CONTROLLABLE | P.BONE_CHILD_USE_ID
        has_ik = btype == _IK or i in ik_bone_ids
        if btype == _ROTATE_TRANSLATE or has_ik:
            flags |= P.BONE_MOVABLE
        if btype not in (_IK_TO, _INVISIBLE, _ROTATE_RATIO):
            flags |= P.BONE_VISIBLE
        if btype in (_ROTATE_EFFECT, _ROTATE_RATIO):
            flags |= P.BONE_APPEND_ROTATE
        if btype == _TWIST:
            flags |= P.BONE_ROT_AXIS_FIXED

        b = P.Bone(name, "", pos, parent if (0 <= parent < n_bone
                                             and parent != i) else P.NONE,
                   0, flags)
        b.child_index = child
        level = 0
        if btype == _ROTATE_EFFECT:
            b.append_parent = ik_number if 0 <= ik_number < n_bone else P.NONE
            b.append_ratio = 1.0
            level = 2
        elif btype == _ROTATE_RATIO:
            b.flags &= ~P.BONE_CHILD_USE_ID
            b.child_index = P.NONE
            b.child_offset = np.zeros(3, F)
            b.append_parent = child if 0 <= child < n_bone else P.NONE
            b.append_ratio = ik_number * 0.01
        if has_ik:
            b.flags |= P.BONE_HAS_IK
            level = 1
        if btype == _TWIST:
            cid = child if 0 <= child < n_bone else 0
            axis = raw[cid][5] - pos
            n = np.linalg.norm(axis)
            b.fixed_axis = (axis / n if n > 0 else axis).astype(F)
            b.flags &= ~P.BONE_CHILD_USE_ID
            b.child_index = P.NONE
            b.child_offset = np.zeros(3, F)
        b.transform_level = level
        m.bones.append(b)

    # attach IK blocks; extra blocks on one bone spawn "[IK]" duplicates
    knee_lo = np.array([-math.pi, 0, 0], F)
    knee_hi = np.array([-0.5 / 180.0 * math.pi, 0, 0], F)
    ik_count: dict[int, int] = {}
    for ik_bone, target, iterate, angle, chain in raw_iks:
        if not (0 <= ik_bone < n_bone):
            continue
        k = ik_count.get(ik_bone, 0)
        ik_count[ik_bone] = k + 1
        if k == 0:
            bone = m.bones[ik_bone]
        else:
            src = m.bones[ik_bone]
            bone = P.Bone("[IK]" + src.name, "[IK]" + src.name_en,
                          src.position.copy(), ik_bone, src.transform_level,
                          (src.flags | P.BONE_HAS_IK)
                          & ~(P.BONE_CHILD_USE_ID | P.BONE_VISIBLE))
            bone.child_offset = np.zeros(3, F)
            m.bones.append(bone)
        bone.ik_target = target
        bone.ik_loop = iterate
        bone.ik_angle = angle * 4.0
        bone.ik_links = []
        for link in chain:
            limited = 0 <= link < n_bone and m.bones[link].name in _KNEE_NAMES
            bone.ik_links.append(P.IKLink(
                link, limited,
                knee_lo.copy() if limited else np.zeros(3, F),
                knee_hi.copy() if limited else np.zeros(3, F)))

    # transform-level stabilization (reader:338-358): a bone's level is at
    # least the max level among its ancestors
    levels = np.array([b.transform_level for b in m.bones], np.int64)
    parents = np.array([b.parent for b in m.bones], np.int64)
    for _ in range(len(m.bones)):
        stable = True
        for j in range(len(m.bones)):
            p = parents[j]
            lv = levels[j]
            while 0 <= p < len(m.bones):
                if lv < levels[p]:
                    lv = levels[p]
                    stable = False
                p = parents[p]
            levels[j] = lv
        if stable:
            break
    for b, lv in zip(m.bones, levels):
        b.transform_level = int(lv)

    # --- face morphs (all vertex morphs; non-base remap through the base)
    n_face = r.read("H", "face morph count")
    base_idx = -1
    faces = []
    for i in range(n_face):
        name = _sjis(r, 20)
        vnum = r.read("I", "face vertex count")
        if vnum * 16 > r.remaining():  # 16 B/record; forged counts must not
            raise ParseError(           # size a giant allocation below
                f"face vertex count {vnum} exceeds the {r.remaining()} "
                "bytes left", r.pos - 4, "face vertex count")
        ftype = r.read("B")
        idxs = np.empty(vnum, np.int32)
        offs = np.empty((vnum, 3), F)
        for j in range(vnum):
            idxs[j] = r.read("I")
            offs[j] = r.read("3f")
        if ftype == 0:
            base_idx = i
        faces.append((name, ftype, idxs, offs))
    for i, (name, ftype, idxs, offs) in enumerate(faces):
        if base_idx >= 0 and i != base_idx:
            base = faces[base_idx][2]
            if idxs.size and (int(idxs.min()) < 0
                              or int(idxs.max()) >= base.size):
                raise ParseError(
                    f"face morph '{name}' indexes outside the base morph "
                    f"[0, {base.size})", None, "face morph")
            idxs = base[idxs]
        elif idxs.size and (int(idxs.min()) < 0
                            or int(idxs.max()) >= n_vert):
            raise ParseError(
                f"face morph '{name}' vertex index out of range "
                f"[0, {n_vert})", None, "face morph")
        m.morphs.append(P.Morph(name, "", ftype, P.MORPH_VERTEX,
                                vertex_indices=idxs.astype(np.int32),
                                vertex_offsets=offs))

    # --- display lists: read and discard (reader:401-416)
    n_face_disp = r.read("B")
    for _ in range(n_face_disp):
        r.read("H")
    n_bone_names = r.read("B")
    for _ in range(n_bone_names):
        r.read_bytes(50)
    n_bone_disp = r.read("I")
    for _ in range(n_bone_disp):
        r.read("H")
        r.read("B")

    # --- optional english block
    if r.remaining() > 0:
        has_en = r.read("B") == 1
        if has_en:
            m.name_en = _sjis(r, 20)
            m.description_en = _sjis(r, 256)
            for b in m.bones[:n_bone]:
                b.name_en = _sjis(r, 20)
            for i, mo in enumerate(m.morphs):
                if i == base_idx:
                    mo.name_en = mo.name
                else:
                    mo.name_en = _sjis(r, 20)
            for _ in range(n_bone_names):
                r.read_bytes(50)

    # --- optional custom toon table
    if r.remaining() > 0:
        for _ in range(10):
            _sjis(r, 100)  # toon texture names (toon shading not rendered)

    # --- optional rigid bodies + constraints
    if r.remaining() > 0:
        n_rigid = r.read("I")
        for _ in range(n_rigid):
            name = _sjis(r, 20)
            bone_idx = r.read("H")
            group = r.read("B")
            mask = r.read("H")
            shape = r.read("B")
            vals = r.read("3f3f3f5f")
            btype = r.read("B")
            if bone_idx < n_bone:
                bone_ref = bone_idx
                rb_type = btype
            else:
                bone_ref = center_index if center_index >= 0 else 0
                rb_type = P.RIGID_PHYSICS_GHOST
            # PMD body positions are relative to the bone (reader:506-510)
            anchor = (m.bones[bone_ref].position if m.bones
                      else np.zeros(3, F))
            pos = anchor + np.array(vals[3:6], F)
            m.rigid_bodies.append(P.RigidBody(
                name, "", bone_ref, group, mask, shape,
                np.array(vals[0:3], F), pos, np.array(vals[6:9], F),
                vals[9], vals[10], vals[11], vals[12], vals[13], rb_type))

        n_cons = r.read("I")
        for _ in range(n_cons):
            name = _sjis(r, 20)
            ba, bb = r.read("II")
            vals = r.read("3f3f3f3f3f3f3f3f")
            v = np.array(vals, F).reshape(8, 3)
            m.constraints.append(P.Constraint(
                name, "", int(ba), int(bb), v[0], v[1], v[2], v[3], v[4],
                v[5], v[6], v[7]))

    return m


def _intern(names: list[str], name: str) -> int:
    if name in names:
        return names.index(name)
    names.append(name)
    return len(names) - 1


def load_pmd(path: str) -> P.PmxModel:
    with open(path, "rb") as f:
        return parse_pmd(f.read())
