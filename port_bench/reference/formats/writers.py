"""PMX 2.0 / VMD binary writers.

The port's copy of `simple_mmd_renderer_tpu/formats/writers.py`: `write_pmx`
and `write_vmd` emit the exact layouts the port's `formats.pmx` and
`formats.vmd` parse (all PMX index fields 4 bytes wide), byte for byte the
reference's. They synthesize models and motions where no asset ships (the
procedural sample dance goes through `write_vmd`) and double as an export
path.
"""

from __future__ import annotations

import struct

import numpy as np

from ..utils.io import encode_shift_jis
from . import pmx as P

MAGIC_PADDED = b"Vocaloid Motion Data 0002" + b"\x00" * 5


def _text(s: str, utf8: bool) -> bytes:
    raw = s.encode("utf-8" if utf8 else "utf-16-le")
    return struct.pack("<i", len(raw)) + raw


def write_pmx(m: P.PmxModel, utf8: bool = True) -> bytes:
    out = bytearray()
    w = out.extend
    w(b"PMX ")
    w(struct.pack("<fB", 2.0, 8))
    w(struct.pack("<8B", 1 if utf8 else 0, m.extra_uv_count, 4, 4, 4, 4, 4, 4))
    for s in (m.name, m.name_en, m.description, m.description_en):
        w(_text(s, utf8))

    n_vert = len(m.positions)
    w(struct.pack("<i", n_vert))
    for i in range(n_vert):
        w(struct.pack("<8f", *m.positions[i], *m.normals[i], *m.uvs[i]))
        for e in range(m.extra_uv_count):
            w(struct.pack("<4f", *m.extra_uvs[i, e]))
        st = int(m.skin_type[i])
        w(struct.pack("<b", st))
        if st == P.BDEF1:
            w(struct.pack("<i", int(m.skin_bones[i, 0])))
        elif st == P.BDEF2:
            w(struct.pack("<iif", int(m.skin_bones[i, 0]), int(m.skin_bones[i, 1]),
                          float(m.skin_weights[i, 0])))
        elif st == P.BDEF4:
            w(struct.pack("<4i", *(int(b) for b in m.skin_bones[i])))
            w(struct.pack("<4f", *m.skin_weights[i]))
        elif st == P.SDEF:
            w(struct.pack("<iif", int(m.skin_bones[i, 0]), int(m.skin_bones[i, 1]),
                          float(m.skin_weights[i, 0])))
            w(struct.pack("<9f", *m.sdef_c[i], *m.sdef_r0[i], *m.sdef_r1[i]))
        w(struct.pack("<f", float(m.edge_scale[i])))

    tris = np.asarray(m.triangles, np.int32)
    w(struct.pack("<i", tris.size))
    w(tris.astype("<i4").tobytes())

    w(struct.pack("<i", len(m.textures)))
    for t in m.textures:
        w(_text(t, utf8))

    w(struct.pack("<i", len(m.materials)))
    for mat in m.materials:
        w(_text(mat.name, utf8))
        w(_text(mat.name_en, utf8))
        w(struct.pack("<11f", *mat.diffuse, *mat.specular, mat.shininess, *mat.ambient))
        w(struct.pack("<B", mat.draw_flags))
        w(struct.pack("<5f", *mat.edge_color, mat.edge_size))
        w(struct.pack("<ii", mat.texture, mat.sub_texture))
        w(struct.pack("<B", mat.sub_texture_type))
        w(struct.pack("<B", 1 if mat.toon_is_global else 0))
        if mat.toon_is_global:
            w(struct.pack("<B", max(mat.toon, 0)))
        else:
            w(struct.pack("<i", mat.toon))
        w(_text(mat.meta, utf8))
        w(struct.pack("<i", mat.n_triangles * 3))

    w(struct.pack("<i", len(m.bones)))
    for b in m.bones:
        w(_text(b.name, utf8))
        w(_text(b.name_en, utf8))
        w(struct.pack("<3f", *b.position))
        w(struct.pack("<i", b.parent))
        w(struct.pack("<i", b.transform_level))
        w(struct.pack("<H", b.flags))
        if b.has(P.BONE_CHILD_USE_ID):
            w(struct.pack("<i", b.child_index))
        else:
            off = b.child_offset if b.child_offset is not None else np.zeros(3, np.float32)
            w(struct.pack("<3f", *off))
        if b.has(P.BONE_APPEND_ROTATE) or b.has(P.BONE_APPEND_TRANSLATE):
            w(struct.pack("<if", b.append_parent, b.append_ratio))
        if b.has(P.BONE_ROT_AXIS_FIXED):
            w(struct.pack("<3f", *b.fixed_axis))
        if b.has(P.BONE_USE_LOCAL_AXIS):
            w(struct.pack("<3f", *b.local_x))
            w(struct.pack("<3f", *b.local_z))
        if b.has(P.BONE_RECEIVE_TRANSFORM):
            w(struct.pack("<i", b.export_key))
        if b.has(P.BONE_HAS_IK):
            w(struct.pack("<iif", b.ik_target, b.ik_loop, b.ik_angle))
            w(struct.pack("<i", len(b.ik_links)))
            for link in b.ik_links:
                w(struct.pack("<ib", link.bone, 1 if link.has_limit else 0))
                if link.has_limit:
                    w(struct.pack("<6f", *link.lo, *link.hi))

    w(struct.pack("<i", len(m.morphs)))
    for mo in m.morphs:
        w(_text(mo.name, utf8))
        w(_text(mo.name_en, utf8))
        w(struct.pack("<BB", mo.category, mo.type))
        if mo.type == P.MORPH_GROUP:
            w(struct.pack("<i", len(mo.group_indices)))
            for i, rate in zip(mo.group_indices, mo.group_rates):
                w(struct.pack("<if", int(i), float(rate)))
        elif mo.type == P.MORPH_VERTEX:
            w(struct.pack("<i", len(mo.vertex_indices)))
            for i, off in zip(mo.vertex_indices, mo.vertex_offsets):
                w(struct.pack("<i3f", int(i), *off))
        elif mo.type == P.MORPH_BONE:
            w(struct.pack("<i", len(mo.bone_indices)))
            for i, t, q in zip(mo.bone_indices, mo.bone_translations, mo.bone_rotations):
                w(struct.pack("<i7f", int(i), *t, *q))
        elif mo.type in (P.MORPH_UV, P.MORPH_EXT_UV_1, P.MORPH_EXT_UV_2,
                         P.MORPH_EXT_UV_3, P.MORPH_EXT_UV_4):
            w(struct.pack("<i", len(mo.uv_vertex_indices)))
            for i, off in zip(mo.uv_vertex_indices, mo.uv_offsets):
                w(struct.pack("<i4f", int(i), *off))
        elif mo.type == P.MORPH_MATERIAL:
            w(struct.pack("<i", len(mo.material_indices)))
            for i, meth, pay in zip(mo.material_indices, mo.material_methods,
                                    mo.material_payload):
                w(struct.pack("<iB28f", int(i), int(meth), *pay))

    w(struct.pack("<i", 0))  # display frames

    w(struct.pack("<i", len(m.rigid_bodies)))
    for rb in m.rigid_bodies:
        w(_text(rb.name, utf8))
        w(_text(rb.name_en, utf8))
        w(struct.pack("<i", rb.bone))
        w(struct.pack("<BHB", rb.group, rb.mask, rb.shape))
        w(struct.pack("<14f", *rb.dimensions, *rb.position, *rb.rotation,
                      rb.mass, rb.linear_damping, rb.angular_damping,
                      rb.restitution, rb.friction))
        w(struct.pack("<B", rb.type))

    w(struct.pack("<i", len(m.constraints)))
    for c in m.constraints:
        w(_text(c.name, utf8))
        w(_text(c.name_en, utf8))
        w(struct.pack("<B", 0))
        w(struct.pack("<ii", c.body_a, c.body_b))
        w(struct.pack("<24f", *c.position, *c.rotation, *c.pos_lo, *c.pos_hi,
                      *c.rot_lo, *c.rot_hi, *c.spring_translate, *c.spring_rotate))

    return bytes(out)


def write_vmd(name: str,
              bone_keys: list[tuple[str, int, np.ndarray, np.ndarray, np.ndarray]],
              morph_keys: list[tuple[str, int, float]] = (),
              camera_keys: list[dict] = (),
              light_keys: list[dict] = ()) -> bytes:
    """bone_keys: (name, frame, trans[3], quat[4] xyzw, interp[4,4] int8 rows
    (c0x,c0y,c1x,c1y) per channel x/y/z/r).
    light_keys: dicts with frame, color[3], direction[3] (the VMD light
    section after the camera track)."""
    out = bytearray()
    w = out.extend
    w(MAGIC_PADDED)
    w(encode_shift_jis(name, 20))
    w(struct.pack("<I", len(bone_keys)))
    for bname, frame, trans, quat, interp in bone_keys:
        w(encode_shift_jis(bname, 15))
        w(struct.pack("<I", frame))
        w(struct.pack("<3f", *trans))
        w(struct.pack("<4f", *quat))
        interp = np.asarray(interp, np.int8).reshape(4, 4)
        for ch in range(4):
            block = np.zeros(16, np.int8)
            block[0], block[4], block[8], block[12] = interp[ch]
            w(block.tobytes())
    w(struct.pack("<I", len(morph_keys)))
    for mname, frame, weight in morph_keys:
        w(encode_shift_jis(mname, 15))
        w(struct.pack("<If", frame, weight))
    w(struct.pack("<I", len(camera_keys)))
    for ck in camera_keys:
        w(struct.pack("<If", ck["frame"], ck.get("focal_length", 45.0)))
        w(struct.pack("<3f", *ck.get("position", (0, 0, 0))))
        w(struct.pack("<3f", *ck.get("rotation", (0, 0, 0))))
        w(np.zeros(24, np.int8).tobytes())
        w(struct.pack("<fB", ck.get("fov", 30.0), 1 if ck.get("orthographic") else 0))
    if light_keys:
        w(struct.pack("<I", len(light_keys)))
        for lk in light_keys:
            w(struct.pack("<I", lk["frame"]))
            w(struct.pack("<3f", *lk.get("color", (1.0, 1.0, 1.0))))
            w(struct.pack("<3f", *lk.get("direction", (-0.5, -1.0, 0.5))))
    return bytes(out)
