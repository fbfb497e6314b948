"""PMX 2.0 model parser.

Feature-parity rebuild of libmmd's PmxReader (`reader/pmx_reader_impl.inl:17-449`
and `reader/interprete/pmx_types.inl`): header/flags, vertices with
BDEF1/BDEF2/BDEF4/SDEF skinning, triangles, texture table, materials with
per-part triangle ranges, bones (incl. IK links), all six morph kinds, display
frames (read and discarded, like the reference), rigid bodies, and 6DOF spring
constraints. Output is plain NumPy/host data; `core.model` packs it into padded
device arrays and applies `Model::Normalize` semantics.

The port's own copy of `simple_mmd_renderer_tpu/formats/pmx.py`: the same
dataclasses, constants and reader. The vertex records are read by the
native parser (`native/pmx_fast.cpp`, built with g++ at first use) when a
host compiler is there, else by the Python loop, the semantic reference:
both give the same arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils.io import BinReader, ParseError

# Skinning types (PMX encoding)
BDEF1, BDEF2, BDEF4, SDEF = 0, 1, 2, 3

# Morph types (PMX encoding, model.inl MORPH_TYPE_*)
MORPH_GROUP = 0
MORPH_VERTEX = 1
MORPH_BONE = 2
MORPH_UV = 3
MORPH_EXT_UV_1 = 4
MORPH_EXT_UV_2 = 5
MORPH_EXT_UV_3 = 6
MORPH_EXT_UV_4 = 7
MORPH_MATERIAL = 8

# Rigid body types
RIGID_KINEMATIC = 0
RIGID_PHYSICS = 1
RIGID_PHYSICS_STRICT = 2
RIGID_PHYSICS_GHOST = 3

# Rigid body shapes
SHAPE_SPHERE, SHAPE_BOX, SHAPE_CAPSULE = 0, 1, 2

# Bone flag bits (pmx_types.inl pmx_bone_flags)
BONE_CHILD_USE_ID = 0x0001
BONE_ROTATABLE = 0x0002
BONE_MOVABLE = 0x0004
BONE_VISIBLE = 0x0008
BONE_CONTROLLABLE = 0x0010
BONE_HAS_IK = 0x0020
BONE_APPEND_ROTATE = 0x0100
BONE_APPEND_TRANSLATE = 0x0200
BONE_ROT_AXIS_FIXED = 0x0400
BONE_USE_LOCAL_AXIS = 0x0800
BONE_POST_PHYSICS = 0x1000
BONE_RECEIVE_TRANSFORM = 0x2000

# Material draw flag bits
MAT_DOUBLE_FACE = 0x01
MAT_GROUND_SHADOW = 0x02
MAT_CAST_SELF_SHADOW = 0x04
MAT_DRAW_SELF_SHADOW = 0x08
MAT_DRAW_EDGE = 0x10

NONE = -1  # canonical "no entity" after parsing


@dataclass
class IKLink:
    bone: int
    has_limit: bool
    lo: np.ndarray  # [3]
    hi: np.ndarray  # [3]


@dataclass
class Bone:
    name: str
    name_en: str
    position: np.ndarray  # [3]
    parent: int
    transform_level: int
    flags: int
    child_index: int = NONE
    child_offset: np.ndarray | None = None
    append_parent: int = NONE
    append_ratio: float = 0.0
    fixed_axis: np.ndarray | None = None
    local_x: np.ndarray | None = None
    local_y: np.ndarray | None = None
    local_z: np.ndarray | None = None
    export_key: int = 0
    ik_target: int = NONE
    ik_loop: int = 0
    ik_angle: float = 0.0
    ik_links: list[IKLink] = field(default_factory=list)

    def has(self, bit: int) -> bool:
        return (self.flags & bit) != 0


@dataclass
class Material:
    name: str
    name_en: str
    diffuse: np.ndarray  # [4]
    specular: np.ndarray  # [3]
    shininess: float
    ambient: np.ndarray  # [3]
    draw_flags: int
    edge_color: np.ndarray  # [4]
    edge_size: float
    texture: int
    sub_texture: int
    sub_texture_type: int
    toon_is_global: bool
    toon: int
    meta: str
    n_triangles: int
    base_shift: int  # first triangle of this part (accumulated, reader:185-189)


@dataclass
class Morph:
    name: str
    name_en: str
    category: int
    type: int
    # typed payload (one of the below is non-None, by `type`)
    group_indices: np.ndarray | None = None     # [K]
    group_rates: np.ndarray | None = None       # [K]
    vertex_indices: np.ndarray | None = None    # [K]
    vertex_offsets: np.ndarray | None = None    # [K,3]
    bone_indices: np.ndarray | None = None      # [K]
    bone_translations: np.ndarray | None = None # [K,3]
    bone_rotations: np.ndarray | None = None    # [K,4] (x,y,z,w)
    uv_vertex_indices: np.ndarray | None = None # [K]
    uv_offsets: np.ndarray | None = None        # [K,4]
    material_indices: np.ndarray | None = None  # [K] (-1 = all/global)
    material_methods: np.ndarray | None = None  # [K] 0=mul 1=add
    material_payload: np.ndarray | None = None  # [K,28] packed floats


@dataclass
class RigidBody:
    name: str
    name_en: str
    bone: int
    group: int
    mask: int
    shape: int
    dimensions: np.ndarray  # [3]
    position: np.ndarray    # [3]
    rotation: np.ndarray    # [3] YXZ euler
    mass: float
    linear_damping: float
    angular_damping: float
    restitution: float
    friction: float
    type: int


@dataclass
class Constraint:
    name: str
    name_en: str
    body_a: int
    body_b: int
    position: np.ndarray   # [3]
    rotation: np.ndarray   # [3] YXZ euler
    pos_lo: np.ndarray     # [3]
    pos_hi: np.ndarray     # [3]
    rot_lo: np.ndarray     # [3]
    rot_hi: np.ndarray     # [3]
    spring_translate: np.ndarray  # [3]
    spring_rotate: np.ndarray     # [3]


@dataclass
class PmxModel:
    name: str = ""
    name_en: str = ""
    description: str = ""
    description_en: str = ""
    extra_uv_count: int = 0
    positions: np.ndarray = None   # [N,3] f32
    normals: np.ndarray = None     # [N,3] f32
    uvs: np.ndarray = None         # [N,2] f32
    extra_uvs: np.ndarray = None   # [N,E,4] f32
    skin_type: np.ndarray = None   # [N] u8
    skin_bones: np.ndarray = None  # [N,4] i32 (-1 pad)
    skin_weights: np.ndarray = None  # [N,4] f32
    sdef_c: np.ndarray = None      # [N,3]
    sdef_r0: np.ndarray = None     # [N,3]
    sdef_r1: np.ndarray = None     # [N,3]
    edge_scale: np.ndarray = None  # [N]
    triangles: np.ndarray = None   # [T,3] i32
    textures: list[str] = field(default_factory=list)
    materials: list[Material] = field(default_factory=list)
    bones: list[Bone] = field(default_factory=list)
    morphs: list[Morph] = field(default_factory=list)
    rigid_bodies: list[RigidBody] = field(default_factory=list)
    constraints: list[Constraint] = field(default_factory=list)


def _norm_index(idx: int, count: int) -> int:
    """Out-of-range raw index (255/65535/-1 'none' encodings) -> NONE."""
    return idx if 0 <= idx < count else NONE


def parse_pmx(data: bytes) -> PmxModel:
    """Parse PMX 2.0 bytes. Raises utils.io.ParseError (a ValueError) on any
    malformed/truncated/hostile input — counts are validated against the
    bytes actually left BEFORE sizing allocations, index widths against
    {1,2,4}, and triangle indices against the vertex count — so callers can
    catch one typed error per load and keep running (the reference catches
    reader exceptions per-load the same way, `main.cpp:692-698`)."""
    r = BinReader(data)
    magic = r.read_bytes(4, "magic")
    version = r.read("f", "version")
    flags_size = r.read("B", "flags size")
    if magic != b"PMX " or abs(version - 2.0) > 1e-6 or flags_size != 8:
        raise ParseError("not a PMX 2.0 file", 0, "header")

    utf8 = r.read("B", "encoding") > 0
    extra_uv = r.read("B", "extra uv count")
    if extra_uv > 4:
        raise ParseError(f"extra uv count {extra_uv} > 4", r.pos - 1,
                         "extra uv count")
    sz_vert, sz_tex, sz_mat, sz_bone, sz_morph, sz_rigid = (
        r.read("B", "index size") for _ in range(6))
    for label, sz in (("vertex", sz_vert), ("texture", sz_tex),
                      ("material", sz_mat), ("bone", sz_bone),
                      ("morph", sz_morph), ("rigid", sz_rigid)):
        if sz not in (1, 2, 4):
            raise ParseError(f"invalid {label} index size {sz} "
                             "(must be 1/2/4)", r.pos - 6, "index sizes")

    m = PmxModel()
    m.extra_uv_count = extra_uv
    m.name = r.read_text(utf8, "model name")
    m.name_en = r.read_text(utf8, "model name (en)")
    m.description = r.read_text(utf8, "description")
    m.description_en = r.read_text(utf8, "description (en)")

    # --- vertices: variable-size records (skinning type selects layout).
    # Min record: 8f basic + extra UVs + type byte + 1 bone index + edge f.
    n_vert = r.read_count(32 + 16 * extra_uv + 1 + sz_bone + 4,
                          "vertex count")
    positions = np.empty((n_vert, 3), np.float32)
    normals = np.empty((n_vert, 3), np.float32)
    uvs = np.empty((n_vert, 2), np.float32)
    extra_uvs = np.zeros((n_vert, extra_uv, 4), np.float32)
    skin_type = np.zeros(n_vert, np.uint8)
    skin_bones = np.full((n_vert, 4), NONE, np.int32)
    skin_weights = np.zeros((n_vert, 4), np.float32)
    sdef_c = np.zeros((n_vert, 3), np.float32)
    sdef_r0 = np.zeros((n_vert, 3), np.float32)
    sdef_r1 = np.zeros((n_vert, 3), np.float32)
    edge_scale = np.empty(n_vert, np.float32)

    _parse_vertices_python(
        r, n_vert, extra_uv, sz_bone, positions, normals, uvs,
        extra_uvs, skin_type, skin_bones, skin_weights, sdef_c, sdef_r0,
        sdef_r1, edge_scale)

    m.positions, m.normals, m.uvs = positions, normals, uvs
    m.extra_uvs = extra_uvs
    m.skin_type, m.skin_bones, m.skin_weights = skin_type, skin_bones, skin_weights
    m.sdef_c, m.sdef_r0, m.sdef_r1 = sdef_c, sdef_r0, sdef_r1
    m.edge_scale = edge_scale
    _finish_parse(m, r, utf8, sz_vert, sz_tex, sz_mat, sz_bone, sz_morph,
                  sz_rigid)
    return m


def _norm_bone_ref(idx: int, size: int) -> int:
    """'none' encodings (255/65535/negative) -> -1."""
    if size == 1 and idx == 0xFF:
        return -1
    if size == 2 and idx == 0xFFFF:
        return -1
    return idx


def _parse_vertices_python(r, n_vert, extra_uv, sz_bone, positions, normals,
                           uvs, extra_uvs, skin_type, skin_bones,
                           skin_weights, sdef_c, sdef_r0, sdef_r1, edge_scale):
    for i in range(n_vert):
        basic = r.read("8f")
        positions[i] = basic[0:3]
        normals[i] = basic[3:6]
        uvs[i] = basic[6:8]
        for e in range(extra_uv):
            extra_uvs[i, e] = r.read("4f")
        st = r.read("b")
        skin_type[i] = st
        rb = lambda: _norm_bone_ref(r.read_index(sz_bone), sz_bone)
        if st == BDEF1:
            skin_bones[i, 0] = rb()
            skin_weights[i, 0] = 1.0
        elif st == BDEF2:
            skin_bones[i, 0] = rb()
            skin_bones[i, 1] = rb()
            w = r.read("f")
            skin_weights[i, 0] = w
            skin_weights[i, 1] = 1.0 - w
        elif st == BDEF4:
            for j in range(4):
                skin_bones[i, j] = rb()
            skin_weights[i] = r.read("4f")
        elif st == SDEF:
            skin_bones[i, 0] = rb()
            skin_bones[i, 1] = rb()
            w = r.read("f")
            skin_weights[i, 0] = w
            skin_weights[i, 1] = 1.0 - w
            sdef_c[i] = r.read("3f")
            sdef_r0[i] = r.read("3f")
            sdef_r1[i] = r.read("3f")
        else:
            raise ParseError(f"invalid skinning type {st} at vertex {i}",
                             r.pos - 1, "skinning type")
        edge_scale[i] = r.read("f")


def _finish_parse(m, r, utf8, sz_vert, sz_tex, sz_mat, sz_bone, sz_morph,
                  sz_rigid):
    # --- triangles (fixed-size: bulk numpy read)
    n_index = r.read_count(sz_vert, "index count")
    if n_index % 3 != 0:
        raise ParseError(f"index count {n_index} not a multiple of 3",
                         r.pos - 4, "index count")
    idx_dtype = {1: np.uint8, 2: np.uint16, 4: np.int32}[sz_vert]
    tri_flat = r.read_array(idx_dtype, n_index, "triangles").astype(np.int32)
    n_vert = len(m.positions)
    if n_index and (int(tri_flat.min()) < 0 or int(tri_flat.max()) >= n_vert):
        raise ParseError(
            f"triangle index out of range [0, {n_vert})", r.pos, "triangles")
    m.triangles = tri_flat.reshape(-1, 3)

    # --- textures
    n_tex = r.read_count(4, "texture count")
    m.textures = [r.read_text(utf8, "texture path") for _ in range(n_tex)]

    # --- materials / parts
    # min record: 2 texts + 11f + flag + 4f+f edge + 2 tex idx + 2B + meta
    # text + i32 triangle count
    n_mat = r.read_count(8 + 44 + 1 + 20 + 2 * sz_tex + 2 + 4 + 4,
                         "material count")
    base_shift = 0
    for _ in range(n_mat):
        name = r.read_text(utf8)
        name_en = r.read_text(utf8)
        vals = r.read("4f3ff3f")
        diffuse = np.array(vals[0:4], np.float32)
        specular = np.array(vals[4:7], np.float32)
        shininess = vals[7]
        ambient = np.array(vals[8:11], np.float32)
        draw_flag = r.read("B")
        edge = r.read("4ff")
        tex = _norm_index(r.read_index(sz_tex), n_tex)
        sub_tex = _norm_index(r.read_index(sz_tex), n_tex)
        sub_type = r.read("B")
        use_global_toon = r.read("B") > 0
        if use_global_toon:
            toon = r.read("B")
        else:
            toon = _norm_index(r.read_index(sz_tex), n_tex)
        meta = r.read_text(utf8, "material meta")
        part_indices = r.read("i", "material index count")
        if part_indices < 0:
            raise ParseError(f"negative part index count {part_indices}",
                             r.pos - 4, "material index count")
        part_tris = part_indices // 3
        m.materials.append(Material(
            name, name_en, diffuse, specular, shininess, ambient, draw_flag,
            np.array(edge[0:4], np.float32), edge[4], tex, sub_tex, sub_type,
            use_global_toon, toon, meta, part_tris, base_shift))
        base_shift += part_tris

    # --- bones
    # min record: 2 texts + 3f + parent idx + i32 level + u16 flags + 3f or
    # child idx (flag-dependent; child idx of 1 byte is the floor)
    n_bone = r.read_count(8 + 12 + sz_bone + 4 + 2 + 1, "bone count")
    for _ in range(n_bone):
        name = r.read_text(utf8)
        name_en = r.read_text(utf8)
        pos = np.array(r.read("3f"), np.float32)
        parent = _norm_index(r.read_index(sz_bone), n_bone)
        level = r.read("i")
        flags = r.read("H")
        b = Bone(name, name_en, pos, parent, level, flags)
        if b.has(BONE_CHILD_USE_ID):
            b.child_index = r.read_index(sz_bone)
        else:
            b.child_offset = np.array(r.read("3f"), np.float32)
        if b.has(BONE_APPEND_ROTATE) or b.has(BONE_APPEND_TRANSLATE):
            b.append_parent = _norm_index(r.read_index(sz_bone), n_bone)
            b.append_ratio = r.read("f")
        if b.has(BONE_ROT_AXIS_FIXED):
            b.fixed_axis = np.array(r.read("3f"), np.float32)
        if b.has(BONE_USE_LOCAL_AXIS):
            lx = np.array(r.read("3f"), np.float32)
            lz = np.array(r.read("3f"), np.float32)
            ly = np.cross(lz, lx)
            lz = np.cross(lx, ly)
            def _n(v):
                n = np.linalg.norm(v)
                return v / n if n > 0 else v
            b.local_x, b.local_y, b.local_z = _n(lx), _n(ly), _n(lz)
        if b.has(BONE_RECEIVE_TRANSFORM):
            b.export_key = r.read("i")
        if b.has(BONE_HAS_IK):
            b.ik_target = _norm_index(r.read_index(sz_bone), n_bone)
            b.ik_loop = r.read("i")
            b.ik_angle = r.read("f")
            n_links = r.read_count(sz_bone + 1, "ik link count")
            for _ in range(n_links):
                link = r.read_index(sz_bone)
                has_limit = r.read("b") != 0
                if has_limit:
                    lo = np.array(r.read("3f"), np.float32)
                    hi = np.array(r.read("3f"), np.float32)
                else:
                    lo = hi = np.zeros(3, np.float32)
                b.ik_links.append(IKLink(link, has_limit, lo, hi))
        m.bones.append(b)

    # --- morphs
    n_morph = r.read_count(8 + 2 + 4, "morph count")
    _morph_min_rec = {
        MORPH_GROUP: sz_morph + 4, MORPH_VERTEX: sz_vert + 12,
        MORPH_BONE: sz_bone + 28, MORPH_UV: sz_vert + 16,
        MORPH_EXT_UV_1: sz_vert + 16, MORPH_EXT_UV_2: sz_vert + 16,
        MORPH_EXT_UV_3: sz_vert + 16, MORPH_EXT_UV_4: sz_vert + 16,
        MORPH_MATERIAL: sz_mat + 1 + 112,
    }
    for _ in range(n_morph):
        name = r.read_text(utf8, "morph name")
        name_en = r.read_text(utf8, "morph name (en)")
        category = r.read("B")
        mtype = r.read("B")
        if mtype not in _morph_min_rec:
            raise ParseError(f"unknown morph type {mtype}", r.pos - 1,
                             "morph type")
        k = r.read_count(_morph_min_rec[mtype], "morph entry count")
        morph = Morph(name, name_en, category, mtype)
        if mtype == MORPH_GROUP:
            idxs = np.empty(k, np.int32)
            rates = np.empty(k, np.float32)
            for j in range(k):
                idxs[j] = r.read_index(sz_morph)
                rates[j] = r.read("f")
            morph.group_indices, morph.group_rates = idxs, rates
        elif mtype == MORPH_VERTEX:
            idxs = np.empty(k, np.int32)
            offs = np.empty((k, 3), np.float32)
            for j in range(k):
                idxs[j] = r.read_index(sz_vert)
                offs[j] = r.read("3f")
            if k and (int(idxs.min()) < 0 or int(idxs.max()) >= n_vert):
                raise ParseError(
                    f"vertex morph index out of range [0, {n_vert})",
                    r.pos, "vertex morph")
            morph.vertex_indices, morph.vertex_offsets = idxs, offs
        elif mtype == MORPH_BONE:
            idxs = np.empty(k, np.int32)
            trans = np.empty((k, 3), np.float32)
            rots = np.empty((k, 4), np.float32)
            for j in range(k):
                idxs[j] = r.read_index(sz_bone)
                trans[j] = r.read("3f")
                rots[j] = r.read("4f")
            morph.bone_indices, morph.bone_translations = idxs, trans
            morph.bone_rotations = rots
        elif mtype in (MORPH_UV, MORPH_EXT_UV_1, MORPH_EXT_UV_2,
                       MORPH_EXT_UV_3, MORPH_EXT_UV_4):
            idxs = np.empty(k, np.int32)
            offs = np.empty((k, 4), np.float32)
            for j in range(k):
                idxs[j] = r.read_index(sz_vert)
                offs[j] = r.read("4f")
            if k and (int(idxs.min()) < 0 or int(idxs.max()) >= n_vert):
                raise ParseError(
                    f"uv morph index out of range [0, {n_vert})",
                    r.pos, "uv morph")
            morph.uv_vertex_indices, morph.uv_offsets = idxs, offs
        elif mtype == MORPH_MATERIAL:
            idxs = np.empty(k, np.int32)
            methods = np.empty(k, np.uint8)
            payload = np.empty((k, 28), np.float32)
            for j in range(k):
                idxs[j] = _norm_index(r.read_index(sz_mat), n_mat)
                methods[j] = r.read("B")
                payload[j] = r.read("28f")
            morph.material_indices = idxs
            morph.material_methods = methods
            morph.material_payload = payload
        else:  # unreachable: mtype validated against _morph_min_rec above
            raise ParseError(f"unknown morph type {mtype}", r.pos,
                             "morph type")
        m.morphs.append(morph)

    # --- display frames: read and discard (reference reader:363-382)
    n_frames = r.read_count(8 + 1 + 4, "display frame count")
    for _ in range(n_frames):
        r.read_text(utf8, "display frame name")
        r.read_text(utf8, "display frame name (en)")
        r.read("B")
        n_el = r.read_count(2, "display element count")
        for _ in range(n_el):
            is_morph = r.read("B") == 1
            r.read_index(sz_morph if is_morph else sz_bone)

    # --- rigid bodies
    n_rigid = r.read_count(8 + sz_bone + 4 + 56 + 1, "rigid body count")
    for _ in range(n_rigid):
        name = r.read_text(utf8, "rigid body name")
        name_en = r.read_text(utf8, "rigid body name (en)")
        bone = _norm_index(r.read_index(sz_bone), n_bone)
        group = r.read("B")
        mask = r.read("H")
        shape = r.read("B")
        vals = r.read("3f3f3f5f")
        rb_type_byte = r.read("B")
        m.rigid_bodies.append(RigidBody(
            name, name_en, bone, group, mask, shape,
            np.array(vals[0:3], np.float32), np.array(vals[3:6], np.float32),
            np.array(vals[6:9], np.float32),
            vals[9], vals[10], vals[11], vals[12], vals[13], rb_type_byte))

    # --- constraints (6DOF spring joints only, reader:410-440)
    # min record: 2 texts + type byte + 2 rigid idx + 24f
    n_cons = r.read_count(8 + 1 + 2 * sz_rigid + 96, "constraint count")
    for _ in range(n_cons):
        name = r.read_text(utf8, "constraint name")
        name_en = r.read_text(utf8, "constraint name (en)")
        dof_type = r.read("B")
        if dof_type != 0:
            raise ParseError("only 6DOF spring joints are supported",
                             r.pos - 1, "constraint type")
        ba = r.read_index(sz_rigid)
        bb = r.read_index(sz_rigid)
        vals = r.read("3f3f3f3f3f3f3f3f")
        v = np.array(vals, np.float32).reshape(8, 3)
        m.constraints.append(Constraint(
            name, name_en, _norm_index(ba, n_rigid), _norm_index(bb, n_rigid),
            v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]))

    return m


def load_pmx(path: str) -> PmxModel:
    with open(path, "rb") as f:
        return parse_pmx(f.read())
