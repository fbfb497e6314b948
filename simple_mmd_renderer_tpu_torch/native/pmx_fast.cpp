// Native PMX vertex-section parser.
//
// The PMX vertex section is a stream of variable-size records (skinning type
// decides the record layout), which forces a per-vertex loop. The reference
// keeps this in C++ (libmmd's PmxReader vertex loop,
// reader/pmx_reader_impl.inl:50-102); this is our native equivalent, exposed
// through a C ABI for ctypes. Output layout matches formats/pmx.py exactly:
// 4-wide normalized bone/weight tables, SDEF payloads, edge scales.
//
// Built by native/__init__.py (g++ -O2 -shared -fPIC) into build/native/
// at the repository root, named after a hash of this source.

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

struct Cursor {
    const uint8_t* data;
    size_t len;
    size_t pos;
    bool ok;

    template <typename T> T read() {
        if (pos + sizeof(T) > len) { ok = false; return T(); }
        T v;
        std::memcpy(&v, data + pos, sizeof(T));
        pos += sizeof(T);
        return v;
    }

    int32_t read_index(int size) {
        switch (size) {
            case 1: return (int32_t)read<uint8_t>();
            case 2: return (int32_t)read<uint16_t>();
            case 4: return read<int32_t>();
            default: ok = false; return -1;
        }
    }

    void read_floats(float* dst, int n) {
        if (pos + sizeof(float) * n > len) { ok = false; return; }
        std::memcpy(dst, data + pos, sizeof(float) * n);
        pos += sizeof(float) * n;
    }
};

// "none" encodings (255/65535) -> -1; real indices pass through
inline int32_t norm_index(int32_t idx, int size) {
    if (size == 1 && idx == 0xFF) return -1;
    if (size == 2 && idx == 0xFFFF) return -1;
    return idx;
}

}  // namespace

extern "C" int pmx_parse_vertices(
    const uint8_t* data, size_t len, size_t start_offset,
    int32_t n_verts, int32_t extra_uv, int32_t bone_index_size,
    float* positions, float* normals, float* uvs, float* extra_uvs,
    uint8_t* skin_type, int32_t* skin_bones, float* skin_weights,
    float* sdef_c, float* sdef_r0, float* sdef_r1, float* edge_scale,
    size_t* end_offset) {
    Cursor c{data, len, start_offset, true};

    for (int32_t i = 0; i < n_verts; ++i) {
        c.read_floats(positions + i * 3, 3);
        c.read_floats(normals + i * 3, 3);
        c.read_floats(uvs + i * 2, 2);
        for (int32_t e = 0; e < extra_uv; ++e)
            c.read_floats(extra_uvs + (i * extra_uv + e) * 4, 4);

        int8_t st = c.read<int8_t>();
        skin_type[i] = (uint8_t)st;
        int32_t* b = skin_bones + i * 4;
        float* w = skin_weights + i * 4;
        b[0] = b[1] = b[2] = b[3] = -1;
        w[0] = w[1] = w[2] = w[3] = 0.0f;
        switch (st) {
            case 0:  // BDEF1
                b[0] = norm_index(c.read_index(bone_index_size),
                                  bone_index_size);
                w[0] = 1.0f;
                break;
            case 1: {  // BDEF2
                b[0] = norm_index(c.read_index(bone_index_size),
                                  bone_index_size);
                b[1] = norm_index(c.read_index(bone_index_size),
                                  bone_index_size);
                float wt = c.read<float>();
                w[0] = wt;
                w[1] = 1.0f - wt;
                break;
            }
            case 2:  // BDEF4
                for (int k = 0; k < 4; ++k)
                    b[k] = norm_index(c.read_index(bone_index_size),
                                      bone_index_size);
                c.read_floats(w, 4);
                break;
            case 3: {  // SDEF
                b[0] = norm_index(c.read_index(bone_index_size),
                                  bone_index_size);
                b[1] = norm_index(c.read_index(bone_index_size),
                                  bone_index_size);
                float wt = c.read<float>();
                w[0] = wt;
                w[1] = 1.0f - wt;
                c.read_floats(sdef_c + i * 3, 3);
                c.read_floats(sdef_r0 + i * 3, 3);
                c.read_floats(sdef_r1 + i * 3, 3);
                break;
            }
            default:
                return -2;  // invalid skinning type
        }
        edge_scale[i] = c.read<float>();
        if (!c.ok) return -1;  // buffer overrun
    }
    *end_offset = c.pos;
    return 0;
}
