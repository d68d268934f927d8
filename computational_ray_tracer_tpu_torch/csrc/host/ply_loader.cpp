// Native Stanford-PLY mesh loader (ascii + binary little/big endian): host
// code, one-shot scene set-up.
//
// A copy of the JAX package's computational_ray_tracer_tpu/native/
// ply_loader.cpp (the port imports nothing of that package). Semantics match
// the Python parser in utils/ply_loader.py exactly (asserted in
// tests/test_torch_assets.py):
//   - vertex properties x/y/z, optional nx/ny/nz, and u/v (preferred) or
//     s/t texcoords, any scalar numeric type, converted to float32;
//   - faces fan-triangulated from the vertex_indices/vertex_index list;
//   - unknown elements and properties are walked and skipped;
//   - big-endian files are byte-swapped.
//
// Build: kernels/build.load_host_library() runs
//   g++ -O3 -std=c++17 -shared -fPIC -o build/libcrt_host.so csrc/host/*.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum PType : int {
    T_I8, T_U8, T_I16, T_U16, T_I32, T_U32, T_F32, T_F64, T_BAD
};

int type_size(PType t) {
    switch (t) {
        case T_I8: case T_U8: return 1;
        case T_I16: case T_U16: return 2;
        case T_I32: case T_U32: return 4;
        case T_F32: return 4;
        case T_F64: return 8;
        default: return 0;
    }
}

PType parse_type(const std::string& s) {
    if (s == "char" || s == "int8") return T_I8;
    if (s == "uchar" || s == "uint8") return T_U8;
    if (s == "short" || s == "int16") return T_I16;
    if (s == "ushort" || s == "uint16") return T_U16;
    if (s == "int" || s == "int32") return T_I32;
    if (s == "uint" || s == "uint32") return T_U32;
    if (s == "float" || s == "float32") return T_F32;
    if (s == "double" || s == "float64") return T_F64;
    return T_BAD;
}

struct Prop {
    std::string name;
    bool is_list = false;
    PType count_type = T_BAD;   // list count type
    PType val_type = T_BAD;     // scalar / list value type
};

struct Element {
    std::string name;
    long count = 0;
    std::vector<Prop> props;
};

double swap_read(const uint8_t* p, PType t, bool big) {
    uint8_t b[8];
    int n = type_size(t);
    for (int i = 0; i < n; ++i) b[i] = big ? p[n - 1 - i] : p[i];
    switch (t) {
        case T_I8: return (double)*(int8_t*)b;
        case T_U8: return (double)*(uint8_t*)b;
        case T_I16: { int16_t v; memcpy(&v, b, 2); return v; }
        case T_U16: { uint16_t v; memcpy(&v, b, 2); return v; }
        case T_I32: { int32_t v; memcpy(&v, b, 4); return v; }
        case T_U32: { uint32_t v; memcpy(&v, b, 4); return (double)v; }
        case T_F32: { float v; memcpy(&v, b, 4); return v; }
        case T_F64: { double v; memcpy(&v, b, 8); return v; }
        default: return 0.0;
    }
}

}  // namespace

extern "C" {

// Keep this definition identical to mesh_loader.cpp and native/__init__.py.
struct CrtMesh {
    int64_t n_verts;
    int64_t n_tris;
    int32_t has_normals;
    int32_t has_uvs;
    float* positions;   // (n_verts, 3)
    int32_t* indices;   // (n_tris, 3)
    float* uvs;         // (n_verts, 2)
    float* normals;     // (n_verts, 3)
};

int crt_load_ply(const char* path, CrtMesh* out) {
    memset(out, 0, sizeof(*out));
    FILE* fp = fopen(path, "rb");
    if (!fp) return 1;
    fseek(fp, 0, SEEK_END);
    long sz = ftell(fp);
    fseek(fp, 0, SEEK_SET);
    std::vector<char> buf((size_t)sz);
    if (sz && fread(buf.data(), 1, (size_t)sz, fp) != (size_t)sz) {
        fclose(fp);
        return 1;
    }
    fclose(fp);

    // --- header (line-oriented ascii) ---
    size_t pos = 0;
    auto read_line = [&](std::string& line) -> bool {
        if (pos >= buf.size()) return false;
        size_t e = pos;
        while (e < buf.size() && buf[e] != '\n') ++e;
        line.assign(&buf[pos], e - pos);
        while (!line.empty()
               && (line.back() == '\r' || line.back() == ' '))
            line.pop_back();
        pos = e < buf.size() ? e + 1 : e;
        return true;
    };
    auto tokens = [](const std::string& line) {
        std::vector<std::string> t;
        size_t i = 0;
        while (i < line.size()) {
            while (i < line.size() && (line[i] == ' ' || line[i] == '\t'))
                ++i;
            size_t j = i;
            while (j < line.size() && line[j] != ' ' && line[j] != '\t')
                ++j;
            if (j > i) t.emplace_back(line.substr(i, j - i));
            i = j;
        }
        return t;
    };

    std::string line;
    if (!read_line(line) || line != "ply") return 2;
    int fmt = -1;   // 0 ascii, 1 little, 2 big
    std::vector<Element> elems;
    while (read_line(line)) {
        auto t = tokens(line);
        if (t.empty() || t[0] == "comment" || t[0] == "obj_info") continue;
        if (t[0] == "format" && t.size() >= 2) {
            if (t[1] == "ascii") fmt = 0;
            else if (t[1] == "binary_little_endian") fmt = 1;
            else if (t[1] == "binary_big_endian") fmt = 2;
            else return 2;
        } else if (t[0] == "element" && t.size() >= 3) {
            Element e;
            e.name = t[1];
            e.count = strtol(t[2].c_str(), nullptr, 10);
            elems.push_back(e);
        } else if (t[0] == "property" && !elems.empty()) {
            Prop p;
            if (t.size() >= 5 && t[1] == "list") {
                p.is_list = true;
                p.count_type = parse_type(t[2]);
                p.val_type = parse_type(t[3]);
                p.name = t[4];
            } else if (t.size() >= 3) {
                p.val_type = parse_type(t[1]);
                p.name = t[2];
            } else {
                return 2;
            }
            if (p.val_type == T_BAD
                || (p.is_list && p.count_type == T_BAD))
                return 2;
            elems.back().props.push_back(p);
        } else if (t[0] == "end_header") {
            break;
        }
    }
    if (fmt < 0) return 2;
    bool big = fmt == 2;

    // vertex columns we keep: x y z nx ny nz (u v | s t)
    std::vector<float> px, py, pz, nx, ny, nz, tu, tv;
    bool have_n = false, have_uv = false, have_st = false;
    std::vector<std::vector<int32_t>> polys;

    // ascii tokenizer state (shares `pos` with the binary walker)
    auto ascii_next = [&]() -> double {
        while (pos < buf.size()
               && (buf[pos] == ' ' || buf[pos] == '\t' || buf[pos] == '\r'
                   || buf[pos] == '\n'))
            ++pos;
        char* q;
        double v = strtod(&buf[pos], &q);
        pos = (size_t)(q - buf.data());
        return v;
    };

    for (const auto& e : elems) {
        bool is_vertex = e.name == "vertex";
        bool is_face = e.name == "face";
        int face_prop = -1;
        if (is_face) {
            for (size_t pi = 0; pi < e.props.size(); ++pi)
                if (e.props[pi].is_list
                    && (e.props[pi].name == "vertex_indices"
                        || e.props[pi].name == "vertex_index")) {
                    face_prop = (int)pi;
                    break;
                }
        }
        if (is_vertex) {
            for (const auto& p : e.props) {
                if (p.name == "nx") have_n = true;
                if (p.name == "u") have_uv = true;
                if (p.name == "s") have_st = true;
            }
            px.reserve(e.count); py.reserve(e.count); pz.reserve(e.count);
        }
        for (long r = 0; r < e.count; ++r) {
            std::vector<int32_t> face_vals;
            for (size_t pi = 0; pi < e.props.size(); ++pi) {
                const Prop& p = e.props[pi];
                long n_vals = 1;
                if (p.is_list) {
                    if (fmt == 0) {
                        n_vals = (long)ascii_next();
                    } else {
                        if (pos + type_size(p.count_type) > buf.size())
                            return 3;
                        n_vals = (long)swap_read(
                            (const uint8_t*)&buf[pos], p.count_type, big);
                        pos += type_size(p.count_type);
                    }
                }
                for (long k = 0; k < n_vals; ++k) {
                    double v;
                    if (fmt == 0) {
                        v = ascii_next();
                    } else {
                        if (pos + type_size(p.val_type) > buf.size())
                            return 3;
                        v = swap_read((const uint8_t*)&buf[pos],
                                      p.val_type, big);
                        pos += type_size(p.val_type);
                    }
                    if (is_vertex) {
                        float f = (float)v;
                        if (p.name == "x") px.push_back(f);
                        else if (p.name == "y") py.push_back(f);
                        else if (p.name == "z") pz.push_back(f);
                        else if (p.name == "nx") nx.push_back(f);
                        else if (p.name == "ny") ny.push_back(f);
                        else if (p.name == "nz") nz.push_back(f);
                        else if (have_uv && p.name == "u") tu.push_back(f);
                        else if (have_uv && p.name == "v") tv.push_back(f);
                        else if (!have_uv && p.name == "s")
                            tu.push_back(f);
                        else if (!have_uv && p.name == "t")
                            tv.push_back(f);
                    } else if (is_face && (int)pi == face_prop) {
                        face_vals.push_back((int32_t)v);
                    }
                }
            }
            if (is_face && face_prop >= 0)
                polys.push_back(std::move(face_vals));
        }
    }

    int64_t nv = (int64_t)px.size();
    if (nv == 0 || py.size() != (size_t)nv || pz.size() != (size_t)nv)
        return 4;
    bool full_n = have_n && nx.size() == (size_t)nv
                  && ny.size() == (size_t)nv && nz.size() == (size_t)nv;
    bool full_uv = (have_uv || have_st) && tu.size() == (size_t)nv
                   && tv.size() == (size_t)nv;

    // fan triangulation (matches the Python oracle)
    std::vector<int32_t> tris;
    for (const auto& poly : polys)
        for (size_t k = 1; k + 1 < poly.size(); ++k) {
            tris.push_back(poly[0]);
            tris.push_back(poly[k]);
            tris.push_back(poly[k + 1]);
        }
    int64_t nt = (int64_t)(tris.size() / 3);

    out->n_verts = nv;
    out->n_tris = nt;
    out->has_normals = full_n ? 1 : 0;
    out->has_uvs = full_uv ? 1 : 0;
    out->positions = (float*)malloc(sizeof(float) * 3 * nv);
    out->indices = (int32_t*)malloc(sizeof(int32_t) * 3 * (nt ? nt : 1));
    out->uvs = (float*)calloc((size_t)(2 * nv), sizeof(float));
    out->normals = (float*)calloc((size_t)(3 * nv), sizeof(float));
    if (!out->positions || !out->indices || !out->uvs || !out->normals)
        return 5;
    for (int64_t i = 0; i < nv; ++i) {
        out->positions[3 * i + 0] = px[i];
        out->positions[3 * i + 1] = py[i];
        out->positions[3 * i + 2] = pz[i];
        if (full_n) {
            out->normals[3 * i + 0] = nx[i];
            out->normals[3 * i + 1] = ny[i];
            out->normals[3 * i + 2] = nz[i];
        }
        if (full_uv) {
            out->uvs[2 * i + 0] = tu[i];
            out->uvs[2 * i + 1] = tv[i];
        }
    }
    memcpy(out->indices, tris.data(), sizeof(int32_t) * 3 * nt);
    return 0;
}

}  // extern "C"
