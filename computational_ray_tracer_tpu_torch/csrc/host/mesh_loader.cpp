// Native OBJ mesh loader: host code, one-shot scene set-up.
//
// A copy of the JAX package's computational_ray_tracer_tpu/native/
// mesh_loader.cpp (the port imports nothing of that package). A single-pass
// tokenizer over a whole-file buffer, with the semantics of the Python
// parser in utils/obj_loader.py:
//   - faces are fan-triangulated,
//   - corners are deduplicated on unique (v, vt, vn) index triples in
//     first-seen order,
//   - missing vt/vn indices are 0, negative indices resolve against the
//     total attribute counts,
//   - has_normals is set only if every corner carried a vn index.
// Numbers are parsed with strtof (one rounding to float32); the Python
// parser rounds to float64, then to float32. tests/test_torch_assets.py
// asserts array equality against the Python parser.
//
// Build: kernels/build.load_host_library() runs
//   g++ -O3 -std=c++17 -shared -fPIC -o build/libcrt_host.so csrc/host/*.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Key {
    int32_t v, vt, vn;
    bool operator==(const Key& o) const {
        return v == o.v && vt == o.vt && vn == o.vn;
    }
};

struct KeyHash {
    size_t operator()(const Key& k) const {
        uint64_t h = 1469598103934665603ull;
        for (uint64_t x : {(uint64_t)(uint32_t)k.v, (uint64_t)(uint32_t)k.vt,
                           (uint64_t)(uint32_t)k.vn}) {
            h ^= x;
            h *= 1099511628211ull;
        }
        return (size_t)h;
    }
};

inline void skip_ws(const char*& p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
}

inline void skip_line(const char*& p, const char* end) {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
}

inline float read_float(const char*& p) {
    char* q;
    float v = strtof(p, &q);
    p = q;
    return v;
}

inline bool at_number(const char* p) {
    return *p == '-' || *p == '+' || (*p >= '0' && *p <= '9');
}

// strtol skips leading whitespace, which would let an EMPTY index slot
// (e.g. "1//" followed by a space) steal the next token's number — so face
// index slots must check at_number() before calling this.
inline long read_int(const char*& p) {
    char* q;
    long v = strtol(p, &q, 10);
    p = q;
    return v;
}

}  // namespace

extern "C" {

struct CrtMesh {
    int64_t n_verts;
    int64_t n_tris;
    int32_t has_normals;
    int32_t has_uvs;    // any texcoord data present (PLY loader semantic;
                        // the OBJ loader always fills uvs, zeros if absent)
    float* positions;   // (n_verts, 3)
    int32_t* indices;   // (n_tris, 3)
    float* uvs;         // (n_verts, 2)
    float* normals;     // (n_verts, 3) — valid only if has_normals
};

int crt_load_obj(const char* path, CrtMesh* out) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::string buf(size + 1, '\0');
    if (size > 0 && fread(&buf[0], 1, size, f) != (size_t)size) {
        fclose(f);
        return 2;
    }
    fclose(f);
    buf[size] = '\n';
    const char* p = buf.data();
    const char* end = p + size + 1;

    std::vector<float> vs, vts, vns;       // raw attribute pools
    std::vector<Key> corners;              // triangulated corner stream
    std::vector<Key> face;                 // scratch per face

    while (p < end) {
        skip_ws(p, end);
        if (p >= end) break;
        if (p[0] == 'v' && p[1] == ' ') {
            p += 2;
            for (int i = 0; i < 3; ++i) vs.push_back(read_float(p));
            skip_line(p, end);
        } else if (p[0] == 'v' && p[1] == 't' && p[2] == ' ') {
            p += 3;
            vts.push_back(read_float(p));
            skip_ws(p, end);
            vts.push_back((*p != '\n') ? read_float(p) : 0.0f);
            skip_line(p, end);
        } else if (p[0] == 'v' && p[1] == 'n' && p[2] == ' ') {
            p += 3;
            for (int i = 0; i < 3; ++i) vns.push_back(read_float(p));
            skip_line(p, end);
        } else if (p[0] == 'f' && p[1] == ' ') {
            p += 2;
            face.clear();
            for (;;) {
                skip_ws(p, end);
                if (p >= end || *p == '\n' || *p == '#') break;
                Key k{0, 0, 0};
                k.v = (int32_t)read_int(p);
                if (*p == '/') {
                    ++p;
                    if (at_number(p)) k.vt = (int32_t)read_int(p);
                    if (*p == '/') {
                        ++p;
                        if (at_number(p)) k.vn = (int32_t)read_int(p);
                    }
                }
                face.push_back(k);
            }
            for (size_t k = 1; k + 1 < face.size(); ++k) {  // fan
                corners.push_back(face[0]);
                corners.push_back(face[k]);
                corners.push_back(face[k + 1]);
            }
            skip_line(p, end);
        } else {
            skip_line(p, end);
        }
    }

    const int64_t nv_pool = (int64_t)vs.size() / 3;
    const int64_t nvt_pool = (int64_t)vts.size() / 2;
    const int64_t nvn_pool = (int64_t)vns.size() / 3;
    auto resolve = [](long idx, int64_t n) -> int64_t {
        return idx > 0 ? idx - 1 : n + idx;
    };

    std::unordered_map<Key, int32_t, KeyHash> remap;
    remap.reserve(corners.size());
    std::vector<float> pos, uv, nrm;
    std::vector<int32_t> idx;
    idx.reserve(corners.size());
    bool has_normals = !corners.empty();

    for (const Key& c : corners) {
        auto it = remap.find(c);
        int32_t newid;
        if (it == remap.end()) {
            newid = (int32_t)(pos.size() / 3);
            remap.emplace(c, newid);
            int64_t vi = resolve(c.v, nv_pool);
            if (vi < 0 || vi >= nv_pool) return 3;
            pos.insert(pos.end(), {vs[vi * 3], vs[vi * 3 + 1], vs[vi * 3 + 2]});
            if (c.vt) {
                int64_t ti = resolve(c.vt, nvt_pool);
                if (ti < 0 || ti >= nvt_pool) return 3;
                uv.insert(uv.end(), {vts[ti * 2], vts[ti * 2 + 1]});
            } else {
                uv.insert(uv.end(), {0.0f, 0.0f});
            }
            if (c.vn) {
                int64_t ni = resolve(c.vn, nvn_pool);
                if (ni < 0 || ni >= nvn_pool) return 3;
                nrm.insert(nrm.end(),
                           {vns[ni * 3], vns[ni * 3 + 1], vns[ni * 3 + 2]});
            } else {
                nrm.insert(nrm.end(), {0.0f, 0.0f, 0.0f});
            }
        } else {
            newid = it->second;
        }
        if (!c.vn) has_normals = false;
        idx.push_back(newid);
    }

    out->n_verts = (int64_t)pos.size() / 3;
    out->n_tris = (int64_t)idx.size() / 3;
    out->has_normals = has_normals ? 1 : 0;
    out->has_uvs = 1;
    out->positions = (float*)malloc(pos.size() * sizeof(float));
    out->indices = (int32_t*)malloc(idx.size() * sizeof(int32_t));
    out->uvs = (float*)malloc(uv.size() * sizeof(float));
    out->normals = (float*)malloc(nrm.size() * sizeof(float));
    memcpy(out->positions, pos.data(), pos.size() * sizeof(float));
    memcpy(out->indices, idx.data(), idx.size() * sizeof(int32_t));
    memcpy(out->uvs, uv.data(), uv.size() * sizeof(float));
    memcpy(out->normals, nrm.data(), nrm.size() * sizeof(float));
    return 0;
}

void crt_free_mesh(CrtMesh* m) {
    free(m->positions);
    free(m->indices);
    free(m->uvs);
    free(m->normals);
    m->positions = nullptr;
    m->indices = nullptr;
    m->uvs = nullptr;
    m->normals = nullptr;
}

}  // extern "C"
