// Iso-surface extraction (marching tetrahedra) with vertex welding, over a
// C ABI loaded with ctypes (a copy of seal3d_tpu/runtime/native/
// mesh_extract.cpp: the same code, so both packages give the same mesh).
// Marching tetrahedra splits each grid cell into 6 tets and emits 1-2
// triangles per crossing tet; it is topologically unambiguous (unlike
// table-based marching cubes) and needs no case tables.
//
// Built at first use by seal3d_tpu_torch/runtime/build.py:
//   g++ -O3 -shared -fPIC -std=c++17 mesh_extract.cpp -o <lib>.so

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

// The standard 6-tetrahedra decomposition of a unit cube around the 0-7
// diagonal. Corner i is at ((i>>0)&1, (i>>1)&1, (i>>2)&1).
const int kTets6[6][4] = {
    {0, 1, 3, 7}, {0, 1, 5, 7}, {0, 2, 3, 7},
    {0, 2, 6, 7}, {0, 4, 5, 7}, {0, 4, 6, 7},
};

inline V3 lerp_edge(const V3& a, const V3& b, float va, float vb, float iso) {
  float t = (iso - va) / (vb - va + 1e-12f);
  if (t < 0.f) t = 0.f;
  if (t > 1.f) t = 1.f;
  return {a.x + t * (b.x - a.x), a.y + t * (b.y - a.y), a.z + t * (b.z - a.z)};
}

struct Key {
  int64_t a, b;  // welded edge key: sorted linear corner ids
  bool operator==(const Key& o) const { return a == o.a && b == o.b; }
};
struct KeyHash {
  size_t operator()(const Key& k) const {
    return std::hash<int64_t>()(k.a * 1000003 ^ k.b);
  }
};

struct MeshAcc {
  std::vector<float> verts;
  std::vector<int32_t> tris;
  std::unordered_map<Key, int32_t, KeyHash> edge_cache;

  int32_t vertex_on_edge(int64_t ia, int64_t ib, const V3& pa, const V3& pb,
                         float va, float vb, float iso) {
    Key k = ia < ib ? Key{ia, ib} : Key{ib, ia};
    auto it = edge_cache.find(k);
    if (it != edge_cache.end()) return it->second;
    V3 p = lerp_edge(pa, pb, va, vb, iso);
    int32_t id = static_cast<int32_t>(verts.size() / 3);
    verts.push_back(p.x);
    verts.push_back(p.y);
    verts.push_back(p.z);
    edge_cache.emplace(k, id);
    return id;
  }
};

void do_tet(MeshAcc& acc, const int64_t gid[4], const V3 pos[4],
            const float val[4], float iso) {
  int code = 0;
  for (int i = 0; i < 4; ++i)
    if (val[i] > iso) code |= 1 << i;
  if (code == 0 || code == 15) return;

  auto emit = [&](int a0, int a1, int b0, int b1, int c0, int c1) {
    int32_t v0 = acc.vertex_on_edge(gid[a0], gid[a1], pos[a0], pos[a1],
                                    val[a0], val[a1], iso);
    int32_t v1 = acc.vertex_on_edge(gid[b0], gid[b1], pos[b0], pos[b1],
                                    val[b0], val[b1], iso);
    int32_t v2 = acc.vertex_on_edge(gid[c0], gid[c1], pos[c0], pos[c1],
                                    val[c0], val[c1], iso);
    if (v0 != v1 && v1 != v2 && v0 != v2) {
      acc.tris.push_back(v0);
      acc.tris.push_back(v1);
      acc.tris.push_back(v2);
    }
  };

  switch (code) {
    case 1:  emit(0,1, 0,2, 0,3); break;
    case 14: emit(0,1, 0,3, 0,2); break;
    case 2:  emit(1,0, 1,3, 1,2); break;
    case 13: emit(1,0, 1,2, 1,3); break;
    case 4:  emit(2,0, 2,1, 2,3); break;
    case 11: emit(2,0, 2,3, 2,1); break;
    case 8:  emit(3,0, 3,2, 3,1); break;
    case 7:  emit(3,0, 3,1, 3,2); break;
    case 3:  // 0,1 inside
      emit(0,2, 1,2, 1,3);
      emit(0,2, 1,3, 0,3);
      break;
    case 12:
      emit(0,2, 1,3, 1,2);
      emit(0,2, 0,3, 1,3);
      break;
    case 5:  // 0,2 inside
      emit(0,1, 0,3, 2,3);
      emit(0,1, 2,3, 2,1);
      break;
    case 10:
      emit(0,1, 2,3, 0,3);
      emit(0,1, 2,1, 2,3);
      break;
    case 6:  // 1,2 inside
      emit(1,0, 2,0, 2,3);
      emit(1,0, 2,3, 1,3);
      break;
    case 9:
      emit(1,0, 2,3, 2,0);
      emit(1,0, 1,3, 2,3);
      break;
  }
}

}  // namespace

extern "C" {

// grid: [nx*ny*nz] row-major (x fastest). Writes up to max_* outputs.
// Returns 0 on success, 1 if outputs were truncated.
int marching_tetrahedra(const float* grid, int nx, int ny, int nz, float iso,
                        const float* origin, const float* spacing,
                        float* out_verts, int64_t max_verts,
                        int32_t* out_tris, int64_t max_tris,
                        int64_t* n_verts, int64_t* n_tris) {
  MeshAcc acc;
  acc.verts.reserve(1 << 16);
  acc.tris.reserve(1 << 16);

  auto gval = [&](int x, int y, int z) -> float {
    return grid[(static_cast<int64_t>(z) * ny + y) * nx + x];
  };
  auto gidx = [&](int x, int y, int z) -> int64_t {
    return (static_cast<int64_t>(z) * ny + y) * nx + x;
  };

  for (int z = 0; z + 1 < nz; ++z) {
    for (int y = 0; y + 1 < ny; ++y) {
      for (int x = 0; x + 1 < nx; ++x) {
        float cv[8];
        V3 cp[8];
        int64_t cg[8];
        bool any_in = false, any_out = false;
        for (int c = 0; c < 8; ++c) {
          int dx = c & 1, dy = (c >> 1) & 1, dz = (c >> 2) & 1;
          cv[c] = gval(x + dx, y + dy, z + dz);
          cp[c] = {origin[0] + (x + dx) * spacing[0],
                   origin[1] + (y + dy) * spacing[1],
                   origin[2] + (z + dz) * spacing[2]};
          cg[c] = gidx(x + dx, y + dy, z + dz);
          (cv[c] > iso ? any_in : any_out) = true;
        }
        if (!any_in || !any_out) continue;
        for (int t = 0; t < 6; ++t) {
          int64_t gid[4];
          V3 pos[4];
          float val[4];
          for (int i = 0; i < 4; ++i) {
            int c = kTets6[t][i];
            gid[i] = cg[c];
            pos[i] = cp[c];
            val[i] = cv[c];
          }
          do_tet(acc, gid, pos, val, iso);
        }
      }
    }
  }

  int truncated = 0;
  int64_t nv = static_cast<int64_t>(acc.verts.size() / 3);
  int64_t nt = static_cast<int64_t>(acc.tris.size() / 3);
  if (nv > max_verts) { nv = max_verts; truncated = 1; }
  if (nt > max_tris) { nt = max_tris; truncated = 1; }
  std::memcpy(out_verts, acc.verts.data(), nv * 3 * sizeof(float));
  std::memcpy(out_tris, acc.tris.data(), nt * 3 * sizeof(int32_t));
  *n_verts = nv;
  *n_tris = nt;
  return truncated;
}

}  // extern "C"
