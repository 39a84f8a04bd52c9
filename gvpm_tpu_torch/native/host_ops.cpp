// Native host-side operations of gvpm_tpu_torch (a copy of the JAX
// package's gvpm_tpu/native/host_ops.cpp; the port imports nothing of
// that package).
//
// The reference keeps its performance-critical host paths in C++ — the
// SAH kd-tree builder (include/mitsuba/render/gkdtree.h,
// sahkdtree3.h:107) and mesh ingestion (src/shapes/obj.cpp). This module
// provides their equivalents as a small C library bound via ctypes
// (native/bind.py):
//
//   * gv_load_obj        — fast Wavefront OBJ parse (v/vn/f, fans,
//                          negative indices)
//   * gv_build_bvh       — binned-SAH BVH over triangles, emitted as
//                          flat arrays ready for a stackless device
//                          traversal (left-child-first layout)
//   * gv_morton_sort     — 3D Morton-code ordering of points (photon /
//                          primitive reordering for coherent gathers)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 host_ops.cpp -o libgvpmhost.so
// (bind.py builds it at first use under gvpm_tpu_torch/_build/).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------
// OBJ loader
// ---------------------------------------------------------------------

struct ObjMesh {
  float *verts;    // [V*3]
  float *normals;  // [V*3] averaged per-vertex (or null)
  int64_t *faces;  // [F*3]
  int64_t n_verts;
  int64_t n_faces;
  int has_normals;
};

static inline const char *skip_ws(const char *p, const char *end) {
  while (p < end && (*p == ' ' || *p == '\t')) p++;
  return p;
}

ObjMesh *gv_load_obj(const char *path) {
  FILE *f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (fread(buf.data(), 1, size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);
  buf[size] = '\n';

  std::vector<float> verts, norms;
  std::vector<int64_t> faces, fnorm;
  std::vector<int64_t> poly, polyn;
  const char *p = buf.data();
  const char *end = buf.data() + size;
  while (p < end) {
    const char *line_end = (const char *)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    p = skip_ws(p, line_end);
    if (p + 1 < line_end && p[0] == 'v' &&
        (p[1] == ' ' || p[1] == '\t')) {
      char *q = (char *)p + 1;
      for (int i = 0; i < 3; i++) verts.push_back(strtof(q, &q));
    } else if (p + 2 < line_end && p[0] == 'v' && p[1] == 'n') {
      char *q = (char *)p + 2;
      for (int i = 0; i < 3; i++) norms.push_back(strtof(q, &q));
    } else if (p + 1 < line_end && p[0] == 'f' &&
               (p[1] == ' ' || p[1] == '\t')) {
      poly.clear();
      polyn.clear();
      const char *q = p + 1;
      while (q < line_end) {
        q = skip_ws(q, line_end);
        if (q >= line_end) break;
        char *next;
        long vi = strtol(q, &next, 10);
        if (next == q) break;
        q = next;
        long ni = 0;
        bool has_n = false;
        if (q < line_end && *q == '/') {
          q++;  // texcoord slot
          strtol(q, &next, 10);
          q = next;
          if (q < line_end && *q == '/') {
            q++;
            ni = strtol(q, &next, 10);
            has_n = next != q;
            q = next;
          }
        }
        int64_t v = vi > 0 ? vi - 1 : (int64_t)(verts.size() / 3) + vi;
        poly.push_back(v);
        if (has_n)
          polyn.push_back(ni > 0 ? ni - 1
                                 : (int64_t)(norms.size() / 3) + ni);
      }
      bool use_n = polyn.size() == poly.size() && !poly.empty();
      for (size_t k = 1; k + 1 < poly.size(); k++) {
        faces.push_back(poly[0]);
        faces.push_back(poly[k]);
        faces.push_back(poly[k + 1]);
        if (use_n) {
          fnorm.push_back(polyn[0]);
          fnorm.push_back(polyn[k]);
          fnorm.push_back(polyn[k + 1]);
        }
      }
    }
    p = line_end + 1;
  }

  ObjMesh *m = (ObjMesh *)calloc(1, sizeof(ObjMesh));
  m->n_verts = verts.size() / 3;
  m->n_faces = faces.size() / 3;
  m->verts = (float *)malloc(verts.size() * sizeof(float));
  memcpy(m->verts, verts.data(), verts.size() * sizeof(float));
  m->faces = (int64_t *)malloc(faces.size() * sizeof(int64_t));
  memcpy(m->faces, faces.data(), faces.size() * sizeof(int64_t));
  m->has_normals = 0;
  if (!norms.empty() && fnorm.size() == faces.size()) {
    // average normals onto position indices
    std::vector<float> vn(m->n_verts * 3, 0.f);
    std::vector<float> cnt(m->n_verts, 0.f);
    for (size_t i = 0; i < faces.size(); i++) {
      int64_t v = faces[i], n = fnorm[i];
      for (int c = 0; c < 3; c++) vn[v * 3 + c] += norms[n * 3 + c];
      cnt[v] += 1.f;
    }
    for (int64_t v = 0; v < m->n_verts; v++) {
      float l = 0;
      for (int c = 0; c < 3; c++) l += vn[v * 3 + c] * vn[v * 3 + c];
      l = sqrtf(l);
      if (l > 1e-8f)
        for (int c = 0; c < 3; c++) vn[v * 3 + c] /= l;
    }
    m->normals = (float *)malloc(vn.size() * sizeof(float));
    memcpy(m->normals, vn.data(), vn.size() * sizeof(float));
    m->has_normals = 1;
  }
  return m;
}

void gv_free_obj(ObjMesh *m) {
  if (!m) return;
  free(m->verts);
  free(m->faces);
  if (m->normals) free(m->normals);
  free(m);
}

// ---------------------------------------------------------------------
// Binned-SAH BVH builder (flat arrays for device traversal)
// ---------------------------------------------------------------------

struct BuildPrim {
  float lo[3], hi[3], c[3];
  int32_t idx;
};

struct BvhNode {
  float lo[3], hi[3];
  int32_t left;   // child index, or -1 for leaf
  int32_t right;
  int32_t first;  // leaf: first prim in order[]
  int32_t count;  // leaf: prim count
};

struct Bvh {
  BvhNode *nodes;
  int32_t *order;  // primitive permutation
  int32_t n_nodes;
  int32_t n_prims;
};

static void bbox_union(float *lo, float *hi, const float *plo,
                       const float *phi) {
  for (int c = 0; c < 3; c++) {
    lo[c] = std::min(lo[c], plo[c]);
    hi[c] = std::max(hi[c], phi[c]);
  }
}

static int32_t build_node(std::vector<BvhNode> &nodes,
                          std::vector<BuildPrim> &prims, int first,
                          int count, int leaf_size) {
  int32_t id = (int32_t)nodes.size();
  nodes.push_back(BvhNode());
  BvhNode nd;
  nd.lo[0] = nd.lo[1] = nd.lo[2] = 1e30f;
  nd.hi[0] = nd.hi[1] = nd.hi[2] = -1e30f;
  float clo[3] = {1e30f, 1e30f, 1e30f}, chi[3] = {-1e30f, -1e30f, -1e30f};
  for (int i = first; i < first + count; i++) {
    bbox_union(nd.lo, nd.hi, prims[i].lo, prims[i].hi);
    for (int c = 0; c < 3; c++) {
      clo[c] = std::min(clo[c], prims[i].c[c]);
      chi[c] = std::max(chi[c], prims[i].c[c]);
    }
  }
  nd.left = nd.right = -1;
  nd.first = first;
  nd.count = count;
  if (count <= leaf_size) {
    nodes[id] = nd;
    return id;
  }
  // binned SAH along the widest centroid axis
  int axis = 0;
  float width = chi[0] - clo[0];
  for (int c = 1; c < 3; c++)
    if (chi[c] - clo[c] > width) {
      width = chi[c] - clo[c];
      axis = c;
    }
  if (width < 1e-12f) {
    nodes[id] = nd;
    return id;
  }
  const int NB = 16;
  struct Bin {
    float lo[3], hi[3];
    int n;
  } bins[NB];
  for (int b = 0; b < NB; b++) {
    bins[b].n = 0;
    for (int c = 0; c < 3; c++) {
      bins[b].lo[c] = 1e30f;
      bins[b].hi[c] = -1e30f;
    }
  }
  float scale = NB / width;
  for (int i = first; i < first + count; i++) {
    int b = std::min(NB - 1,
                     (int)((prims[i].c[axis] - clo[axis]) * scale));
    bins[b].n++;
    bbox_union(bins[b].lo, bins[b].hi, prims[i].lo, prims[i].hi);
  }
  auto area = [](const float *lo, const float *hi) {
    float d[3] = {std::max(hi[0] - lo[0], 0.f),
                  std::max(hi[1] - lo[1], 0.f),
                  std::max(hi[2] - lo[2], 0.f)};
    return 2.f * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]);
  };
  float best_cost = 1e30f;
  int best_split = -1;
  for (int s = 1; s < NB; s++) {
    float llo[3] = {1e30f, 1e30f, 1e30f}, lhi[3] = {-1e30f, -1e30f, -1e30f};
    float rlo[3] = {1e30f, 1e30f, 1e30f}, rhi[3] = {-1e30f, -1e30f, -1e30f};
    int ln = 0, rn = 0;
    for (int b = 0; b < s; b++) {
      if (bins[b].n) bbox_union(llo, lhi, bins[b].lo, bins[b].hi);
      ln += bins[b].n;
    }
    for (int b = s; b < NB; b++) {
      if (bins[b].n) bbox_union(rlo, rhi, bins[b].lo, bins[b].hi);
      rn += bins[b].n;
    }
    if (!ln || !rn) continue;
    float cost = area(llo, lhi) * ln + area(rlo, rhi) * rn;
    if (cost < best_cost) {
      best_cost = cost;
      best_split = s;
    }
  }
  if (best_split < 0) {
    nodes[id] = nd;
    return id;
  }
  float split_pos = clo[axis] + best_split / scale;
  BuildPrim *mid = std::partition(
      prims.data() + first, prims.data() + first + count,
      [&](const BuildPrim &p) { return p.c[axis] < split_pos; });
  int lcount = (int)(mid - (prims.data() + first));
  if (lcount == 0 || lcount == count) lcount = count / 2;
  nd.left = build_node(nodes, prims, first, lcount, leaf_size);
  nd.right = build_node(nodes, prims, first + lcount, count - lcount,
                        leaf_size);
  nd.first = -1;
  nd.count = 0;
  nodes[id] = nd;
  return id;
}

Bvh *gv_build_bvh(const float *tri_lo, const float *tri_hi, int32_t n,
                  int32_t leaf_size) {
  std::vector<BuildPrim> prims(n);
  for (int i = 0; i < n; i++) {
    for (int c = 0; c < 3; c++) {
      prims[i].lo[c] = tri_lo[i * 3 + c];
      prims[i].hi[c] = tri_hi[i * 3 + c];
      prims[i].c[c] = 0.5f * (tri_lo[i * 3 + c] + tri_hi[i * 3 + c]);
    }
    prims[i].idx = i;
  }
  std::vector<BvhNode> nodes;
  nodes.reserve(2 * n);
  if (n > 0) build_node(nodes, prims, 0, n, std::max(1, (int)leaf_size));
  Bvh *b = (Bvh *)calloc(1, sizeof(Bvh));
  b->n_nodes = (int32_t)nodes.size();
  b->n_prims = n;
  b->nodes = (BvhNode *)malloc(nodes.size() * sizeof(BvhNode));
  memcpy(b->nodes, nodes.data(), nodes.size() * sizeof(BvhNode));
  b->order = (int32_t *)malloc(n * sizeof(int32_t));
  for (int i = 0; i < n; i++) b->order[i] = prims[i].idx;
  return b;
}

void gv_free_bvh(Bvh *b) {
  if (!b) return;
  free(b->nodes);
  free(b->order);
  free(b);
}

// ---------------------------------------------------------------------
// Morton ordering (coherent photon / primitive layout)
// ---------------------------------------------------------------------

static inline uint64_t expand_bits(uint64_t v) {
  v &= 0x1FFFFF;
  v = (v | v << 32) & 0x1F00000000FFFFULL;
  v = (v | v << 16) & 0x1F0000FF0000FFULL;
  v = (v | v << 8) & 0x100F00F00F00F00FULL;
  v = (v | v << 4) & 0x10C30C30C30C30C3ULL;
  v = (v | v << 2) & 0x1249249249249249ULL;
  return v;
}

void gv_morton_sort(const float *pts, int32_t n, const float *lo,
                    const float *hi, int32_t *order_out) {
  std::vector<std::pair<uint64_t, int32_t>> keys(n);
  float inv[3];
  for (int c = 0; c < 3; c++) {
    float d = hi[c] - lo[c];
    inv[c] = d > 1e-20f ? (float)((1 << 21) - 1) / d : 0.f;
  }
  for (int i = 0; i < n; i++) {
    uint64_t code = 0;
    for (int c = 0; c < 3; c++) {
      float x = (pts[i * 3 + c] - lo[c]) * inv[c];
      uint64_t q = (uint64_t)std::max(
          0.f, std::min(x, (float)((1 << 21) - 1)));
      code |= expand_bits(q) << c;
    }
    keys[i] = {code, i};
  }
  std::sort(keys.begin(), keys.end());
  for (int i = 0; i < n; i++) order_out[i] = keys[i].second;
}

}  // extern "C"
