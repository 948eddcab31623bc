// Native mesh preprocessing: vertex-clustering decimation.
//
// A copy of megapose6d_tpu/native/meshproc.cc for the PyTorch package. It
// bounds the face budget of the tiled renderer with the semantics of
// meshes/io.py simplify_vertex_clustering (binary search on the clustering
// cell size until the face count fits), the whole search in one C call,
// and numbers the clustered vertices and faces as the JAX package's build
// does. C ABI only, bound with ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct ClusterResult {
  std::vector<float> verts;    // [nv*3] cluster means
  std::vector<float> colors;   // [nv*3] (only if colors given)
  std::vector<int> faces;      // [nf*3] non-degenerate remapped faces
  int nv = 0;
  int nf = 0;
};

// One clustering pass at cell size `cell` (absolute units).
void cluster_once(const float* verts, int n_v, const int* faces, int n_f,
                  const float* colors, const float* lo, float cell,
                  ClusterResult* out) {
  out->verts.clear();
  out->colors.clear();
  out->faces.clear();
  const double inv = 1.0 / (cell > 1e-12f ? cell : 1e-12f);

  std::unordered_map<uint64_t, int> cells;
  cells.reserve(static_cast<size_t>(n_v) * 2);
  std::vector<int> remap(n_v);
  std::vector<double> acc;   // [nc*3] position sums
  std::vector<double> cacc;  // [nc*3] color sums
  std::vector<int> cnt;

  for (int i = 0; i < n_v; ++i) {
    // Exact 3D key, 21 bits per axis (no hash-mixing collisions).
    uint64_t kx = static_cast<uint64_t>(
        static_cast<int64_t>((verts[3 * i + 0] - lo[0]) * inv) & 0x1FFFFF);
    uint64_t ky = static_cast<uint64_t>(
        static_cast<int64_t>((verts[3 * i + 1] - lo[1]) * inv) & 0x1FFFFF);
    uint64_t kz = static_cast<uint64_t>(
        static_cast<int64_t>((verts[3 * i + 2] - lo[2]) * inv) & 0x1FFFFF);
    uint64_t key = (kx << 42) | (ky << 21) | kz;
    auto it = cells.find(key);
    int id;
    if (it == cells.end()) {
      id = static_cast<int>(cells.size());
      cells.emplace(key, id);
      acc.resize((id + 1) * 3, 0.0);
      cnt.resize(id + 1, 0);
      if (colors) cacc.resize((id + 1) * 3, 0.0);
    } else {
      id = it->second;
    }
    remap[i] = id;
    for (int k = 0; k < 3; ++k) acc[3 * id + k] += verts[3 * i + k];
    if (colors)
      for (int k = 0; k < 3; ++k) cacc[3 * id + k] += colors[3 * i + k];
    cnt[id] += 1;
  }

  const int nc = static_cast<int>(cells.size());
  out->nv = nc;
  out->verts.resize(nc * 3);
  if (colors) out->colors.resize(nc * 3);
  for (int i = 0; i < nc; ++i) {
    const double inv_n = 1.0 / cnt[i];
    for (int k = 0; k < 3; ++k)
      out->verts[3 * i + k] = static_cast<float>(acc[3 * i + k] * inv_n);
    if (colors)
      for (int k = 0; k < 3; ++k)
        out->colors[3 * i + k] = static_cast<float>(cacc[3 * i + k] * inv_n);
  }

  out->faces.reserve(n_f * 3);
  int nf = 0;
  for (int f = 0; f < n_f; ++f) {
    const int a = remap[faces[3 * f + 0]];
    const int b = remap[faces[3 * f + 1]];
    const int c = remap[faces[3 * f + 2]];
    if (a != b && b != c && a != c) {
      out->faces.push_back(a);
      out->faces.push_back(b);
      out->faces.push_back(c);
      ++nf;
    }
  }
  out->nf = nf;
}

}  // namespace

extern "C" {

// Decimate to <= target_faces via binary search on the cell size
// (meshes/io.py:simplify_vertex_clustering semantics: 32 iterations,
// relative cell in [1e-5, 1] x bbox diagonal, keep the finest result
// that fits). Output buffers must hold n_v vertices / n_f faces (the
// result never grows). colors/out_colors may be NULL. Returns 0 on
// success, 1 on bad input. If n_f <= target_faces the input is copied
// through unchanged.
int mp_simplify_mesh(const float* verts, int n_v, const int* faces, int n_f,
                     const float* colors, int target_faces, int max_iters,
                     float* out_verts, int* out_faces, float* out_colors,
                     int* out_nv, int* out_nf) {
  if (!verts || !faces || !out_verts || !out_faces || !out_nv || !out_nf ||
      n_v <= 0 || n_f <= 0 || target_faces <= 0)
    return 1;
  if (n_f <= target_faces) {
    std::memcpy(out_verts, verts, sizeof(float) * 3 * n_v);
    std::memcpy(out_faces, faces, sizeof(int) * 3 * n_f);
    if (colors && out_colors)
      std::memcpy(out_colors, colors, sizeof(float) * 3 * n_v);
    *out_nv = n_v;
    *out_nf = n_f;
    return 0;
  }

  float lo3[3] = {verts[0], verts[1], verts[2]};
  float hi3[3] = {verts[0], verts[1], verts[2]};
  for (int i = 0; i < n_v; ++i)
    for (int k = 0; k < 3; ++k) {
      const float v = verts[3 * i + k];
      if (v < lo3[k]) lo3[k] = v;
      if (v > hi3[k]) hi3[k] = v;
    }
  double ext2 = 0.0;
  for (int k = 0; k < 3; ++k) {
    const double d = static_cast<double>(hi3[k]) - lo3[k];
    ext2 += d * d;
  }
  const double ext = ext2 > 0 ? std::sqrt(ext2) : 1.0;

  ClusterResult cur, best;
  bool have_best = false;
  double lo = 1e-5, hi = 1.0;
  if (max_iters <= 0) max_iters = 32;
  for (int it = 0; it < max_iters; ++it) {
    const double cell = 0.5 * (lo + hi);
    cluster_once(verts, n_v, faces, n_f, colors, lo3,
                 static_cast<float>(cell * ext), &cur);
    if (cur.nf > target_faces) {
      lo = cell;
    } else {
      best = cur;
      have_best = true;
      hi = cell;
    }
  }
  if (!have_best) {
    cluster_once(verts, n_v, faces, n_f, colors, lo3,
                 static_cast<float>(hi * ext), &best);
  }
  *out_nv = best.nv;
  *out_nf = best.nf;
  std::memcpy(out_verts, best.verts.data(), sizeof(float) * 3 * best.nv);
  std::memcpy(out_faces, best.faces.data(), sizeof(int) * 3 * best.nf);
  if (colors && out_colors && !best.colors.empty())
    std::memcpy(out_colors, best.colors.data(), sizeof(float) * 3 * best.nv);
  return 0;
}

}  // extern "C"
