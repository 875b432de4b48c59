// Native runtime components for cmvs_pmvs_tpu.
//
// The reference is 100% C++ (SURVEY.md): its I/O, union-find and kNN live
// in native code. This build keeps the compute path in JAX/XLA
// and provides native equivalents for the host-side runtime pieces that
// dominate outside the device: bulk text serialization of patch clouds
// (reference source/pmvs/patchOrganizerS.cpp:687-819 writePLY/writePatches),
// union-find for SfM point merging (replacing the fork's broken
// CDisjointSet, include/cmvs/disjoint.hpp), and a Morton/z-order
// fixed-radius neighbor search (the STANN sfcnn counterpart,
// include/stann/sfcnn.hpp).
//
// Exposed as a minimal CPython extension (no pybind11 in this image);
// Python callers fall back to pure-Python implementations when the
// extension is not built.
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// buffer helpers (contiguous well-typed views without the numpy C API)
// ---------------------------------------------------------------------
struct BufView {
  Py_buffer view{};
  bool ok = false;
  ~BufView() {
    if (ok) PyBuffer_Release(&view);
  }
  bool acquire(PyObject* obj, const char* expect_format, int ndim) {
    if (PyObject_GetBuffer(obj, &view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) <
        0) {
      return false;
    }
    ok = true;
    if (view.ndim != ndim ||
        std::strcmp(view.format ? view.format : "", expect_format) != 0) {
      PyErr_Format(PyExc_TypeError,
                   "expected %d-d contiguous '%s' array, got %d-d '%s'",
                   ndim, expect_format, view.ndim,
                   view.format ? view.format : "?");
      return false;
    }
    return true;
  }
  Py_ssize_t dim(int i) const { return view.shape[i]; }
  template <typename T>
  const T* data() const {
    return static_cast<const T*>(view.buf);
  }
};

// ---------------------------------------------------------------------
// write_ply(path, coords f64[N,3], normals f64[N,3], colors u8[N,3],
//           quality f64[N])
// ---------------------------------------------------------------------
PyObject* write_ply(PyObject*, PyObject* args) {
  const char* path;
  PyObject *coords_o, *normals_o, *colors_o, *quality_o;
  if (!PyArg_ParseTuple(args, "sOOOO", &path, &coords_o, &normals_o,
                        &colors_o, &quality_o)) {
    return nullptr;
  }
  BufView coords, normals, colors, quality;
  if (!coords.acquire(coords_o, "d", 2) ||
      !normals.acquire(normals_o, "d", 2) ||
      !colors.acquire(colors_o, "B", 2) ||
      !quality.acquire(quality_o, "d", 1)) {
    return nullptr;
  }
  const Py_ssize_t n = coords.dim(0);
  FILE* f = std::fopen(path, "w");
  if (!f) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return nullptr;
  }
  std::fprintf(f,
               "ply\nformat ascii 1.0\nelement vertex %lld\n"
               "property float x\nproperty float y\nproperty float z\n"
               "property float nx\nproperty float ny\nproperty float nz\n"
               "property uchar diffuse_red\nproperty uchar diffuse_green\n"
               "property uchar diffuse_blue\nproperty float quality\n"
               "end_header\n",
               static_cast<long long>(n));
  const double* c = coords.data<double>();
  const double* nn = normals.data<double>();
  const uint8_t* col = colors.data<uint8_t>();
  const double* q = quality.data<double>();
  std::string buf;
  buf.reserve(1 << 20);
  char line[256];
  for (Py_ssize_t i = 0; i < n; ++i) {
    int len = std::snprintf(line, sizeof line,
                            "%.9g %.9g %.9g %.9g %.9g %.9g %u %u %u %.9g\n",
                            c[3 * i], c[3 * i + 1], c[3 * i + 2],
                            nn[3 * i], nn[3 * i + 1], nn[3 * i + 2],
                            col[3 * i], col[3 * i + 1], col[3 * i + 2],
                            q[i]);
    buf.append(line, len);
    if (buf.size() > (1 << 20) - 300) {
      std::fwrite(buf.data(), 1, buf.size(), f);
      buf.clear();
    }
  }
  std::fwrite(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  Py_RETURN_NONE;
}

// ---------------------------------------------------------------------
// write_pset(path, coords f64[N,3], normals f64[N,3])
// ---------------------------------------------------------------------
PyObject* write_pset(PyObject*, PyObject* args) {
  const char* path;
  PyObject *coords_o, *normals_o;
  if (!PyArg_ParseTuple(args, "sOO", &path, &coords_o, &normals_o)) {
    return nullptr;
  }
  BufView coords, normals;
  if (!coords.acquire(coords_o, "d", 2) ||
      !normals.acquire(normals_o, "d", 2)) {
    return nullptr;
  }
  const Py_ssize_t n = coords.dim(0);
  FILE* f = std::fopen(path, "w");
  if (!f) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return nullptr;
  }
  const double* c = coords.data<double>();
  const double* nn = normals.data<double>();
  std::string buf;
  buf.reserve(1 << 20);
  char line[256];
  for (Py_ssize_t i = 0; i < n; ++i) {
    int len = std::snprintf(line, sizeof line, "%.9g %.9g %.9g %.9g %.9g %.9g\n",
                            c[3 * i], c[3 * i + 1], c[3 * i + 2], nn[3 * i],
                            nn[3 * i + 1], nn[3 * i + 2]);
    buf.append(line, len);
    if (buf.size() > (1 << 20) - 300) {
      std::fwrite(buf.data(), 1, buf.size(), f);
      buf.clear();
    }
  }
  std::fwrite(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  Py_RETURN_NONE;
}

// ---------------------------------------------------------------------
// union-find
// ---------------------------------------------------------------------
struct UF {
  std::vector<int64_t> parent;
  explicit UF(int64_t n) : parent(n) {
    std::iota(parent.begin(), parent.end(), 0);
  }
  int64_t find(int64_t x) {
    int64_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int64_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }
  void unite(int64_t a, int64_t b) {
    int64_t ra = find(a), rb = find(b);
    if (ra != rb) parent[std::max(ra, rb)] = std::min(ra, rb);
  }
};

// union_find(n, edges i64[M,2]) -> labels list (min-root per element)
PyObject* union_find(PyObject*, PyObject* args) {
  Py_ssize_t n;
  PyObject* edges_o;
  if (!PyArg_ParseTuple(args, "nO", &n, &edges_o)) return nullptr;
  BufView edges;
  if (!edges.acquire(edges_o, "l", 2) &&
      !(PyErr_Clear(), edges.acquire(edges_o, "q", 2))) {
    return nullptr;
  }
  const Py_ssize_t m = edges.dim(0);
  const int64_t* e = edges.data<int64_t>();
  UF uf(n);
  for (Py_ssize_t i = 0; i < m; ++i) {
    int64_t a = e[2 * i], b = e[2 * i + 1];
    if (a < 0 || b < 0 || a >= n || b >= n) {
      PyErr_SetString(PyExc_ValueError, "edge index out of range");
      return nullptr;
    }
    uf.unite(a, b);
  }
  PyObject* out = PyList_New(n);
  if (!out) return nullptr;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyList_SET_ITEM(out, i, PyLong_FromLongLong(uf.find(i)));
  }
  return out;
}

// ---------------------------------------------------------------------
// Fixed-radius neighbor pairs (STANN sfcnn counterpart,
// include/stann/sfcnn.hpp:243-301). radius_pairs(points f32[N,3],
// radii f32[N]) -> flat i64 list of (i, j) pairs with
// |pi - pj| <= max(ri, rj). EXACT: points are bucketed on a uniform
// grid with cell size max(radii) (keyed by the Morton code of the cell
// coordinates) and each point scans its 3x3x3 cell neighborhood - any
// qualifying pair is at most one cell apart by construction, unlike a
// bounded scan along the space-filling curve which can miss spatially
// adjacent points that are far apart in curve order.
// ---------------------------------------------------------------------
uint64_t morton3(uint32_t x, uint32_t y, uint32_t z) {
  auto split = [](uint64_t v) {
    v &= 0x1fffff;
    v = (v | v << 32) & 0x1f00000000ffffULL;
    v = (v | v << 16) & 0x1f0000ff0000ffULL;
    v = (v | v << 8) & 0x100f00f00f00f00fULL;
    v = (v | v << 4) & 0x10c30c30c30c30c3ULL;
    v = (v | v << 2) & 0x1249249249249249ULL;
    return v;
  };
  return split(x) | (split(y) << 1) | (split(z) << 2);
}

PyObject* radius_pairs(PyObject*, PyObject* args) {
  PyObject *pts_o, *rad_o;
  int window = 64;
  if (!PyArg_ParseTuple(args, "OO|i", &pts_o, &rad_o, &window)) {
    return nullptr;
  }
  BufView pts, rad;
  if (!pts.acquire(pts_o, "f", 2) || !rad.acquire(rad_o, "f", 1)) {
    return nullptr;
  }
  const Py_ssize_t n = pts.dim(0);
  const float* p = pts.data<float>();
  const float* r = rad.data<float>();

  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (Py_ssize_t i = 0; i < n; ++i) {
    for (int d = 0; d < 3; ++d) {
      lo[d] = std::min(lo[d], p[3 * i + d]);
      hi[d] = std::max(hi[d], p[3 * i + d]);
    }
  }
  (void)window;  // legacy arg of the curve-scan variant
  float rmax = 0.0f;
  for (Py_ssize_t i = 0; i < n; ++i) rmax = std::max(rmax, r[i]);
  const float h = std::max(rmax, 1e-12f);

  // bucket points by grid cell (Morton code of the cell coordinates)
  std::vector<std::pair<uint64_t, int64_t>> keys(n);
  auto cell_of = [&](const float* q, int dx, int dy, int dz) {
    const uint32_t cx = uint32_t(std::max(0.0f, (q[0] - lo[0]) / h)) + 1;
    const uint32_t cy = uint32_t(std::max(0.0f, (q[1] - lo[1]) / h)) + 1;
    const uint32_t cz = uint32_t(std::max(0.0f, (q[2] - lo[2]) / h)) + 1;
    return morton3(cx + dx, cy + dy, cz + dz);
  };
  for (Py_ssize_t i = 0; i < n; ++i) {
    keys[i] = {cell_of(p + 3 * i, 0, 0, 0), i};
  }
  std::sort(keys.begin(), keys.end());
  std::vector<uint64_t> cell_keys(n);
  for (Py_ssize_t i = 0; i < n; ++i) cell_keys[i] = keys[i].first;

  std::vector<int64_t> pairs;
  for (Py_ssize_t a = 0; a < n; ++a) {
    const int64_t i = keys[a].second;
    const float* pi = p + 3 * i;
    for (int dz = -1; dz <= 1; ++dz) {
      for (int dy = -1; dy <= 1; ++dy) {
        for (int dx = -1; dx <= 1; ++dx) {
          const uint64_t key = cell_of(pi, dx, dy, dz);
          auto it = std::lower_bound(cell_keys.begin(), cell_keys.end(),
                                     key);
          for (Py_ssize_t b = it - cell_keys.begin();
               b < n && cell_keys[b] == key; ++b) {
            const int64_t j = keys[b].second;
            if (j <= i) continue;   // emit each pair once
            const float* pj = p + 3 * j;
            const float ddx = pi[0] - pj[0];
            const float ddy = pi[1] - pj[1];
            const float ddz = pi[2] - pj[2];
            const float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
            const float rr = std::max(r[i], r[j]);
            if (d2 <= rr * rr) {
              pairs.push_back(i);
              pairs.push_back(j);
            }
          }
        }
      }
    }
  }

  PyObject* out = PyList_New(pairs.size());
  if (!out) return nullptr;
  for (size_t i = 0; i < pairs.size(); ++i) {
    PyList_SET_ITEM(out, i, PyLong_FromLongLong(pairs[i]));
  }
  return out;
}

PyMethodDef methods[] = {
    {"write_ply", write_ply, METH_VARARGS,
     "write_ply(path, coords, normals, colors, quality)"},
    {"write_pset", write_pset, METH_VARARGS,
     "write_pset(path, coords, normals)"},
    {"union_find", union_find, METH_VARARGS,
     "union_find(n, edges) -> labels"},
    {"radius_pairs", radius_pairs, METH_VARARGS,
     "radius_pairs(points, radii, window=64) -> flat pair list"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "_native",
                      "native runtime components", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__native(void) { return PyModule_Create(&module); }
