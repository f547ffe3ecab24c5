// Union-find over feature-match edges, for track building
// (orthosfm_torch/pipeline/tracks_build.py).
//
// The same rule as the JAX package's DSU (orthosfm_tpu/native/trackgraph.cpp,
// orthosfm_tpu/pipeline/tracks_build.py): edges are united in order, the root
// of the first endpoint's set becomes the root of the union, and find halves
// paths. The roots, and with them the order of the tracks, are the JAX run's.
//
// Host code with a plain C interface, built by orthosfm_torch.kernel_build
// with the system C++ compiler and bound with ctypes.

#include <cstdint>
#include <vector>

extern "C" {

// Union the m edges (ea[i], eb[i]) over n nodes; write every node's root to
// out_root (length n). Returns 0.
int osfm_union_find(const int64_t* ea, const int64_t* eb, int64_t m, int64_t n,
                    int64_t* out_root) {
  std::vector<int64_t> parent(n);
  for (int64_t i = 0; i < n; ++i) parent[i] = i;
  auto find = [&parent](int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  };
  for (int64_t i = 0; i < m; ++i) {
    const int64_t ra = find(ea[i]), rb = find(eb[i]);
    if (ra != rb) parent[rb] = ra;
  }
  for (int64_t i = 0; i < n; ++i) out_root[i] = find(i);
  return 0;
}

}  // extern "C"
