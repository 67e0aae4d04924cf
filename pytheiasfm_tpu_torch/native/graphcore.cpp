// Native host-runtime kernels of pytheiasfm_tpu_torch: the port's own copy
// of the JAX package's native/graphcore.cpp.
//
// The reference keeps its sequential host work (track building via
// union-find, 1DSfM's greedy MFAS ordering) in C++ (theia's track
// building, math/graph/connected_components.h:60,
// sfm/filter_view_pairs_from_relative_translation.cc:165 — the MFAS
// heuristic of Wilson & Snavely ECCV'14). These host-sequential pieces are
// C ABI functions loaded through ctypes (native/__init__.py); the numpy
// versions in math/graph.py and sfm/view_graph.py are the plain versions
// the tests hold them against.
//
// Build (native/__init__.py does it at first use):
//   g++ -O2 -shared -fPIC -std=c++17 graphcore.cpp -o libgraphcore-<hash>.so

#include <cstdint>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int64_t> parent;
  std::vector<int64_t> size;

  explicit UnionFind(int64_t n) : parent(n), size(n, 1) {
    for (int64_t i = 0; i < n; ++i) parent[i] = i;
  }

  int64_t find(int64_t x) {
    int64_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {  // path compression
      int64_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }

  void unite(int64_t a, int64_t b) {
    int64_t ra = find(a), rb = find(b);
    if (ra == rb) return;
    if (size[ra] < size[rb]) std::swap(ra, rb);
    parent[rb] = ra;
    size[ra] += size[rb];
  }
};

}  // namespace

extern "C" {

// Connected components over an edge list: root_out[i] = representative of
// node i's component. Mirrors theia::ConnectedComponents
// (math/graph/connected_components.h:60).
void uf_components(int64_t num_nodes, int64_t num_edges, const int64_t* ea,
                   const int64_t* eb, int64_t* root_out) {
  UnionFind uf(num_nodes);
  for (int64_t e = 0; e < num_edges; ++e) uf.unite(ea[e], eb[e]);
  for (int64_t i = 0; i < num_nodes; ++i) root_out[i] = uf.find(i);
}

// Greedy minimum-feedback-arc-set ordering (Wilson & Snavely ECCV'14), the
// per-axis inner loop of FilterViewPairsFromRelativeTranslation
// (filter_view_pairs_from_relative_translation.cc:165): repeatedly emit the
// node with no remaining incoming weight, else the node maximizing
// (1 + out_weight) / (1 + in_weight). Nodes are scanned in ascending id
// order (ties -> smallest id), matching the Python fallback exactly.
void mfas_ordering(int64_t num_nodes, int64_t num_edges, const int64_t* src,
                   const int64_t* dst, const double* weights,
                   int64_t* order_out) {
  std::vector<double> win(num_nodes, 0.0), wout(num_nodes, 0.0);
  std::vector<double> w(num_edges);
  for (int64_t e = 0; e < num_edges; ++e) {
    w[e] = weights[e] > 0.0 ? weights[e] : 0.0;
    wout[src[e]] += w[e];
    win[dst[e]] += w[e];
  }
  // CSR-ish adjacency (out and in).
  std::vector<int64_t> out_deg(num_nodes, 0), in_deg(num_nodes, 0);
  for (int64_t e = 0; e < num_edges; ++e) {
    ++out_deg[src[e]];
    ++in_deg[dst[e]];
  }
  std::vector<int64_t> out_off(num_nodes + 1, 0), in_off(num_nodes + 1, 0);
  for (int64_t i = 0; i < num_nodes; ++i) {
    out_off[i + 1] = out_off[i] + out_deg[i];
    in_off[i + 1] = in_off[i] + in_deg[i];
  }
  std::vector<int64_t> out_to(num_edges), in_from(num_edges);
  std::vector<double> out_w(num_edges), in_w(num_edges);
  {
    std::vector<int64_t> oc = out_off, ic = in_off;
    for (int64_t e = 0; e < num_edges; ++e) {
      out_to[oc[src[e]]] = dst[e];
      out_w[oc[src[e]]++] = w[e];
      in_from[ic[dst[e]]] = src[e];
      in_w[ic[dst[e]]++] = w[e];
    }
  }

  std::vector<char> remaining(num_nodes, 1);
  for (int64_t rank = 0; rank < num_nodes; ++rank) {
    int64_t best = -1;
    double best_score = -1.0;
    for (int64_t n = 0; n < num_nodes; ++n) {
      if (!remaining[n]) continue;
      if (win[n] <= 1e-12) {  // source: emit immediately
        best = n;
        break;
      }
      double score = (1.0 + wout[n]) / (1.0 + win[n]);
      if (score > best_score) {
        best = n;
        best_score = score;
      }
    }
    remaining[best] = 0;
    order_out[best] = rank;
    for (int64_t k = out_off[best]; k < out_off[best + 1]; ++k) {
      if (remaining[out_to[k]]) win[out_to[k]] -= out_w[k];
    }
    for (int64_t k = in_off[best]; k < in_off[best + 1]; ++k) {
      if (remaining[in_from[k]]) wout[in_from[k]] -= in_w[k];
    }
  }
}

}  // extern "C"
