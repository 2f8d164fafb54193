// graphcore: host-side graph kernels of the build pipeline (C ABI, ctypes).
//
// The port's copy of the JAX package's native/graphcore.cpp: per-pair
// shortest-path union labeling (CSR adjacency, queue BFS from every seed and
// every answer, and the on-path edge test
//     d_s(u) + 1 + d_a(v) == d(s, a)
// in both orientations in undirected mode) and multi-source BFS distances.
// Loaded by evi_rag_tpu_torch/data/native.py, which builds it with g++
// through evi_rag_tpu_torch/ops/_build.py; its results equal the numpy
// engine's in evi_rag_tpu_torch/data/bfs_label.py.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Csr {
  std::vector<int64_t> indptr;
  std::vector<int64_t> indices;
};

// Build CSR adjacency; invalid endpoints dropped; undirected duplicates both ways.
Csr build_csr(int64_t num_nodes, int64_t num_edges, const int64_t* src,
              const int64_t* dst, bool undirected, bool reverse) {
  Csr csr;
  csr.indptr.assign(num_nodes + 1, 0);
  auto valid = [&](int64_t e) {
    return src[e] >= 0 && dst[e] >= 0 && src[e] < num_nodes && dst[e] < num_nodes;
  };
  for (int64_t e = 0; e < num_edges; ++e) {
    if (!valid(e)) continue;
    int64_t u = reverse ? dst[e] : src[e];
    int64_t v = reverse ? src[e] : dst[e];
    csr.indptr[u + 1]++;
    if (undirected) csr.indptr[v + 1]++;
  }
  for (int64_t i = 0; i < num_nodes; ++i) csr.indptr[i + 1] += csr.indptr[i];
  csr.indices.resize(csr.indptr[num_nodes]);
  std::vector<int64_t> cursor(csr.indptr.begin(), csr.indptr.end() - 1);
  for (int64_t e = 0; e < num_edges; ++e) {
    if (!valid(e)) continue;
    int64_t u = reverse ? dst[e] : src[e];
    int64_t v = reverse ? src[e] : dst[e];
    csr.indices[cursor[u]++] = v;
    if (undirected) csr.indices[cursor[v]++] = u;
  }
  return csr;
}

void bfs(const Csr& csr, int64_t num_nodes, int64_t source, int64_t* dist,
         std::vector<int64_t>& queue) {
  std::memset(dist, -1, sizeof(int64_t) * num_nodes);
  if (source < 0 || source >= num_nodes) return;
  queue.clear();
  queue.push_back(source);
  dist[source] = 0;
  for (size_t head = 0; head < queue.size(); ++head) {
    int64_t u = queue[head];
    int64_t du = dist[u] + 1;
    for (int64_t i = csr.indptr[u]; i < csr.indptr[u + 1]; ++i) {
      int64_t v = csr.indices[i];
      if (dist[v] < 0) {
        dist[v] = du;
        queue.push_back(v);
      }
    }
  }
}

}  // namespace

extern "C" {

// Per-pair shortest-path union supervision.
//
// Outputs (caller-allocated):
//   out_mask        uint8[num_edges]               union on-path mask
//   out_pair_start  int64[n_starts * n_answers]    reachable pairs only
//   out_pair_answer int64[same]
//   out_pair_len    int64[same]
//   out_pair_edge_counts int64[same]
// Pair edge ids are streamed through a malloc'd buffer returned via
// *out_pair_edge_ids (length in *out_pair_edge_total); free with
// evi_free_i64.  Returns the number of reachable pairs, or -1 on error.
int64_t evi_bfs_pair_labels(
    int64_t num_nodes, int64_t num_edges,
    const int64_t* src, const int64_t* dst,
    int64_t n_starts, const int64_t* starts,
    int64_t n_answers, const int64_t* answers,
    int directed,
    uint8_t* out_mask,
    int64_t* out_pair_start, int64_t* out_pair_answer, int64_t* out_pair_len,
    int64_t* out_pair_edge_counts,
    int64_t** out_pair_edge_ids, int64_t* out_pair_edge_total) {
  if (num_nodes < 0 || num_edges < 0) return -1;
  std::memset(out_mask, 0, num_edges);
  *out_pair_edge_ids = nullptr;
  *out_pair_edge_total = 0;
  if (num_nodes == 0 || num_edges == 0 || n_starts == 0 || n_answers == 0) return 0;

  // Sorted-unique valid starts/answers (matches the python semantics).
  auto uniq = [&](const int64_t* arr, int64_t n) {
    std::vector<int64_t> v;
    v.reserve(n);
    for (int64_t i = 0; i < n; ++i)
      if (arr[i] >= 0 && arr[i] < num_nodes) v.push_back(arr[i]);
    std::sort(v.begin(), v.end());
    v.erase(std::unique(v.begin(), v.end()), v.end());
    return v;
  };
  std::vector<int64_t> ss = uniq(starts, n_starts);
  std::vector<int64_t> aa = uniq(answers, n_answers);
  if (ss.empty() || aa.empty()) return 0;

  bool undirected = directed == 0;
  Csr fwd = build_csr(num_nodes, num_edges, src, dst, undirected, /*reverse=*/false);
  Csr bwd = undirected ? fwd : build_csr(num_nodes, num_edges, src, dst, false, /*reverse=*/true);

  std::vector<int64_t> queue;
  queue.reserve(num_nodes);
  std::vector<std::vector<int64_t>> dist_s(ss.size(), std::vector<int64_t>(num_nodes));
  for (size_t i = 0; i < ss.size(); ++i) bfs(fwd, num_nodes, ss[i], dist_s[i].data(), queue);
  std::vector<std::vector<int64_t>> dist_a(aa.size(), std::vector<int64_t>(num_nodes));
  for (size_t j = 0; j < aa.size(); ++j) bfs(bwd, num_nodes, aa[j], dist_a[j].data(), queue);

  std::vector<int64_t> pair_edges;
  int64_t n_pairs = 0;
  for (size_t i = 0; i < ss.size(); ++i) {
    const int64_t* ds = dist_s[i].data();
    for (size_t j = 0; j < aa.size(); ++j) {
      const int64_t* da = dist_a[j].data();
      int64_t dsa = ds[aa[j]];
      if (dsa < 0) continue;
      out_pair_start[n_pairs] = ss[i];
      out_pair_answer[n_pairs] = aa[j];
      out_pair_len[n_pairs] = dsa;
      int64_t count = 0;
      for (int64_t e = 0; e < num_edges; ++e) {
        int64_t u = src[e], v = dst[e];
        if (u < 0 || v < 0 || u >= num_nodes || v >= num_nodes) continue;
        bool on = (ds[u] >= 0 && da[v] >= 0 && ds[u] + 1 + da[v] == dsa);
        if (undirected && !on)
          on = (ds[v] >= 0 && da[u] >= 0 && ds[v] + 1 + da[u] == dsa);
        if (on) {
          out_mask[e] = 1;
          pair_edges.push_back(e);
          ++count;
        }
      }
      out_pair_edge_counts[n_pairs] = count;
      ++n_pairs;
    }
  }
  if (!pair_edges.empty()) {
    int64_t* buf = static_cast<int64_t*>(std::malloc(pair_edges.size() * sizeof(int64_t)));
    if (!buf) return -1;
    std::memcpy(buf, pair_edges.data(), pair_edges.size() * sizeof(int64_t));
    *out_pair_edge_ids = buf;
    *out_pair_edge_total = static_cast<int64_t>(pair_edges.size());
  }
  return n_pairs;
}

void evi_free_i64(int64_t* ptr) { std::free(ptr); }

// Multi-source BFS distances (diagnostics / hop filters).
void evi_bfs_dist(int64_t num_nodes, int64_t num_edges, const int64_t* src,
                  const int64_t* dst, int64_t n_sources, const int64_t* sources,
                  int undirected, int64_t* out_dist) {
  Csr csr = build_csr(num_nodes, num_edges, src, dst, undirected != 0, false);
  std::memset(out_dist, -1, sizeof(int64_t) * num_nodes);
  std::vector<int64_t> queue;
  queue.reserve(num_nodes);
  for (int64_t i = 0; i < n_sources; ++i) {
    int64_t s = sources[i];
    if (s >= 0 && s < num_nodes && out_dist[s] < 0) {
      out_dist[s] = 0;
      queue.push_back(s);
    }
  }
  for (size_t head = 0; head < queue.size(); ++head) {
    int64_t u = queue[head];
    int64_t du = out_dist[u] + 1;
    for (int64_t k = csr.indptr[u]; k < csr.indptr[u + 1]; ++k) {
      int64_t v = csr.indices[k];
      if (out_dist[v] < 0) {
        out_dist[v] = du;
        queue.push_back(v);
      }
    }
  }
}

}  // extern "C"
