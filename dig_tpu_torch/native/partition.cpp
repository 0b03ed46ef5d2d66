// Native host-side graph machinery of dig_tpu_torch (a copy of the JAX
// package's dig_tpu/native/partition.cpp; the port never loads that
// package's library).
//
//  * dig_partition      — balanced k-way partitioner (greedy graph growing
//                         + Fiduccia–Mattheyses-style boundary refinement),
//                         standing in for torch_sparse's METIS binding used
//                         at dig/lsgraph/method/GraphFMOB/metis.py:14.
//  * dig_relabel_one_hop — one-hop subgraph extraction + relabeling with
//                         batch nodes first and out-of-batch neighbors
//                         appended, the contract of
//                         dig/lsgraph/method/GraphFMOB/csrc/cpu/relabel_cpu.cpp:5-102.
//
// Built with g++ (-O3 -shared -fPIC) at first use by
// dig_tpu_torch/native/build.py into dig_tpu_torch/_build/, and loaded
// through ctypes from dig_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

extern "C" {

// Balanced k-way partition of a CSR graph.
// rowptr: [n+1], col: [rowptr[n]], out: part id per node.
// Returns 0 on success.
int dig_partition(const int64_t* rowptr, const int64_t* col, int64_t n,
                  int64_t k, int64_t* out) {
  if (n <= 0 || k <= 0) return 1;
  std::vector<int64_t> part(n, -1);
  const int64_t target = (n + k - 1) / k;

  // --- greedy graph growing (GGGP) ---
  std::vector<int64_t> gain(n, 0);
  int64_t unassigned = n;
  for (int64_t p = 0; p + 1 < k; ++p) {
    int64_t size = 0;
    std::fill(gain.begin(), gain.end(), 0);
    // max-heap of (gain, node); lazily invalidated
    std::priority_queue<std::pair<int64_t, int64_t>> frontier;
    while (size < target && unassigned > 0) {
      int64_t v = -1;
      while (!frontier.empty()) {
        auto [g, u] = frontier.top();
        frontier.pop();
        if (part[u] == -1 && g == gain[u]) { v = u; break; }
      }
      if (v == -1) {
        // new seed: unassigned node with min degree
        int64_t best_deg = INT64_MAX;
        for (int64_t u = 0; u < n; ++u) {
          if (part[u] == -1) {
            int64_t d = rowptr[u + 1] - rowptr[u];
            if (d < best_deg) { best_deg = d; v = u; }
          }
        }
        if (v == -1) break;
      }
      part[v] = p;
      ++size;
      --unassigned;
      for (int64_t e = rowptr[v]; e < rowptr[v + 1]; ++e) {
        int64_t u = col[e];
        if (part[u] == -1) {
          ++gain[u];
          frontier.push({gain[u], u});
        }
      }
    }
  }
  for (int64_t v = 0; v < n; ++v)
    if (part[v] == -1) part[v] = k - 1;

  // --- FM-style refinement: move nodes to majority-neighbor part ---
  std::vector<int64_t> sizes(k, 0);
  for (int64_t v = 0; v < n; ++v) ++sizes[part[v]];
  const int64_t cap = target + 1;
  std::vector<int64_t> hist(k);
  for (int pass = 0; pass < 6; ++pass) {
    int64_t moved = 0;
    for (int64_t v = 0; v < n; ++v) {
      if (rowptr[v + 1] == rowptr[v]) continue;
      std::fill(hist.begin(), hist.end(), 0);
      for (int64_t e = rowptr[v]; e < rowptr[v + 1]; ++e)
        ++hist[part[col[e]]];
      int64_t cur = part[v], best = cur;
      for (int64_t p = 0; p < k; ++p)
        if (hist[p] > hist[best]) best = p;
      if (best != cur && hist[best] > hist[cur] && sizes[best] < cap) {
        --sizes[cur];
        ++sizes[best];
        part[v] = best;
        ++moved;
      }
    }
    if (moved == 0) break;
  }
  std::memcpy(out, part.data(), n * sizeof(int64_t));
  return 0;
}

// One-hop subgraph extraction + relabel (reference contract:
// csrc/cpu/relabel_cpu.cpp — batch nodes get local ids [0, B); previously
// unseen out-of-batch neighbors are appended after).
// Returns number of output nodes (B + halo), or -1 on overflow/error.
int64_t dig_relabel_one_hop(const int64_t* rowptr, const int64_t* col,
                            const int64_t* idx, int64_t num_idx,
                            int64_t num_nodes, int64_t* out_rowptr,
                            int64_t* out_col, int64_t* out_n_id,
                            int64_t max_out_edges, int64_t max_out_nodes) {
  std::unordered_map<int64_t, int64_t> local;
  local.reserve(num_idx * 2);
  if (num_idx > max_out_nodes) return -1;
  for (int64_t i = 0; i < num_idx; ++i) {
    local[idx[i]] = i;
    out_n_id[i] = idx[i];
  }
  int64_t n_out = num_idx;
  int64_t e_out = 0;
  out_rowptr[0] = 0;
  for (int64_t i = 0; i < num_idx; ++i) {
    int64_t v = idx[i];
    if (v < 0 || v >= num_nodes) return -1;
    for (int64_t e = rowptr[v]; e < rowptr[v + 1]; ++e) {
      int64_t u = col[e];
      auto it = local.find(u);
      int64_t lu;
      if (it == local.end()) {
        if (n_out >= max_out_nodes) return -1;
        lu = n_out;
        local[u] = lu;
        out_n_id[lu] = u;
        ++n_out;
      } else {
        lu = it->second;
      }
      if (e_out >= max_out_edges) return -1;
      out_col[e_out++] = lu;
    }
    out_rowptr[i + 1] = e_out;
  }
  return n_out;
}

}  // extern "C"
