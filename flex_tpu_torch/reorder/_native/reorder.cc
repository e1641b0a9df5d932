// Native (C++) implementations of the heavy reordering passes.
//
// TPU-native framework counterpart of the reference's CPU graph-algorithm
// layer (order_gorder.cu / unitheap.cu / DataLoader.cu:324-655): the greedy
// Gorder loop and Rabbit's modularity clustering are irreducibly sequential
// pointer-chasing — the one part of the pipeline that belongs in C++, not in
// NumPy and not on the TPU.  Exposed with a plain C ABI for ctypes.
//
// Conventions: CSR with int64 row_ptr, int32 col; all outputs are
// permutations with perm[new_id] = old_id.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// DFS preorder renumbering (reference DataLoader.cu:324-453 semantics).
// ---------------------------------------------------------------------------
void flex_order_dfs(int64_t n, const int64_t* row_ptr, const int32_t* col,
                    int64_t* perm_out) {
  std::vector<uint8_t> visited(n, 0);
  std::vector<int64_t> stack_v(n), stack_e(n);
  int64_t nxt = 0, root = 0;
  while (nxt < n) {
    visited[root] = 1;
    perm_out[nxt++] = root;
    int64_t top = 0;
    stack_v[0] = root;
    stack_e[0] = row_ptr[root];
    while (top >= 0) {
      int64_t v = stack_v[top];
      int64_t e = stack_e[top];
      const int64_t end = row_ptr[v + 1];
      while (e < end && visited[col[e]]) ++e;
      if (e == end) {
        --top;
        continue;
      }
      stack_e[top] = e + 1;
      const int64_t d = col[e];
      visited[d] = 1;
      perm_out[nxt++] = d;
      ++top;
      stack_v[top] = d;
      stack_e[top] = row_ptr[d];
    }
    if (nxt >= n) break;
    while (root < n && visited[root]) ++root;
  }
}

// ---------------------------------------------------------------------------
// Gorder greedy loop (reference order_gorder.cu:35-143).
//
// Operates on a pre-relabeled (RCM-space) graph; the caller supplies both the
// out-adjacency (row_ptr/col) and in-adjacency (in_ptr/in_col, i.e. the
// transpose), both with sorted neighbor lists.  Priority of a candidate v
// counts, over the current window: edges u->v, v->u, and shared in-neighbors,
// all unit-weighted; vertices with out-degree > sqrt(n) are skipped when
// fanning updates out.
// ---------------------------------------------------------------------------
void flex_order_gorder(int64_t n, const int64_t* row_ptr, const int32_t* col,
                       const int64_t* in_ptr, const int32_t* in_col,
                       int64_t window, int64_t* perm_out) {
  if (n == 0) return;
  const int64_t huge = (int64_t)std::sqrt((double)n);

  std::vector<int64_t> key(n);
  std::vector<uint8_t> placed(n, 0);
  auto deg_out = [&](int64_t u) { return row_ptr[u + 1] - row_ptr[u]; };
  auto deg_in = [&](int64_t u) { return in_ptr[u + 1] - in_ptr[u]; };

  // Lazy max-heap of (key, -node): ties broken toward the smallest node id,
  // matching the Python fallback's heapq ordering. Stale entries skipped at
  // pop.
  using Entry = std::pair<int64_t, int64_t>;
  std::priority_queue<Entry> heap;
  std::vector<int64_t> isolates;
  for (int64_t u = 0; u < n; ++u) {
    key[u] = deg_in(u);
    if (deg_out(u) + deg_in(u) == 0)
      isolates.push_back(u);
    else
      heap.push({key[u], -u});
  }

  std::vector<int64_t> order;
  order.reserve(n);

  auto bump = [&](int64_t v, int64_t delta) {
    if (placed[v]) return;
    key[v] += delta;
    heap.push({key[v], -v});
  };

  std::vector<int64_t> only_old, only_new;
  auto window_update = [&](int64_t new_node, int64_t old_node) {
    // Children of the expiring node lose a point.
    if (old_node != new_node && deg_out(old_node) <= huge)
      for (int64_t e = row_ptr[old_node]; e < row_ptr[old_node + 1]; ++e)
        bump(col[e], -1);

    // Linear merge of the two sorted in-neighbor lists; common parents
    // cancel out and are ignored.
    only_old.clear();
    only_new.clear();
    int64_t a = (old_node != new_node) ? in_ptr[old_node] : in_ptr[old_node + 1];
    const int64_t a_end = in_ptr[old_node + 1];
    int64_t b = in_ptr[new_node];
    const int64_t b_end = in_ptr[new_node + 1];
    while (a < a_end || b < b_end) {
      if (a < a_end && b < b_end && in_col[a] == in_col[b]) {
        ++a;
        ++b;
      } else if (b >= b_end || (a < a_end && in_col[a] < in_col[b])) {
        if (deg_out(in_col[a]) <= huge) only_old.push_back(in_col[a]);
        ++a;
      } else {
        if (deg_out(in_col[b]) <= huge) only_new.push_back(in_col[b]);
        ++b;
      }
    }

    for (int64_t p : only_old) {
      bump(p, -1);
      for (int64_t e = row_ptr[p]; e < row_ptr[p + 1]; ++e)
        if (col[e] != old_node) bump(col[e], -1);
    }
    if (deg_out(new_node) <= huge)
      for (int64_t e = row_ptr[new_node]; e < row_ptr[new_node + 1]; ++e)
        bump(col[e], +1);
    for (int64_t p : only_new) {
      bump(p, +1);
      for (int64_t e = row_ptr[p]; e < row_ptr[p + 1]; ++e)
        if (col[e] != new_node) bump(col[e], +1);
    }
  };

  auto extract_max = [&]() -> int64_t {
    while (!heap.empty()) {
      auto [k, nu] = heap.top();
      const int64_t u = -nu;
      heap.pop();
      if (placed[u] || k != key[u]) continue;
      return u;
    }
    return -1;
  };

  int64_t hub = extract_max();
  if (hub >= 0) {
    placed[hub] = 1;
    order.push_back(hub);
    window_update(hub, hub);
    while (true) {
      int64_t u = extract_max();
      if (u < 0) break;
      placed[u] = 1;
      order.push_back(u);
      int64_t old = ((int64_t)order.size() > window)
                        ? order[order.size() - window - 1]
                        : u;
      window_update(u, old);
    }
  }
  for (int64_t u : isolates) order.push_back(u);
  std::memcpy(perm_out, order.data(), n * sizeof(int64_t));
}

// ---------------------------------------------------------------------------
// Rabbit modularity clustering (reference DataLoader.cu:455-655).
// ---------------------------------------------------------------------------
// labels_out (optional, may be NULL): cluster id per ORIGINAL vertex,
// numbered in surviving-root emission order — lets callers build composite
// orderings (e.g. degree-descending within each rabbit cluster).
void flex_order_rabbit(int64_t n, const int64_t* row_ptr, const int32_t* col,
                       int32_t force_undirected, int64_t max_rounds,
                       int64_t* perm_out, int64_t* labels_out) {
  if (n == 0) return;

  // Unit-weight undirected multigraph adjacency (self-loops dropped).
  std::vector<std::unordered_map<int64_t, int64_t>> adj(n);
  for (int64_t u = 0; u < n; ++u)
    for (int64_t e = row_ptr[u]; e < row_ptr[u + 1]; ++e) {
      const int64_t d = col[e];
      if (d == u) continue;
      adj[u][d] = 1;
      if (force_undirected) adj[d][u] = 1;
    }

  std::vector<int64_t> deg(n);
  int64_t n_edges = 0;
  for (int64_t u = 0; u < n; ++u) {
    deg[u] = (int64_t)adj[u].size();
    n_edges += deg[u];
  }
  if (n_edges == 0) {
    for (int64_t u = 0; u < n; ++u) {
      perm_out[u] = u;
      if (labels_out) labels_out[u] = u;
    }
    return;
  }
  const double two_m_inv = 1.0 / (2.0 * (double)n_edges);

  // Dendrogram as a binary forest: each merge makes an internal node.
  struct Node {
    int64_t left, right;  // children (internal >= n encodes index-n), or leaf
  };
  std::vector<Node> internals;
  internals.reserve(n);
  std::vector<int64_t> tree(n);  // current dendrogram handle per cluster
  for (int64_t u = 0; u < n; ++u) tree[u] = u;  // leaf ids < n

  std::vector<uint8_t> alive(n, 1);
  std::vector<int64_t> round_of(n, 0);
  std::vector<int64_t> this_round(n), next_round;
  for (int64_t u = 0; u < n; ++u) this_round[u] = u;

  for (int64_t rnd = 1; rnd <= max_rounds; ++rnd) {
    std::stable_sort(this_round.begin(), this_round.end(),
                     [&](int64_t x, int64_t y) { return deg[x] < deg[y]; });
    next_round.clear();
    for (int64_t u : this_round) {
      if (!alive[u] || round_of[u] == rnd) continue;
      auto& au = adj[u];
      if (au.empty()) continue;
      const double dv_2m = (double)deg[u] * two_m_inv;
      // Ties prefer the smallest neighbor id (deterministic across the
      // unordered_map iteration order; matches the Python fallback).
      double best_dq = -1.0;
      int64_t v = -1;
      for (auto& [d, w] : au) {
        const double dq = (double)w - (double)deg[d] * dv_2m;
        if (dq > best_dq || (dq == best_dq && (v < 0 || d < v))) {
          best_dq = dq;
          v = d;
        }
      }
      if (best_dq <= 0 || v < 0) continue;

      auto& av = adj[v];
      deg[v] += deg[u];
      for (auto& [d, w] : au) {
        if (d == v) continue;
        av[d] += w;
        auto& ad = adj[d];
        auto it = ad.find(u);
        if (it != ad.end()) {
          ad[v] += it->second;
          ad.erase(it);
        }
      }
      av.erase(u);
      au.clear();
      internals.push_back({tree[v], tree[u]});
      tree[v] = n + (int64_t)internals.size() - 1;
      alive[u] = 0;

      if (round_of[v] != rnd) {
        round_of[v] = rnd;
        next_round.push_back(v);
      }
    }
    if (next_round.empty()) break;
    std::swap(this_round, next_round);
  }

  // Emit dendrogram leaves, clusters in surviving-root index order,
  // left subtree (merge target) before right (merged-in vertex).
  int64_t pos = 0;
  int64_t cluster = -1;
  std::vector<int64_t> stack;
  for (int64_t r = 0; r < n; ++r) {
    if (!alive[r]) continue;
    ++cluster;
    stack.push_back(tree[r]);
    while (!stack.empty()) {
      const int64_t node = stack.back();
      stack.pop_back();
      if (node < n) {
        if (labels_out) labels_out[node] = cluster;
        perm_out[pos++] = node;
      } else {
        const Node& in_node = internals[node - n];
        stack.push_back(in_node.right);
        stack.push_back(in_node.left);
      }
    }
  }
}

}  // extern "C"
