// graphslim_tpu native host ops.
//
// First-party C++ for the host-side algorithms that are inherently
// sequential and therefore poor fits for XLA (SURVEY.md §7 hard part 5) —
// the reference delegates these to third-party compiled deps
// (NetworKit C++, PyG C++ samplers; reference SURVEY.md §2.9):
//
//   * csr_from_edges       — sort+dedup+symmetrize edge lists into CSR
//                            (the loader's hot host path)
//   * greedy_matching      — weight-ordered disjoint edge matching
//                            (coarsening contraction)
//   * t_spanner            — greedy spanner with bounded Dijkstra
//                            (reference t_spanner.py via nk)
//   * connected_components — union-find
//   * max_weight_matching  — exact Edmonds blossom matching, O(n^3)
//                            (the reference's `matching_optimal`,
//                            coarsening/utils.py:34,1787 — vendored
//                            maxWeightMatching; here a first-party
//                            primal-dual blossom implementation)
//
// Exposed through a plain C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <cstdint>
#include <deque>
#include <functional>
#include <cstring>
#include <limits>
#include <queue>
#include <utility>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Exact maximum-weight matching on a general graph (Edmonds blossom).
//
// Primal-dual O(n^3) implementation. Vertex duals are stored doubled
// (lab = 2*y) so all updates stay integral for integer edge weights;
// edge slack in those units is lab[u] + lab[v] - 2*w(u,v). Vertices are
// 1-indexed internally; slots n+1..2n hold contracted blossoms. Only
// maximizes total weight (non-perfect, like the reference's
// maxWeightMatching with maxcardinality=False): the search stops when a
// free outer vertex's dual would drop below zero.
// ---------------------------------------------------------------------------
class MaxWeightMatching {
 public:
  explicit MaxWeightMatching(int n)
      : n_(n), n_x_(n),
        g_((2 * n + 1) * (2 * n + 1)),
        lab_(2 * n + 1, 0), match_(2 * n + 1, 0), slack_(2 * n + 1, 0),
        st_(2 * n + 1, 0), pa_(2 * n + 1, 0), S_(2 * n + 1, -1),
        vis_(2 * n + 1, 0), flower_(2 * n + 1),
        flower_from_((2 * n + 1) * (n + 1), 0) {
    for (int u = 0; u <= 2 * n; ++u)
      for (int v = 0; v <= 2 * n; ++v) edge(u, v) = {u, v, 0};
  }

  // w must be > 0 (0 encodes "no edge").
  void add_edge(int u, int v, int64_t w) {
    edge(u, v).w = edge(v, u).w = w;
  }

  int64_t weight(int u, int v) { return edge(u, v).w; }

  // Runs the algorithm; match(u) is the partner of u (0 if unmatched).
  void solve() {
    for (int u = 0; u <= n_; ++u) st_[u] = u;
    int64_t w_max = 0;
    for (int u = 1; u <= n_; ++u)
      for (int v = 1; v <= n_; ++v) {
        ff(u, v) = (u == v ? u : 0);
        w_max = std::max(w_max, edge(u, v).w);
      }
    for (int u = 1; u <= n_; ++u) lab_[u] = w_max;
    while (matching()) {
    }
  }

  int match(int u) const { return match_[u]; }

 private:
  struct E {
    int u, v;
    int64_t w;
  };
  static constexpr int64_t kInf = std::numeric_limits<int64_t>::max() / 4;

  E& edge(int u, int v) { return g_[u * (2 * n_ + 1) + v]; }
  int& ff(int b, int x) { return flower_from_[b * (n_ + 1) + x]; }

  int64_t e_delta(const E& e) {
    return lab_[e.u] + lab_[e.v] - edge(e.u, e.v).w * 2;
  }
  void update_slack(int u, int x) {
    if (!slack_[x] || e_delta(edge(u, x)) < e_delta(edge(slack_[x], x)))
      slack_[x] = u;
  }
  void set_slack(int x) {
    slack_[x] = 0;
    for (int u = 1; u <= n_; ++u)
      if (edge(u, x).w > 0 && st_[u] != x && S_[st_[u]] == 0)
        update_slack(u, x);
  }
  void q_push(int x) {
    if (x <= n_) {
      q_.push_back(x);
    } else {
      for (int i : flower_[x]) q_push(i);
    }
  }
  void set_st(int x, int b) {
    st_[x] = b;
    if (x > n_)
      for (int i : flower_[x]) set_st(i, b);
  }
  int get_pr(int b, int xr) {
    int pr = static_cast<int>(
        std::find(flower_[b].begin(), flower_[b].end(), xr) -
        flower_[b].begin());
    if (pr % 2 == 1) {  // walk the stem the other way round
      std::reverse(flower_[b].begin() + 1, flower_[b].end());
      return static_cast<int>(flower_[b].size()) - pr;
    }
    return pr;
  }
  void set_match(int u, int v) {
    match_[u] = edge(u, v).v;
    if (u > n_) {
      E e = edge(u, v);
      int xr = ff(u, e.u);
      int pr = get_pr(u, xr);
      for (int i = 0; i < pr; ++i)
        set_match(flower_[u][i], flower_[u][i ^ 1]);
      set_match(xr, v);
      std::rotate(flower_[u].begin(), flower_[u].begin() + pr,
                  flower_[u].end());
    }
  }
  void augment(int u, int v) {
    for (;;) {
      int xnv = st_[match_[u]];
      set_match(u, v);
      if (!xnv) return;
      set_match(xnv, st_[pa_[xnv]]);
      u = st_[pa_[xnv]];
      v = xnv;
    }
  }
  int get_lca(int u, int v) {
    ++t_;
    for (; u || v; std::swap(u, v)) {
      if (u == 0) continue;
      if (vis_[u] == t_) return u;
      vis_[u] = t_;
      u = st_[match_[u]];
      if (u) u = st_[pa_[u]];
    }
    return 0;
  }
  void add_blossom(int u, int lca, int v) {
    int b = n_ + 1;
    while (b <= n_x_ && st_[b]) ++b;
    if (b > n_x_) ++n_x_;
    lab_[b] = 0;
    S_[b] = 0;
    match_[b] = match_[lca];
    flower_[b].clear();
    flower_[b].push_back(lca);
    for (int x = u, y; x != lca; x = st_[pa_[y]]) {
      flower_[b].push_back(x);
      flower_[b].push_back(y = st_[match_[x]]);
      q_push(y);
    }
    std::reverse(flower_[b].begin() + 1, flower_[b].end());
    for (int x = v, y; x != lca; x = st_[pa_[y]]) {
      flower_[b].push_back(x);
      flower_[b].push_back(y = st_[match_[x]]);
      q_push(y);
    }
    set_st(b, b);
    for (int x = 1; x <= n_x_; ++x) edge(b, x).w = edge(x, b).w = 0;
    for (int x = 1; x <= n_; ++x) ff(b, x) = 0;
    for (int xs : flower_[b]) {
      for (int x = 1; x <= n_x_; ++x)
        if (edge(b, x).w == 0 || e_delta(edge(xs, x)) < e_delta(edge(b, x))) {
          edge(b, x) = edge(xs, x);
          edge(x, b) = edge(x, xs);
        }
      for (int x = 1; x <= n_; ++x)
        if (ff(xs, x)) ff(b, x) = xs;
    }
    set_slack(b);
  }
  void expand_blossom(int b) {
    for (int i : flower_[b]) set_st(i, i);
    int xr = ff(b, edge(b, pa_[b]).u);
    int pr = get_pr(b, xr);
    for (int i = 0; i < pr; i += 2) {
      int xs = flower_[b][i], xns = flower_[b][i + 1];
      pa_[xs] = edge(xns, xs).u;
      S_[xs] = 1;
      S_[xns] = 0;
      slack_[xs] = 0;
      set_slack(xns);
      q_push(xns);
    }
    S_[xr] = 1;
    pa_[xr] = pa_[b];
    for (size_t i = pr + 1; i < flower_[b].size(); ++i) {
      int xs = flower_[b][i];
      S_[xs] = -1;
      set_slack(xs);
    }
    st_[b] = 0;
  }
  bool on_found_edge(const E& e) {
    int u = st_[e.u], v = st_[e.v];
    if (S_[v] == -1) {
      pa_[v] = e.u;
      S_[v] = 1;
      int nu = st_[match_[v]];
      slack_[v] = slack_[nu] = 0;
      S_[nu] = 0;
      q_push(nu);
    } else if (S_[v] == 0) {
      int lca = get_lca(u, v);
      if (!lca) {
        augment(u, v);
        augment(v, u);
        return true;
      }
      add_blossom(u, lca, v);
    }
    return false;
  }
  bool matching() {
    std::fill(S_.begin(), S_.begin() + n_x_ + 1, -1);
    std::fill(slack_.begin(), slack_.begin() + n_x_ + 1, 0);
    q_.clear();
    for (int x = 1; x <= n_x_; ++x)
      if (st_[x] == x && !match_[x]) {
        pa_[x] = 0;
        S_[x] = 0;
        q_push(x);
      }
    if (q_.empty()) return false;
    for (;;) {
      while (!q_.empty()) {
        int u = q_.front();
        q_.pop_front();
        if (S_[st_[u]] == 1) continue;
        for (int v = 1; v <= n_; ++v)
          if (edge(u, v).w > 0 && st_[u] != st_[v]) {
            if (e_delta(edge(u, v)) == 0) {
              if (on_found_edge(edge(u, v))) return true;
            } else {
              update_slack(u, st_[v]);
            }
          }
      }
      int64_t d = kInf;
      for (int b = n_ + 1; b <= n_x_; ++b)
        if (st_[b] == b && S_[b] == 1) d = std::min(d, lab_[b] / 2);
      for (int x = 1; x <= n_x_; ++x)
        if (st_[x] == x && slack_[x]) {
          if (S_[x] == -1)
            d = std::min(d, e_delta(edge(slack_[x], x)));
          else if (S_[x] == 0)
            d = std::min(d, e_delta(edge(slack_[x], x)) / 2);
        }
      for (int u = 1; u <= n_; ++u) {
        if (S_[st_[u]] == 0) {
          if (lab_[u] <= d) return false;  // dual would hit 0: done
          lab_[u] -= d;
        } else if (S_[st_[u]] == 1) {
          lab_[u] += d;
        }
      }
      for (int b = n_ + 1; b <= n_x_; ++b)
        if (st_[b] == b) {
          if (S_[b] == 0)
            lab_[b] += d * 2;
          else if (S_[b] == 1)
            lab_[b] -= d * 2;
        }
      q_.clear();
      for (int x = 1; x <= n_x_; ++x)
        if (st_[x] == x && slack_[x] && st_[slack_[x]] != x &&
            e_delta(edge(slack_[x], x)) == 0)
          if (on_found_edge(edge(slack_[x], x))) return true;
      for (int b = n_ + 1; b <= n_x_; ++b)
        if (st_[b] == b && S_[b] == 1 && lab_[b] == 0) expand_blossom(b);
    }
  }

  int n_, n_x_, t_ = 0;
  std::vector<E> g_;
  std::vector<int64_t> lab_;
  std::vector<int> match_, slack_, st_, pa_, S_, vis_;
  std::vector<std::vector<int>> flower_;
  std::vector<int> flower_from_;
  std::deque<int> q_;
};

}  // namespace

extern "C" {

// Exact maximum-weight matching (Edmonds blossom). Nodes 0..n-1; parallel
// edges keep the max weight. Weights are int64 and must be >= 1 for a
// usable edge (w <= 0 edges are ignored). Writes matched pairs (i < j)
// into out_pairs (2 entries per match); returns the number of matches.
int64_t max_weight_matching(const int64_t* src, const int64_t* dst,
                            const int64_t* weight, int64_t m, int64_t n,
                            int64_t* out_pairs) {
  MaxWeightMatching mw(static_cast<int>(n));
  for (int64_t e = 0; e < m; ++e) {
    if (src[e] == dst[e] || weight[e] <= 0) continue;
    int u = static_cast<int>(src[e]) + 1, v = static_cast<int>(dst[e]) + 1;
    if (weight[e] > mw.weight(u, v)) mw.add_edge(u, v, weight[e]);
  }
  mw.solve();
  int64_t out = 0;
  for (int u = 1; u <= n; ++u) {
    int v = mw.match(u);
    if (v > u) {
      out_pairs[2 * out] = u - 1;
      out_pairs[2 * out + 1] = v - 1;
      ++out;
    }
  }
  return out;
}

}  // extern "C"

extern "C" {

// Sort by (row, col), deduplicate (summing weights), return new nnz.
// rows/cols/vals are in/out buffers of length nnz.
int64_t csr_sort_dedup(int64_t* rows, int64_t* cols, double* vals,
                       int64_t nnz) {
  std::vector<int64_t> order(nnz);
  for (int64_t i = 0; i < nnz; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    if (rows[a] != rows[b]) return rows[a] < rows[b];
    return cols[a] < cols[b];
  });
  std::vector<int64_t> r(nnz), c(nnz);
  std::vector<double> v(nnz);
  for (int64_t i = 0; i < nnz; ++i) {
    r[i] = rows[order[i]];
    c[i] = cols[order[i]];
    v[i] = vals[order[i]];
  }
  int64_t out = -1;
  for (int64_t i = 0; i < nnz; ++i) {
    if (out >= 0 && rows[out] == r[i] && cols[out] == c[i]) {
      vals[out] += v[i];
    } else {
      ++out;
      rows[out] = r[i];
      cols[out] = c[i];
      vals[out] = v[i];
    }
  }
  return out + 1;
}

// Greedy disjoint matching: edges sorted by weight descending; marks
// matched pairs into out_pairs (2 entries per match). Returns #matches.
int64_t greedy_matching(const int64_t* src, const int64_t* dst,
                        const double* weight, int64_t m, int64_t n,
                        double r, int64_t* out_pairs) {
  std::vector<int64_t> order(m);
  for (int64_t i = 0; i < m; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return weight[a] > weight[b];
  });
  std::vector<char> marked(n, 0);
  int64_t budget = static_cast<int64_t>(n - (1.0 - r) * n);
  int64_t out = 0;
  for (int64_t k = 0; k < m && out < budget; ++k) {
    int64_t i = src[order[k]], j = dst[order[k]];
    if (i == j || marked[i] || marked[j]) continue;
    marked[i] = marked[j] = 1;
    out_pairs[2 * out] = i;
    out_pairs[2 * out + 1] = j;
    ++out;
  }
  return out;
}

// Greedy t-spanner: process edges lightest first; keep an edge iff the
// current spanner distance between endpoints exceeds t*w. Exact (the
// spanner graph is updated after every accepted edge, unlike the batched
// Python fallback). Returns number of kept edges; kept indices in
// out_keep.
int64_t t_spanner(const int64_t* src, const int64_t* dst,
                  const double* weight, int64_t m, int64_t n, double t,
                  int64_t* out_keep) {
  std::vector<int64_t> order(m);
  for (int64_t i = 0; i < m; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return weight[a] < weight[b];
  });
  // adjacency of the growing spanner
  std::vector<std::vector<std::pair<int64_t, double>>> adj(n);
  std::vector<double> dist(n, std::numeric_limits<double>::infinity());
  std::vector<int64_t> touched;
  int64_t kept = 0;
  using QE = std::pair<double, int64_t>;
  for (int64_t k = 0; k < m; ++k) {
    int64_t e = order[k];
    int64_t u = src[e], v = dst[e];
    double w = weight[e];
    double limit = t * w;
    // bounded Dijkstra from u
    bool reachable = false;
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
    dist[u] = 0.0;
    touched.push_back(u);
    pq.push({0.0, u});
    while (!pq.empty()) {
      auto [d, x] = pq.top();
      pq.pop();
      if (d > dist[x]) continue;
      if (x == v) {
        reachable = d <= limit;
        break;
      }
      if (d > limit) break;
      for (auto& [y, wy] : adj[x]) {
        double nd = d + wy;
        if (nd <= limit && nd < dist[y]) {
          if (dist[y] == std::numeric_limits<double>::infinity())
            touched.push_back(y);
          dist[y] = nd;
          pq.push({nd, y});
        }
      }
    }
    for (int64_t x : touched)
      dist[x] = std::numeric_limits<double>::infinity();
    touched.clear();
    if (!reachable) {
      adj[u].push_back({v, w});
      adj[v].push_back({u, w});
      out_keep[kept++] = e;
    }
  }
  return kept;
}

// Union-find connected components; writes component id per node.
int64_t connected_components(const int64_t* src, const int64_t* dst,
                             int64_t m, int64_t n, int64_t* out_comp) {
  std::vector<int64_t> parent(n);
  for (int64_t i = 0; i < n; ++i) parent[i] = i;
  std::vector<int64_t>* p = &parent;
  std::function<int64_t(int64_t)> find = [&](int64_t x) {
    while ((*p)[x] != x) {
      (*p)[x] = (*p)[(*p)[x]];
      x = (*p)[x];
    }
    return x;
  };
  for (int64_t e = 0; e < m; ++e) {
    int64_t a = find(src[e]), b = find(dst[e]);
    if (a != b) parent[a] = b;
  }
  std::vector<int64_t> remap(n, -1);
  int64_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t root = find(i);
    if (remap[root] < 0) remap[root] = next++;
    out_comp[i] = remap[root];
  }
  return next;
}

// ---------------------------------------------------------------------------
// Balanced k-way min-edge-cut partition (distributed halo layout,
// dist/spmm.py).  Multilevel scheme: heavy-edge-matching coarsening,
// BFS region growing on the coarsest graph, Fiduccia–Mattheyses-style
// weighted boundary refinement at every uncoarsening level.  New design
// — the reference is single-device and has no partitioner (SURVEY §2.10).
// ---------------------------------------------------------------------------

struct WGraph {
  std::vector<int64_t> indptr, col, ew, vw;  // symmetric weighted CSR
  int64_t n() const { return static_cast<int64_t>(vw.size()); }
};

static uint64_t pg_rng(uint64_t* s) {  // xorshift64*
  uint64_t x = *s;
  x ^= x >> 12; x ^= x << 25; x ^= x >> 27;
  *s = x;
  return x * 0x2545F4914F6CDD1DULL;
}

// Weighted FM-lite: positive-gain (or balance-pressure neutral) single
// moves, vertex-weighted balance cap.
static void pg_refine(const WGraph& g, int64_t k, double slack,
                      int64_t passes, std::vector<int64_t>* part_io,
                      std::vector<int64_t>* size_io) {
  std::vector<int64_t>& part = *part_io;
  std::vector<int64_t>& size = *size_io;
  int64_t tot_vw = 0;
  for (int64_t w : g.vw) tot_vw += w;
  const int64_t cap = static_cast<int64_t>(
      (static_cast<double>(tot_vw) / k) * (1.0 + slack)) + 1;
  const int64_t floor_sz = static_cast<int64_t>(
      (static_cast<double>(tot_vw) / k) * (1.0 - slack));
  std::vector<int64_t> cnt(k, 0);
  for (int64_t pass = 0; pass < passes; ++pass) {
    int64_t moves = 0;
    for (int64_t u = 0; u < g.n(); ++u) {
      const int64_t pu = part[u];
      bool boundary = false;
      for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
        const int64_t pv = part[g.col[e]];
        cnt[pv] += g.ew[e];
        boundary |= (pv != pu);
      }
      if (boundary) {
        int64_t best = pu, best_gain = 0;
        for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
          const int64_t pv = part[g.col[e]];
          if (pv == pu || size[pv] + g.vw[u] > cap) continue;
          const int64_t gain = cnt[pv] - cnt[pu];
          if (gain > best_gain ||
              (gain == best_gain && best != pu && size[pv] < size[best]) ||
              (gain == 0 && best == pu && size[pu] - g.vw[u] >= floor_sz &&
               size[pv] + g.vw[u] < size[pu])) {
            best = pv;
            best_gain = gain;
          }
        }
        if (best != pu && size[pu] - g.vw[u] >= floor_sz) {
          part[u] = best;
          size[pu] -= g.vw[u];
          size[best] += g.vw[u];
          ++moves;
        }
      }
      for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e)
        cnt[part[g.col[e]]] = 0;
      cnt[pu] = 0;
      cnt[part[u]] = 0;
    }
    if (moves == 0) break;
  }
}

// Balanced BFS region growing from multi-source farthest-point seeds.
static void pg_grow(const WGraph& g, int64_t k, std::vector<int64_t>* part_o,
                    std::vector<int64_t>* size_o) {
  const int64_t n = g.n();
  std::vector<int64_t>& part = *part_o;
  std::vector<int64_t>& size = *size_o;
  part.assign(n, -1);
  size.assign(k, 0);
  std::vector<int64_t> dist(n, -1), seeds;
  std::deque<int64_t> q;
  int64_t s0 = 0;
  q.push_back(0);
  dist[0] = 0;
  while (!q.empty()) {
    int64_t u = q.front();
    q.pop_front();
    s0 = u;
    for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e)
      if (dist[g.col[e]] < 0) {
        dist[g.col[e]] = dist[u] + 1;
        q.push_back(g.col[e]);
      }
  }
  seeds.push_back(s0);
  while (static_cast<int64_t>(seeds.size()) < k) {
    std::fill(dist.begin(), dist.end(), -1);
    q.clear();
    for (int64_t s : seeds) { dist[s] = 0; q.push_back(s); }
    int64_t far = seeds.back();
    while (!q.empty()) {
      int64_t u = q.front();
      q.pop_front();
      far = u;
      for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e)
        if (dist[g.col[e]] < 0) {
          dist[g.col[e]] = dist[u] + 1;
          q.push_back(g.col[e]);
        }
    }
    bool dup = false;
    for (int64_t s : seeds) dup |= (s == far);
    if (dup)
      for (int64_t i = 0; i < n && dup; ++i) {
        bool used = false;
        for (int64_t s : seeds) used |= (s == i);
        if (!used) { far = i; dup = false; }
      }
    seeds.push_back(far);
  }
  std::vector<std::deque<int64_t>> front(k);
  for (int64_t p = 0; p < k; ++p) {
    if (part[seeds[p]] < 0) {
      part[seeds[p]] = p;
      size[p] += g.vw[seeds[p]];
    }
    front[p].push_back(seeds[p]);
  }
  int64_t assigned = 0;
  for (int64_t i = 0; i < n; ++i) assigned += (part[i] >= 0);
  int64_t scan = 0;
  while (assigned < n) {
    int64_t p = 0;
    for (int64_t j = 1; j < k; ++j)
      if (size[j] < size[p]) p = j;
    int64_t picked = -1;
    while (!front[p].empty() && picked < 0) {
      int64_t u = front[p].front();
      // claim the unassigned neighbor with the heaviest connecting edge
      int64_t got = -1, got_w = -1;
      for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
        int64_t v = g.col[e];
        if (part[v] < 0 && g.ew[e] > got_w) { got = v; got_w = g.ew[e]; }
      }
      if (got < 0) {
        front[p].pop_front();
        continue;
      }
      picked = got;
    }
    if (picked < 0) {
      while (scan < n && part[scan] >= 0) ++scan;
      if (scan >= n) break;
      picked = scan;
    }
    part[picked] = p;
    size[p] += g.vw[picked];
    ++assigned;
    front[p].push_back(picked);
  }
  for (int64_t i = 0; i < n; ++i)
    if (part[i] < 0) {
      int64_t p = 0;
      for (int64_t j = 1; j < k; ++j)
        if (size[j] < size[p]) p = j;
      part[i] = p;
      size[p] += g.vw[i];
    }
}

// Heavy-edge matching contraction; writes fine→coarse map into *cmap.
static WGraph pg_coarsen(const WGraph& g, std::vector<int64_t>* cmap,
                         uint64_t* rng) {
  const int64_t n = g.n();
  std::vector<int64_t> order(n), match(n, -1);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  for (int64_t i = n - 1; i > 0; --i)
    std::swap(order[i], order[pg_rng(rng) % (i + 1)]);
  int64_t nc = 0;
  cmap->assign(n, -1);
  for (int64_t oi = 0; oi < n; ++oi) {
    const int64_t u = order[oi];
    if (match[u] >= 0) continue;
    int64_t best = -1, best_w = -1;
    for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
      const int64_t v = g.col[e];
      if (v != u && match[v] < 0 && g.ew[e] > best_w) {
        best = v;
        best_w = g.ew[e];
      }
    }
    match[u] = (best >= 0) ? best : u;
    if (best >= 0) match[best] = u;
    (*cmap)[u] = nc;
    if (best >= 0) (*cmap)[best] = nc;
    ++nc;
  }
  // build coarse CSR by sorting (cu, cv, w) triples
  std::vector<std::pair<int64_t, int64_t>> key;  // (cu*nc+cv) packed
  std::vector<int64_t> wq;
  key.reserve(g.col.size());
  for (int64_t u = 0; u < n; ++u) {
    const int64_t cu = (*cmap)[u];
    for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
      const int64_t cv = (*cmap)[g.col[e]];
      if (cu == cv) continue;  // contracted edge disappears
      key.push_back({cu * nc + cv, g.ew[e]});
    }
  }
  std::sort(key.begin(), key.end());
  WGraph c;
  c.vw.assign(nc, 0);
  for (int64_t u = 0; u < n; ++u) c.vw[(*cmap)[u]] += g.vw[u];
  c.indptr.assign(nc + 1, 0);
  for (size_t i = 0; i < key.size(); ++i) {
    if (i == 0 || key[i].first != key[i - 1].first) {
      c.col.push_back(key[i].first % nc);
      c.ew.push_back(key[i].second);
      ++c.indptr[key[i].first / nc + 1];
    } else {
      c.ew.back() += key[i].second;
    }
  }
  for (int64_t i = 0; i < nc; ++i) c.indptr[i + 1] += c.indptr[i];
  return c;
}

int64_t partition_graph(const int64_t* indptr, const int64_t* col,
                        int64_t n, int64_t k, double slack,
                        int64_t passes, int64_t* out_part) {
  if (k <= 1 || n == 0) {
    for (int64_t i = 0; i < n; ++i) out_part[i] = 0;
    return 0;
  }
  // level 0 = input graph, unit weights
  std::vector<WGraph> levels(1);
  levels[0].indptr.assign(indptr, indptr + n + 1);
  levels[0].col.assign(col, col + indptr[n]);
  levels[0].ew.assign(indptr[n], 1);
  levels[0].vw.assign(n, 1);
  std::vector<std::vector<int64_t>> cmaps;
  uint64_t rng = 0x9E3779B97F4A7C15ULL;
  const int64_t coarse_target = std::max<int64_t>(64 * k, 256);
  while (levels.back().n() > coarse_target) {
    std::vector<int64_t> cmap;
    WGraph c = pg_coarsen(levels.back(), &cmap, &rng);
    if (c.n() > levels.back().n() * 95 / 100) break;  // stalled
    cmaps.push_back(std::move(cmap));
    levels.push_back(std::move(c));
  }
  // initial partition on the coarsest level
  std::vector<int64_t> part, size;
  pg_grow(levels.back(), k, &part, &size);
  pg_refine(levels.back(), k, slack, passes, &part, &size);
  // uncoarsen with refinement at every level
  for (int64_t lv = static_cast<int64_t>(cmaps.size()) - 1; lv >= 0; --lv) {
    const std::vector<int64_t>& cmap = cmaps[lv];
    std::vector<int64_t> fine(cmap.size());
    for (size_t u = 0; u < cmap.size(); ++u) fine[u] = part[cmap[u]];
    part = std::move(fine);
    size.assign(k, 0);
    for (int64_t u = 0; u < levels[lv].n(); ++u)
      size[part[u]] += levels[lv].vw[u];
    pg_refine(levels[lv], k, slack, lv == 0 ? passes : 2, &part, &size);
  }
  int64_t cut = 0;
  for (int64_t u = 0; u < n; ++u)
    for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e)
      cut += (part[u] != part[col[e]]);
  for (int64_t i = 0; i < n; ++i) out_part[i] = part[i];
  return cut;
}
}  // extern "C"
