// Exact weighted-Potts MRF optimizer: alpha-beta swap over s-t min-cut.
//
// TPU-native replacement role: the reference vendors GCO v3.0
// (gco_source/maxflow.cpp, GCoptimization.cpp) and drives it through pygco
// (reference phylo_hmrf.py:496). Here the production E-step runs on TPU
// (ops/icm.py); this module is the host-side *exact* oracle used to gate the
// TPU labeler's energy parity in tests, and as an optional CPU backend
// (labeler="swap"). It is a from-scratch implementation: Dinic's blocking-flow
// max-flow (not BK trees) in double precision (no pygco-style int scaling).
//
// C ABI only; loaded via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

// Dinic max-flow with arc arrays. Nodes: 0..n-1 plus source=n, sink=n+1.
class Dinic {
 public:
  explicit Dinic(int n) : n_(n + 2), head_(n + 2, -1), level_(n + 2),
                          iter_(n + 2) {}

  int source() const { return n_ - 2; }
  int sink() const { return n_ - 1; }

  void add_edge(int u, int v, double cap, double rcap) {
    to_.push_back(v); nxt_.push_back(head_[u]); cap_.push_back(cap);
    head_[u] = static_cast<int>(to_.size()) - 1;
    to_.push_back(u); nxt_.push_back(head_[v]); cap_.push_back(rcap);
    head_[v] = static_cast<int>(to_.size()) - 1;
  }

  double max_flow() {
    double flow = 0.0;
    while (bfs()) {
      std::copy(head_.begin(), head_.end(), iter_.begin());
      double f;
      while ((f = dfs(source(), kInf)) > kEps) flow += f;
    }
    return flow;
  }

  // After max_flow: true if u is on the source side of the min cut.
  bool source_side(int u) const { return level_[u] >= 0; }

 private:
  static constexpr double kInf = 1e300;
  static constexpr double kEps = 1e-12;

  bool bfs() {
    std::fill(level_.begin(), level_.end(), -1);
    std::queue<int> q;
    level_[source()] = 0;
    q.push(source());
    while (!q.empty()) {
      int u = q.front(); q.pop();
      for (int e = head_[u]; e != -1; e = nxt_[e]) {
        if (cap_[e] > kEps && level_[to_[e]] < 0) {
          level_[to_[e]] = level_[u] + 1;
          q.push(to_[e]);
        }
      }
    }
    return level_[sink()] >= 0;
  }

  double dfs(int u, double f) {
    if (u == sink()) return f;
    for (int& e = iter_[u]; e != -1; e = nxt_[e]) {
      int v = to_[e];
      if (cap_[e] > kEps && level_[v] == level_[u] + 1) {
        double d = dfs(v, std::min(f, cap_[e]));
        if (d > kEps) {
          cap_[e] -= d;
          cap_[e ^ 1] += d;
          return d;
        }
      }
    }
    return 0.0;
  }

  int n_;
  std::vector<int> head_, to_, nxt_;
  std::vector<double> cap_;
  std::vector<int> level_, iter_;
};

double potts_energy_impl(int64_t n, int64_t ne, const int64_t* edges,
                         const double* w, const double* unary, int32_t k,
                         double beta, const int32_t* labels) {
  double e = 0.0;
  for (int64_t i = 0; i < n; ++i) e += unary[i * k + labels[i]];
  for (int64_t t = 0; t < ne; ++t) {
    if (labels[edges[2 * t]] != labels[edges[2 * t + 1]]) e += beta * w[t];
  }
  return e;
}

}  // namespace

extern "C" {

double phmrf_potts_energy(int64_t n_nodes, int64_t n_edges,
                          const int64_t* edges, const double* weights,
                          const double* unary, int32_t n_labels, double beta,
                          const int32_t* labels) {
  return potts_energy_impl(n_nodes, n_edges, edges, weights, unary, n_labels,
                           beta, labels);
}

// Alpha-beta swap. labels is in-out. Returns the number of full cycles run.
int32_t phmrf_potts_swap(int64_t n_nodes, int64_t n_edges,
                         const int64_t* edges, const double* weights,
                         const double* unary, int32_t n_labels, double beta,
                         int32_t max_cycles, int32_t* labels) {
  // incident edge index per node
  std::vector<int32_t> deg(n_nodes, 0);
  for (int64_t t = 0; t < n_edges; ++t) {
    ++deg[edges[2 * t]];
    ++deg[edges[2 * t + 1]];
  }
  std::vector<int64_t> off(n_nodes + 1, 0);
  for (int64_t i = 0; i < n_nodes; ++i) off[i + 1] = off[i] + deg[i];
  std::vector<int64_t> inc(off[n_nodes]);
  {
    std::vector<int64_t> cur(off.begin(), off.end() - 1);
    for (int64_t t = 0; t < n_edges; ++t) {
      inc[cur[edges[2 * t]]++] = t;
      inc[cur[edges[2 * t + 1]]++] = t;
    }
  }

  std::vector<int64_t> node_of(n_nodes, -1);   // node -> subproblem index
  std::vector<int64_t> members;
  members.reserve(n_nodes);

  int32_t cycle = 0;
  for (; cycle < max_cycles; ++cycle) {
    int64_t changed = 0;
    for (int32_t a = 0; a < n_labels; ++a) {
      for (int32_t b = a + 1; b < n_labels; ++b) {
        members.clear();
        for (int64_t i = 0; i < n_nodes; ++i) {
          if (labels[i] == a || labels[i] == b) {
            node_of[i] = static_cast<int64_t>(members.size());
            members.push_back(i);
          }
        }
        if (members.empty()) continue;

        const int m = static_cast<int>(members.size());
        // t-link costs: c0 = cost of taking label a, c1 = label b
        std::vector<double> c0(m), c1(m);
        for (int p = 0; p < m; ++p) {
          int64_t i = members[p];
          c0[p] = unary[i * n_labels + a];
          c1[p] = unary[i * n_labels + b];
        }
        Dinic g(m);
        // pairwise terms
        for (int p = 0; p < m; ++p) {
          int64_t i = members[p];
          for (int64_t q = off[i]; q < off[i + 1]; ++q) {
            int64_t t = inc[q];
            int64_t u = edges[2 * t], v = edges[2 * t + 1];
            int64_t j = (u == i) ? v : u;
            double lam = beta * weights[t];
            if (labels[j] == a || labels[j] == b) {
              // both endpoints movable: Potts arc; add once (from u side)
              if (u == i) g.add_edge(p, static_cast<int>(node_of[j]),
                                     lam, lam);
            } else {
              // fixed neighbor: shifts the t-links
              if (labels[j] != a) c0[p] += lam;
              if (labels[j] != b) c1[p] += lam;
            }
          }
        }
        for (int p = 0; p < m; ++p) {
          double d = c1[p] - c0[p];
          if (d > 0) g.add_edge(g.source(), p, d, 0.0);
          else if (d < 0) g.add_edge(p, g.sink(), -d, 0.0);
        }
        g.max_flow();
        for (int p = 0; p < m; ++p) {
          // src->p (cap c1-c0) is cut iff p lands on the sink side, which
          // therefore pays c1: sink side = label b, source side = label a.
          int32_t nl = g.source_side(p) ? a : b;
          int64_t i = members[p];
          if (labels[i] != nl) {
            labels[i] = nl;
            ++changed;
          }
        }
      }
    }
    if (changed == 0) break;
  }
  return cycle;
}

// Alpha-expansion (the reference ships it alongside swap:
// gco_source/GCoptimization.cpp:965-1199; swap is the one its driver uses).
// Every node not already labeled alpha may switch to alpha; one binary
// min-cut per label per cycle. For the weighted-Potts pairwise the move
// energy is submodular, so the Kolmogorov-Zabih reduction applies directly:
// edge (u,v), lam = beta*w, table over (x_u, x_v) with x=1 meaning "take
// alpha": A=lam*[l_u!=l_v], B=lam*[l_u!=a]=lam, C=lam*[a!=l_v]=lam, D=0
// (both movable => labels differ from alpha). Decomposition: c1_u += C-A,
// c1_v += D-C, directed arc u->v with capacity B+C-A-D >= 0 (paid when u
// keeps and v expands). Frozen alpha neighbors shift c0 by lam.
// labels is in-out. Returns the number of full cycles run.
int32_t phmrf_potts_expansion(int64_t n_nodes, int64_t n_edges,
                              const int64_t* edges, const double* weights,
                              const double* unary, int32_t n_labels,
                              double beta, int32_t max_cycles,
                              int32_t* labels) {
  std::vector<int64_t> node_of(n_nodes, -1);
  std::vector<int64_t> members;
  members.reserve(n_nodes);

  int32_t cycle = 0;
  for (; cycle < max_cycles; ++cycle) {
    int64_t changed = 0;
    for (int32_t a = 0; a < n_labels; ++a) {
      members.clear();
      for (int64_t i = 0; i < n_nodes; ++i) {
        if (labels[i] != a) {
          node_of[i] = static_cast<int64_t>(members.size());
          members.push_back(i);
        }
      }
      if (members.empty()) continue;

      const int m = static_cast<int>(members.size());
      // c0 = cost of keeping the current label, c1 = cost of taking alpha
      std::vector<double> c0(m), c1(m);
      for (int p = 0; p < m; ++p) {
        int64_t i = members[p];
        c0[p] = unary[i * n_labels + labels[i]];
        c1[p] = unary[i * n_labels + a];
      }
      Dinic g(m);
      for (int64_t t = 0; t < n_edges; ++t) {
        int64_t u = edges[2 * t], v = edges[2 * t + 1];
        double lam = beta * weights[t];
        bool mu = labels[u] != a, mv = labels[v] != a;
        if (mu && mv) {
          int pu = static_cast<int>(node_of[u]);
          int pv = static_cast<int>(node_of[v]);
          double A = (labels[u] != labels[v]) ? lam : 0.0;
          c1[pu] += lam - A;     // C - A
          c1[pv] -= lam;         // D - C
          g.add_edge(pu, pv, 2.0 * lam - A, 0.0);  // B + C - A - D
        } else if (mu) {         // v frozen at alpha: u pays lam for keeping
          c0[node_of[u]] += lam;
        } else if (mv) {         // u frozen at alpha
          c0[node_of[v]] += lam;
        }                        // both alpha: constant
      }
      for (int p = 0; p < m; ++p) {
        double d = c1[p] - c0[p];
        if (d > 0) g.add_edge(g.source(), p, d, 0.0);
        else if (d < 0) g.add_edge(p, g.sink(), -d, 0.0);
      }
      g.max_flow();
      for (int p = 0; p < m; ++p) {
        // source side keeps its label; sink side expands to alpha
        if (!g.source_side(p)) {
          labels[members[p]] = a;
          ++changed;
        }
      }
    }
    if (changed == 0) break;
  }
  return cycle;
}

}  // extern "C"
