// The fused L-BFGS solve of the OU parameters: the kernel, its launch and
// the C entry macro (lbfgs.cu says what it computes, what bounds it and how
// it is laid out).
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxNodes = 16;    // caps of the tree (ops/lbfgs.py mirrors)
constexpr int kMaxLeaves = 8;
constexpr int kMaxPairs = kMaxLeaves * (kMaxLeaves - 1) / 2;
constexpr int kPad = 48;         // >= 3 * kMaxNodes - 1 parameters
constexpr int kMem = 10;         // L-BFGS memory
constexpr int kEtas = 10;        // line-search points
constexpr int kPatience = 5;     // steps without gain before a row stops
constexpr unsigned kFull = 0xffffffffu;

// ops/lbfgs.py::_LS_ETAS
__constant__ double kEtaValues[kEtas] = {4.0, 2.0,  1.0,   0.5,   0.25,
                                         0.1, 0.04, 0.015, 0.005, 0.001};

__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double m_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }

__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ bool is_nan(T v) { return v != v; }
template <typename T>
__device__ __forceinline__ bool is_finite(T v) { return m_abs(v) < T(INFINITY); }

// torch.clamp(v, min=lo): NaN propagates
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return is_nan(v) ? v : (v < lo ? lo : v);
}

template <typename T>
__device__ __forceinline__ T sigmoid(T z) {
  return T(1) / (T(1) + m_exp(-z));
}

template <typename T>
struct Problem {
  const T* p0;       // (B, P) start, box coordinates
  const T* w;        // (B,) posterior weight; null: 1 (the init)
  const T* obs;      // (B, F)
  const T* obs2;     // (B, F, F)
  const int* tree;   // parent[n], topo[n], leaf[F], mrca[Q], pair_of[F * F]
  const T* a2t;      // (n, Q)
  int n_nodes, n_leaves, n_pairs, n_iters;
  int grad_only;     // 1: f and d f / d p at p0 into f_out, p_out; no solve
  T n_samples, coef, min_covar, lo, span;
  T* p_out;          // (B, P) solved, box coordinates
  T* f_out;          // (B,)
  int* steps;        // (B,)
};

template <typename T>
struct Smem {
  T pc[kEtas][kPad];   // the line-search points, decoded
  T sg[kEtas][kPad];   // their sigmoids
  T pb[kEtas][kPad];   // d f / d p at each
  T fs[kEtas];
  T S[kMem][kPad], Y[kMem][kPad];
  T rho[kMem];
  int valid[kMem];
  T a2t[kMaxNodes][kMaxPairs];
  T obs[kMaxLeaves], obs2[kMaxLeaves][kMaxLeaves];
  int parent[kMaxNodes], topo[kMaxNodes], leaf[kMaxLeaves], mrca[kMaxPairs];
  int pair_of[kMaxLeaves][kMaxLeaves];
  int n_leaves;
};

// ou_nll_stats of one row at params p (the init's ou_nll_init is w = 1,
// n_samples = 1, coef = 0), and its gradient into pb. One thread. FC is the
// leaf count F when it is a compile-time constant (the loops over the F x F
// matrices unroll and the matrices live in registers), 0 for the one
// instantiation that serves the larger trees with F read at run time (the
// loops stay loops, the matrices go to local memory, and the build stays
// short).
template <typename T, int FC>
__device__ T ou_value_grad(const Smem<T>& s, int n, T w, T inv_n, T coef,
                           T mc, const T* p, T* pb) {
  constexpr int FA = FC ? FC : kMaxLeaves;   // the arrays' extent
  const int F = FC ? FC : s.n_leaves;
  const int P = 3 * n - 1, lam0 = n - 1, th0 = 2 * n - 1;
  const T floor_a = T(1e-7);   // models/ou.py::_ALPHA_FLOOR
  // the OU recursion over the tree (ou_moments)
  T ef[kMaxNodes], rt[kMaxNodes], mu[kMaxNodes], vr[kMaxNodes];
  mu[0] = p[th0];
  vr[0] = p[0];
  for (int k = 1; k < n; ++k) {
    const int node = s.topo[k], par = s.parent[node];
    const T a = p[node], lam = p[lam0 + node], th = p[th0 + node];
    const T e = m_exp(-a);
    const T r = a > floor_a ? lam / (T(2) * a) : T(0);
    ef[node] = e;
    rt[node] = r;
    mu[node] = mu[par] * e + th * (T(1) - e);
    const T ee = e * e;
    vr[node] = r * (T(1) - ee) + vr[par] * ee;
  }
  // leaf moments; V = cov + min_covar I (its lower triangle)
  T m[FA], V[FA][FA], X[FA][FA];
#pragma unroll
  for (int i = 0; i < F; ++i) {
    m[i] = mu[s.leaf[i]];
    V[i][i] = vr[s.leaf[i]] + mc;
#pragma unroll
    for (int j = 0; j < i; ++j) {
      const int q = s.pair_of[i][j];
      T s1 = T(0);
      for (int node = 1; node < n; ++node) s1 = s1 + p[node] * s.a2t[node][q];
      X[i][j] = m_exp(-s1);
      V[i][j] = vr[s.mrca[q]] * X[i][j];
    }
  }
  // Cholesky with clamped pivots (_chol_unrolled)
  T Lm[FA][FA], sd[FA];
  bool bad = false;
#pragma unroll
  for (int j = 0; j < F; ++j) {
    T t = V[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) t = t - Lm[j][k] * Lm[j][k];
    sd[j] = t;
    bad = bad || (t <= T(0));
    Lm[j][j] = m_sqrt(clamp_min(t, T(1e-30)));
#pragma unroll
    for (int i = j + 1; i < F; ++i) {
      T u = V[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) u = u - Lm[i][k] * Lm[j][k];
      Lm[i][j] = u / Lm[j][j];
    }
  }
  T dp[FA];
  dp[0] = Lm[0][0] * Lm[0][0];
#pragma unroll
  for (int j = 1; j < F; ++j) dp[j] = dp[j - 1] * (Lm[j][j] * Lm[j][j]);
  const T det = dp[F - 1];
  const T logdet = bad ? T(INFINITY) : m_log(det + T(1e-16));
  // tr(V^-1 Sn): Y = L^-1 Sn row by row, Z = L^-T Y (_logdet_trace_solve)
  T Yv[FA][FA], Zv[FA][FA];
#pragma unroll
  for (int i = 0; i < F; ++i) {
#pragma unroll
    for (int c = 0; c < F; ++c) {
      const T sn = ((s.obs2[i][c] - s.obs[i] * m[c]) - s.obs[c] * m[i]) +
                   w * (m[i] * m[c]);
      T t = sn;
#pragma unroll
      for (int k = 0; k < i; ++k) t = t - Lm[i][k] * Yv[k][c];
      Yv[i][c] = t / Lm[i][i];
    }
  }
  T trace = T(0);
#pragma unroll
  for (int i = F - 1; i >= 0; --i) {
#pragma unroll
    for (int c = 0; c < F; ++c) {
      T t = Yv[i][c];
#pragma unroll
      for (int k = i + 1; k < F; ++k) t = t - Lm[k][i] * Zv[k][c];
      Zv[i][c] = t / Lm[i][i];
    }
    trace = trace + Zv[i][i];
  }
  T sumsq = T(0);
  for (int j = 0; j < P; ++j) sumsq = sumsq + p[j] * p[j];
  const T f = (w * logdet) * inv_n + trace * inv_n + coef * sumsq;

  // ---- reverse mode ----
  for (int j = 0; j < P; ++j) pb[j] = T(0);
  T Lb[FA][FA];
#pragma unroll
  for (int i = 0; i < F; ++i)
#pragma unroll
    for (int j = 0; j < F; ++j) Lb[i][j] = T(0);
  // log(det + eps) where V is PD; zero through the +inf branch
  const T log_b = bad ? T(0) : inv_n * w;
  T Db = log_b / (det + T(1e-16));
#pragma unroll
  for (int j = F - 1; j >= 1; --j) {
    const T prev = Db * (Lm[j][j] * Lm[j][j]);
    const T qb = Db * dp[j - 1];
    Lb[j][j] = Lb[j][j] + (qb * Lm[j][j] + qb * Lm[j][j]);
    Db = prev;
  }
  Lb[0][0] = Lb[0][0] + (Db * Lm[0][0] + Db * Lm[0][0]);
  // Z = L^-T Y, then the trace (each Z[i][i] gets d f / d trace)
  T Zb[FA][FA], Yb[FA][FA];
#pragma unroll
  for (int i = 0; i < F; ++i)
#pragma unroll
    for (int c = 0; c < F; ++c) {
      Zb[i][c] = i == c ? inv_n : T(0);
      Yb[i][c] = T(0);
    }
#pragma unroll
  for (int i = 0; i < F; ++i) {
#pragma unroll
    for (int c = 0; c < F; ++c) {
      const T tb = Zb[i][c] / Lm[i][i];
      Lb[i][i] = Lb[i][i] - Zb[i][c] * Zv[i][c] / Lm[i][i];
      Yb[i][c] = Yb[i][c] + tb;
#pragma unroll
      for (int k = i + 1; k < F; ++k) {
        Lb[k][i] = Lb[k][i] - tb * Zv[k][c];
        Zb[k][c] = Zb[k][c] - tb * Lm[k][i];
      }
    }
  }
  // Y = L^-1 Sn; Sn's bar goes straight to the leaf means
  T mb[FA];
#pragma unroll
  for (int i = 0; i < F; ++i) mb[i] = T(0);
#pragma unroll
  for (int i = F - 1; i >= 0; --i) {
#pragma unroll
    for (int c = 0; c < F; ++c) {
      const T tb = Yb[i][c] / Lm[i][i];
      Lb[i][i] = Lb[i][i] - Yb[i][c] * Yv[i][c] / Lm[i][i];
#pragma unroll
      for (int k = 0; k < i; ++k) {
        Lb[i][k] = Lb[i][k] - tb * Yv[k][c];
        Yb[k][c] = Yb[k][c] - tb * Lm[i][k];
      }
      // Sn[i][c] = ((obs2 - obs_i m_c) - obs_c m_i) + w m_i m_c
      const T bw = tb * w;
      mb[c] = mb[c] - tb * s.obs[i] + bw * m[i];
      mb[i] = mb[i] - tb * s.obs[c] + bw * m[c];
    }
  }
  // the Cholesky, column by column from the last
  T Vb[FA][FA];
#pragma unroll
  for (int j = F - 1; j >= 0; --j) {
#pragma unroll
    for (int i = j + 1; i < F; ++i) {
      const T ub = Lb[i][j] / Lm[j][j];
      Lb[j][j] = Lb[j][j] - Lb[i][j] * Lm[i][j] / Lm[j][j];
      Vb[i][j] = ub;
#pragma unroll
      for (int k = 0; k < j; ++k) {
        Lb[i][k] = Lb[i][k] - ub * Lm[j][k];
        Lb[j][k] = Lb[j][k] - ub * Lm[i][k];
      }
    }
    // sqrt of the clamped pivot: zero below the clamp
    const T sb = sd[j] >= T(1e-30) ? Lb[j][j] / (T(2) * Lm[j][j]) : T(0);
    Vb[j][j] = sb;
#pragma unroll
    for (int k = 0; k < j; ++k)
      Lb[j][k] = Lb[j][k] - (sb * Lm[j][k] + sb * Lm[j][k]);
  }
  // V -> the nodes' variances, the alphas below each pair's mrca
  T mub[kMaxNodes], vrb[kMaxNodes];
  for (int k = 0; k < n; ++k) mub[k] = vrb[k] = T(0);
#pragma unroll
  for (int i = 0; i < F; ++i) {
    mub[s.leaf[i]] = mub[s.leaf[i]] + mb[i];
    vrb[s.leaf[i]] = vrb[s.leaf[i]] + Vb[i][i];
#pragma unroll
    for (int j = 0; j < i; ++j) {
      const int q = s.pair_of[i][j], a = s.mrca[q];
      vrb[a] = vrb[a] + Vb[i][j] * X[i][j];
      const T s1b = -((Vb[i][j] * vr[a]) * X[i][j]);
      for (int node = 1; node < n; ++node)
        pb[node] = pb[node] + s1b * s.a2t[node][q];
    }
  }
  // the recursion, children before parents
  for (int k = n - 1; k >= 1; --k) {
    const int node = s.topo[k], par = s.parent[node];
    const T a = p[node], lam = p[lam0 + node], th = p[th0 + node];
    const T e = ef[node], ee = e * e, r = rt[node];
    const T vb = vrb[node], mbn = mub[node];
    const T rb = vb * (T(1) - ee);
    const T eeb = vb * vr[par] - vb * r;
    vrb[par] = vrb[par] + vb * ee;
    mub[par] = mub[par] + mbn * e;
    const T eb = (mbn * mu[par] - mbn * th) + (eeb * e + eeb * e);
    T ab = pb[node] - eb * e;
    // where(alpha > floor, lam / (2 alpha), 0): autograd's formulas with
    // the branch's gradient, 0 where it is not taken
    const T gr = a > floor_a ? rb : T(0);
    const T dd = T(2) * a;
    ab = ab + (-gr * lam / (dd * dd)) * T(2);
    pb[node] = ab;
    pb[lam0 + node] = gr / dd;
    pb[th0 + node] = mbn * (T(1) - e);
  }
  pb[th0] = mub[0];
  pb[0] = vrb[0];
  for (int j = 0; j < P; ++j) pb[j] = pb[j] + (coef * p[j] + coef * p[j]);
  return f;
}

// the sum over the warp of each lane's two coordinates' products
template <typename T>
__device__ __forceinline__ T warp_dot(const T (&a)[2], const T (&b)[2],
                                      const bool (&in)[2]) {
  T v = in[0] ? a[0] * b[0] : T(0);
  if (in[1]) v = v + a[1] * b[1];
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v = v + __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ void load_row(Smem<T>& s, const Problem<T>& pr,
                                         int F, int row, int lane) {
  const int n = pr.n_nodes, Q = pr.n_pairs;
  const int* t = pr.tree;
  for (int i = lane; i < n; i += 32) {
    s.parent[i] = t[i];
    s.topo[i] = t[n + i];
  }
  for (int i = lane; i < F; i += 32) s.leaf[i] = t[2 * n + i];
  for (int i = lane; i < Q; i += 32) s.mrca[i] = t[2 * n + F + i];
  for (int i = lane; i < F * F; i += 32)
    s.pair_of[i / F][i % F] = t[2 * n + F + Q + i];
  for (int i = lane; i < n * Q; i += 32) s.a2t[i / Q][i % Q] = pr.a2t[i];
  for (int i = lane; i < F; i += 32) s.obs[i] = pr.obs[(long)row * F + i];
  for (int i = lane; i < F * F; i += 32)
    s.obs2[i / F][i % F] = pr.obs2[(long)row * F * F + i];
  if (lane == 0) s.n_leaves = F;
}

template <typename T, int FC>
__global__ void __launch_bounds__(32)
    lbfgs_ou_kernel(const Problem<T> pr) {
  __shared__ Smem<T> s;
  const int row = blockIdx.x, lane = threadIdx.x;
  const int n = pr.n_nodes, P = 3 * n - 1;
  load_row(s, pr, pr.n_leaves, row, lane);
  const T w = pr.w ? pr.w[row] : T(1);
  const T inv_n = T(1) / pr.n_samples, inv_span = T(1) / pr.span;
  const T lo = pr.lo, span = pr.span;
  if (pr.grad_only) {   // the objective at each row's p0, for the tests
    for (int j = lane; j < P; j += 32) s.pc[0][j] = pr.p0[(long)row * P + j];
    __syncwarp();
    if (lane == 0)
      pr.f_out[row] = ou_value_grad<T, FC>(s, n, w, inv_n, pr.coef,
                                           pr.min_covar, s.pc[0], s.pb[0]);
    __syncwarp();
    for (int j = lane; j < P; j += 32)
      pr.p_out[(long)row * P + j] = s.pb[0][j];
    return;
  }
  int c[2];
  bool in[2];
  T x[2], g[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    c[k] = lane + 32 * k;
    in[k] = c[k] < P;
    for (int i = 0; i < kMem; ++i)
      if (c[k] < kPad) s.S[i][c[k]] = s.Y[i][c[k]] = T(0);
    // box_encode
    x[k] = T(0);
    if (in[k]) {
      T t = (pr.p0[(long)row * P + c[k]] - lo) * inv_span;
      const T t_lo = T(1e-6), t_hi = T(1.0 - 1e-6);
      if (!is_nan(t)) t = t < t_lo ? t_lo : (t > t_hi ? t_hi : t);
      x[k] = m_log(t) - m_log1p(-t);
      const T sig = sigmoid(x[k]);
      s.sg[0][c[k]] = sig;
      s.pc[0][c[k]] = lo + span * sig;
    }
  }
  if (lane < kMem) {
    s.rho[lane] = T(0);
    s.valid[lane] = 0;
  }
  __syncwarp();
  // f and g at x0 (lbfgs_init)
  if (lane == 0)
    s.fs[0] = ou_value_grad<T, FC>(s, n, w, inv_n, pr.coef, pr.min_covar,
                                  s.pc[0], s.pb[0]);
  __syncwarp();
  T f = s.fs[0];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    g[k] = in[k] ? s.pb[0][c[k]] * span * (T(1) - s.sg[0][c[k]]) *
                       s.sg[0][c[k]]
                 : T(0);
  int head = 0;   // the ring's oldest slot; logical slot i is (head + i) % M
  int stall = 0, steps = 0;
  for (int it = 1; it <= pr.n_iters; ++it) {
    // the two-loop recursion
    T q[2] = {g[0], g[1]}, al[kMem];
#pragma unroll
    for (int i = kMem - 1; i >= 0; --i) {
      const int ph = (head + i) % kMem;
      const T srow[2] = {s.S[ph][c[0]], in[1] ? s.S[ph][c[1]] : T(0)};
      const T v = s.valid[ph] ? T(1) : T(0);
      const T a = s.rho[ph] * warp_dot(srow, q, in) * v;
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (in[k]) q[k] = q[k] - a * s.Y[ph][c[k]];
      al[i] = a;
    }
    const int nw = (head + kMem - 1) % kMem;
    const T snw[2] = {s.S[nw][c[0]], in[1] ? s.S[nw][c[1]] : T(0)};
    const T ynw[2] = {s.Y[nw][c[0]], in[1] ? s.Y[nw][c[1]] : T(0)};
    const T sy0 = warp_dot(snw, ynw, in), yy0 = warp_dot(ynw, ynw, in);
    const T gamma = s.valid[nw] ? sy0 / clamp_min(yy0, T(1e-20)) : T(1);
    T r[2] = {gamma * q[0], gamma * q[1]};
#pragma unroll
    for (int i = 0; i < kMem; ++i) {
      const int ph = (head + i) % kMem;
      const T yrow[2] = {s.Y[ph][c[0]], in[1] ? s.Y[ph][c[1]] : T(0)};
      const T v = s.valid[ph] ? T(1) : T(0);
      const T b = s.rho[ph] * warp_dot(yrow, r, in) * v;
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (in[k]) r[k] = r[k] + (al[i] - b) * s.S[ph][c[k]];
    }
    T d[2] = {-r[0], -r[1]};
    // steepest descent where d is not a finite descent direction
    const bool fin = __all_sync(kFull, (!in[0] || is_finite(d[0])) &&
                                           (!in[1] || is_finite(d[1])));
    const T dg = warp_dot(d, g, in);
    if (!(dg < T(0) && fin)) {
      d[0] = -g[0];
      d[1] = -g[1];
    }
    // the line search: every point's value and gradient at once
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (!in[k]) continue;
      for (int e = 0; e < kEtas; ++e) {
        const T z = x[k] + T(kEtaValues[e]) * d[k];
        const T sig = sigmoid(z);
        s.sg[e][c[k]] = sig;
        s.pc[e][c[k]] = lo + span * sig;
      }
    }
    __syncwarp();
    if (lane < kEtas) {
      const T fe = ou_value_grad<T, FC>(s, n, w, inv_n, pr.coef, pr.min_covar,
                                       s.pc[lane], s.pb[lane]);
      s.fs[lane] = is_finite(fe) ? fe : T(INFINITY);
    }
    __syncwarp();
    int best = 0;
    T f_try = s.fs[0];
    for (int e = 1; e < kEtas; ++e)
      if (s.fs[e] < f_try) {
        best = e;
        f_try = s.fs[e];
      }
    const bool improved = f_try < f;
    T xn[2] = {x[0], x[1]}, gn[2] = {g[0], g[1]};
    if (improved) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (!in[k]) continue;
        xn[k] = x[k] + T(kEtaValues[best]) * d[k];
        const T sig = s.sg[best][c[k]];
        const T gz = s.pb[best][c[k]] * span * (T(1) - sig) * sig;
        gn[k] = is_finite(gz) ? gz : g[k];
      }
    }
    const T f_new = improved ? f_try : f;
    const T sv[2] = {xn[0] - x[0], xn[1] - x[1]};
    const T yv[2] = {gn[0] - g[0], gn[1] - g[1]};
    const T sy = warp_dot(sv, yv, in);
    if (improved && sy > T(1e-12)) {
      // push: the oldest slot takes the newest pair
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (in[k]) {
          s.S[head][c[k]] = sv[k];
          s.Y[head][c[k]] = yv[k];
        }
      if (lane == 0) {
        s.rho[head] = T(1) / clamp_min(sy, T(1e-20));
        s.valid[head] = 1;
      }
      head = (head + 1) % kMem;
    }
    const bool gain =
        (f - f_new) > T(1e-7) * clamp_min(m_abs(f_new), T(1));
    stall = gain ? 0 : stall + 1;
    x[0] = xn[0];
    x[1] = xn[1];
    g[0] = gn[0];
    g[1] = gn[1];
    f = f_new;
    steps = it;
    __syncwarp();
    if (stall >= kPatience) break;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (in[k]) pr.p_out[(long)row * P + c[k]] = lo + span * sigmoid(x[k]);
  if (lane == 0) {
    pr.f_out[row] = f;
    pr.steps[row] = steps;
  }
}

template <typename T>
int launch(const Problem<T>& pr, int B, cudaStream_t st) {
  const int F = pr.n_leaves;
  if (B < 1 || pr.n_nodes < 2 || pr.n_nodes > kMaxNodes || F < 2 ||
      F > kMaxLeaves || pr.n_pairs != F * (F - 1) / 2)
    return (int)cudaErrorInvalidValue;
  // four leaves (the reference's tree, every configuration run) unrolled;
  // any other count reads F at run time
  if (F == 4)
    lbfgs_ou_kernel<T, 4><<<B, 32, 0, st>>>(pr);
  else
    lbfgs_ou_kernel<T, 0><<<B, 32, 0, st>>>(pr);
  return (int)cudaGetLastError();
}

}  // namespace

// The solve (grad_only 0): p0 (B, P) -> p_out (B, P), f_out (B,), steps
// (B,). grad_only 1: the objective's value (f_out) and gradient (p_out) at
// p0, steps unused. w null: the init's objective (weight 1).
#define PHMRF_LBFGS_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const T* p0, const T* w, const T* obs, const T* obs2, \
                      const int* tree, const T* a2t, int B, int n_nodes,     \
                      int n_leaves, int n_pairs, int n_iters, T n_samples,   \
                      T coef, T min_covar, T lo, T span, T* p_out, T* f_out, \
                      int* steps, int grad_only, void* stream) {             \
    const Problem<T> pr{p0,      w,         obs,      obs2,      tree,     \
                        a2t,     n_nodes,   n_leaves, n_pairs,   n_iters,  \
                        grad_only, n_samples, coef,   min_covar, lo,       \
                        span,    p_out,     f_out,    steps};                \
    return launch<T>(pr, B, (cudaStream_t)stream);                           \
  }

