// The loops of the exact cut and of ICM as CUDA graphs whose loop the card
// decides: conditional WHILE nodes (CUDA 12.3 and later), so a min cut, a
// BFS fixpoint or an ICM run is one graph launch with no read by the host
// inside it.
//
// Replace the lax.while_loops of phylo_hmrf_tpu/ops/maxflow_tpu.py::
// grid_mincut_fused (its blocks of 4 push-relabel iterations, the global
// relabel every 32 and the BFS fixpoint) and of phylo_hmrf_tpu/ops/
// icm_pallas.py::icm_pallas (its sweep pairs). The graphs are built once
// per card, shape (and for ICM, beta) by ops/loops.py, which keeps them
// with the buffers they read and launches them on PyTorch's stream.
//
// The programs, over the loop words of loops.cuh:
//   BFS fixpoint: begin (GO = 1, COUNT = 0, LIMIT = n), then WHILE {K6 of
//     8 sweeps d0 -> d1, K6 d1 -> d0, cond}: it goes on while a distance
//     changed and fewer than n sweeps ran; the distances end in d0.
//   Min cut: begin (the host wrote the pr word's GO, any active node, and
//     LIMIT, max_sweeps), then WHILE {relabel: seed d0 from cap_t, the BFS
//     fixpoint, h = max(h, d0); 8 K5 launches of 4 iterations A -> B ->
//     ... -> A; cond}, then seed, the BFS fixpoint: the source side is
//     d0 >= n. A period is 32 iterations, so the relabel falls exactly on
//     JAX's it % 32 == 0, and the pr word stops each K5 launch once no node
//     is active or max_sweeps iterations ran. The relabel's begin and max
//     also read the pr word, so a period that ran on a stopped loop would
//     change nothing (the WHILE node never starts one).
//   ICM: begin (GO = LIMIT > 0: the JAX loop's "changed" starts at 1),
//     then WHILE {K2 pair l0 -> l1, K2 l1 -> l0, cond}: pairs run while a
//     label changed and fewer than max_sweeps sweeps ran (an odd max_sweeps
//     is overshot by one sweep, as in JAX); the labels end in l0.
//   A unit loop: begin (as ICM's), then WHILE {unit, cond}: one captured
//     unit a body that ends by writing the word (the row-sharded ICM of
//     parallel/halo.py: a sweep pair or a sweep over a card's shards).
// The cond nodes (one thread) add to the graph's int64 counters what the
// loop did (iterations, sweeps, launches, loops stopped at their limit)
// and set the WHILE node's condition from the word. Bound: the kernels'
// own; each node adds a few microseconds of the card's launch latency and
// no host time.
//
// Each body unit is a kernel node (K2, K5, K6, the seed and height-max
// kernels below) or, where a graph is built with `units`, a child graph
// node: a unit of PyTorch tensor code that ops/loops.py captured
// (torch.cuda.CUDAGraph with keep_graph) on the same buffers and words,
// the plain versions of K2/K5/K6 in the operands' dtype (float64 in the
// strict-parity mode). Both kinds run the same program in the same node
// order; a plain graph counts its units at T_U* instead of T_K*.
#include "common.cuh"
#include "loops.cuh"

// the graph counters (int64), one set per graph
#define T_RUNS 0         // launches of the graph (min cuts, ICM runs)
#define T_PR_ITERS 1     // push-relabel iterations
#define T_BFS_SWEEPS 2   // BFS sweeps (relabels and final BFS)
#define T_CAPPED 3       // cuts stopped at max_sweeps with a node active
#define T_K5 4           // K5 launches (passed-through ones included)
#define T_K6 5           // K6 launches
#define T_K2 6           // K2 launches
#define T_ICM_SWEEPS 7   // ICM sweeps
#define T_ICM_CAPPED 8   // ICM runs stopped at max_sweeps with a change
#define T_U5 9           // captured plain K5 units (a plain graph's)
#define T_U6 10          // captured plain K6 units
#define T_U2 11          // captured plain K2 units
#define T_K8 12          // K8 launches (the row-sharded unit loop)
#define T_U8 13          // captured plain K8 units
#define T_WORDS 16

#define W_(loop, k) (loop)[PHMRF_LOOP_##k]

__global__ void cut_begin_kernel(int* pr, long long* tot,
                                 cudaGraphConditionalHandle h) {
  W_(pr, COUNT) = 0;
  W_(pr, SEEN) = 0;
  W_(pr, TICKET) = 0;
  W_(pr, LAST) = W_(pr, GO);
  const int go = W_(pr, GO) && 0 < W_(pr, LIMIT);
  W_(pr, GO) = go;
  tot[T_RUNS] += 1;
  if (!go && W_(pr, LAST)) tot[T_CAPPED] += 1;
  cudaGraphSetConditional(h, go);
}

__global__ void cut_cond_kernel(int* pr, long long* tot, int slot,
                                cudaGraphConditionalHandle h) {
  tot[slot] += 8;
  const int go = W_(pr, GO);
  if (!go) {
    tot[T_PR_ITERS] += W_(pr, COUNT);
    if (W_(pr, LAST)) tot[T_CAPPED] += 1;
  }
  cudaGraphSetConditional(h, go);
}

// gate: the pr word of the cut around a relabel (null: the final BFS)
__global__ void bfs_begin_kernel(int* bfs, const int* gate, int n,
                                 cudaGraphConditionalHandle h) {
  const int go = gate == nullptr || W_(gate, GO) != 0;
  W_(bfs, GO) = go;
  W_(bfs, SEEN) = 0;
  W_(bfs, TICKET) = 0;
  W_(bfs, COUNT) = 0;
  W_(bfs, LIMIT) = n;
  W_(bfs, LAST) = go;
  cudaGraphSetConditional(h, go);
}

__global__ void bfs_cond_kernel(int* bfs, long long* tot, int slot,
                                cudaGraphConditionalHandle h) {
  tot[slot] += 2;
  const int go = W_(bfs, GO);
  if (!go) tot[T_BFS_SWEEPS] += W_(bfs, COUNT);
  cudaGraphSetConditional(h, go);
}

__global__ void icm_begin_kernel(int* L, long long* tot,
                                 cudaGraphConditionalHandle h) {
  const int go = 0 < W_(L, LIMIT);
  W_(L, GO) = go;
  W_(L, SEEN) = 0;
  W_(L, TICKET) = 0;
  W_(L, COUNT) = 0;
  W_(L, LAST) = 1;
  tot[T_RUNS] += 1;
  cudaGraphSetConditional(h, go);
}

// slot, per_body: the counter of the body's launches and how many it
// makes
__global__ void icm_cond_kernel(int* L, long long* tot, int slot,
                                int per_body,
                                cudaGraphConditionalHandle h) {
  tot[slot] += per_body;
  const int go = W_(L, GO);
  if (!go) {
    tot[T_ICM_SWEEPS] += W_(L, COUNT);
    if (W_(L, LAST)) tot[T_ICM_CAPPED] += 1;
  }
  cudaGraphSetConditional(h, go);
}

// the BFS seed of the cut: 1 where the sink arc is residual, else n
__global__ void cut_seed_kernel(const float* __restrict__ cap_t,
                                int* __restrict__ d, long N, int n) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += (long)gridDim.x * blockDim.x)
    d[i] = cap_t[i] > PHMRF_CUT_EPS ? 1 : n;
}

// the relabel: heights are lower bounds of the residual distance, which
// can only lift them; nothing while the cut's loop has stopped
__global__ void cut_hmax_kernel(int* __restrict__ h,
                                const int* __restrict__ d, long N,
                                const int* pr) {
  if (!loop_runs(pr)) return;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += (long)gridDim.x * blockDim.x)
    h[i] = max(h[i], d[i]);
}

#define ELEMENTWISE_THREADS 256
#define ELEMENTWISE_BLOCKS 528   // 4 an SM of the H100

static cudaError_t add_one_thread(cudaGraph_t g, cudaGraphNode_t* last,
                                  const void* func, void** args) {
  return graph_append_kernel(g, last, func, dim3(1), dim3(1), 0, args);
}

static cudaError_t add_elementwise(cudaGraph_t g, cudaGraphNode_t* last,
                                   const void* func, long N, void** args) {
  const long need = (N + ELEMENTWISE_THREADS - 1) / ELEMENTWISE_THREADS;
  const int blocks = need < ELEMENTWISE_BLOCKS ? (int)need : ELEMENTWISE_BLOCKS;
  return graph_append_kernel(g, last, func, dim3(blocks > 0 ? blocks : 1),
                             dim3(ELEMENTWISE_THREADS), 0, args);
}

// A WHILE node behind *last whose condition is `h`; its body graph (owned
// by the node) in *body.
static cudaError_t add_while(cudaGraph_t g, cudaGraphNode_t* last,
                             cudaGraphConditionalHandle h, cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  const cudaError_t err = cudaGraphAddNode(
      &node, g, *last ? last : nullptr, nullptr, *last ? 1 : 0, &p);
#else
  const cudaError_t err =
      cudaGraphAddNode(&node, g, *last ? last : nullptr, *last ? 1 : 0, &p);
#endif
  if (err != cudaSuccess) return err;
  *body = p.conditional.phGraph_out[0];
  *last = node;
  return cudaSuccess;
}

#define CK(x)                                  \
  do {                                         \
    const cudaError_t err_ = (x);              \
    if (err_ != cudaSuccess) return err_;      \
  } while (0)

// A child graph node behind *last: a clone of `child` (a captured unit),
// which reads and writes memory by the addresses captured in it.
static cudaError_t add_child(cudaGraph_t g, cudaGraphNode_t* last,
                             void* child) {
  if (child == nullptr) return cudaErrorInvalidValue;
  cudaGraphNode_t node;
  CK(cudaGraphAddChildGraphNode(&node, g, *last ? last : nullptr,
                                *last ? 1 : 0, (cudaGraph_t)child));
  *last = node;
  return cudaSuccess;
}

// The BFS fixpoint behind *last in g: d0 -> d1 -> d0 in each body (K6
// launches, or the captured units units[0] = d0 -> d1, units[1] = d1 ->
// d0)
static cudaError_t add_bfs_loop(cudaGraph_t g, cudaGraphNode_t* last,
                                int* d0, int* d1, const float* caps, int R,
                                int H, int W, int n, int* bfs,
                                const int* gate, long long* tot,
                                void* const* units) {
  cudaGraphConditionalHandle h;
  CK(cudaGraphConditionalHandleCreate(&h, g, 0, 0));
  void* begin[] = {&bfs, &gate, &n, &h};
  CK(add_one_thread(g, last, (const void*)&bfs_begin_kernel, begin));
  cudaGraph_t body;
  CK(add_while(g, last, h, &body));
  cudaGraphNode_t b = nullptr;
  if (units) {
    CK(add_child(body, &b, units[0]));
    CK(add_child(body, &b, units[1]));
  } else {
    CK(phmrf_bfs_node(body, &b, d0, d1, caps, R, H, W, n, 8, bfs));
    CK(phmrf_bfs_node(body, &b, d1, d0, caps, R, H, W, n, 8, bfs));
  }
  int slot = units ? T_U6 : T_K6;
  void* cond[] = {&bfs, &tot, &slot, &h};
  return add_one_thread(body, &b, (const void*)&bfs_cond_kernel, cond);
}

static cudaError_t instantiate(cudaGraph_t g, void** exec) {
  cudaGraphExec_t e = nullptr;
  const cudaError_t err = cudaGraphInstantiate(&e, g, 0);
  cudaGraphDestroy(g);
  if (err != cudaSuccess) return err;
  *exec = (void*)e;
  return cudaSuccess;
}

// instantiate g (destroyed either way) unless building it failed
static int finish(cudaGraph_t g, cudaError_t err, void** exec) {
  if (err != cudaSuccess) {
    cudaGraphDestroy(g);
    return (int)err;
  }
  return (int)instantiate(g, exec);
}

// The BFS fixpoint from d0 (the seed) over caps; distances end in d0.
// units: null (K6), or the captured units d0 -> d1, d1 -> d0.
extern "C" int phmrf_graph_bfs(int* d0, int* d1, const float* caps, int R,
                               int H, int W, int n, int* bfs, long long* tot,
                               void* const* units, void** exec) {
  if (!units) CK(phmrf_prepare_mincut());
  cudaGraph_t g;
  CK(cudaGraphCreate(&g, 0));
  cudaGraphNode_t last = nullptr;
  return finish(g, add_bfs_loop(g, &last, d0, d1, caps, R, H, W, n, bfs,
                                nullptr, tot, units), exec);
}

// units (captured, or null: kernels): seed, BFS d0 -> d1, BFS d1 -> d0,
// height max, K5 A -> B, K5 B -> A
static cudaError_t build_cut(cudaGraph_t g, float* const* a, int* const* ai,
                             float* const* b, int* const* bi, int* d0,
                             int* d1, int R, int H, int W, int n, int* pr,
                             int* bfs, long long* tot, void* const* units) {
  // a = {e, cap_t, caps}, ai = {h} of the carry; b, bi the other set
  const long N = (long)R * H * W;
  cudaGraphConditionalHandle hc;
  CK(cudaGraphConditionalHandleCreate(&hc, g, 0, 0));
  cudaGraphNode_t last = nullptr;
  void* begin[] = {&pr, &tot, &hc};
  CK(add_one_thread(g, &last, (const void*)&cut_begin_kernel, begin));
  cudaGraph_t body;
  CK(add_while(g, &last, hc, &body));

  cudaGraphNode_t c = nullptr;
  float* ct = a[1];
  int* h = ai[0];
  void* seed[] = {&ct, &d0, const_cast<long*>(&N), &n};
  void* const* bfs_units = units ? units + 1 : nullptr;
  if (units)
    CK(add_child(body, &c, units[0]));
  else
    CK(add_elementwise(body, &c, (const void*)&cut_seed_kernel, N, seed));
  CK(add_bfs_loop(body, &c, d0, d1, a[2], R, H, W, n, bfs, pr, tot,
                  bfs_units));
  void* hmax[] = {&h, &d0, const_cast<long*>(&N), &pr};
  if (units)
    CK(add_child(body, &c, units[3]));
  else
    CK(add_elementwise(body, &c, (const void*)&cut_hmax_kernel, N, hmax));
  for (int k = 0; k < 8; ++k) {
    float* const* src = k % 2 ? b : a;
    float* const* dst = k % 2 ? a : b;
    int* const* srci = k % 2 ? bi : ai;
    int* const* dsti = k % 2 ? ai : bi;
    if (units)
      CK(add_child(body, &c, units[4 + k % 2]));
    else
      CK(phmrf_pr_node(body, &c, src[0], srci[0], src[1], src[2], dst[0],
                       dsti[0], dst[1], dst[2], R, H, W, n, 4, pr));
  }
  int slot = units ? T_U5 : T_K5;
  void* cond[] = {&pr, &tot, &slot, &hc};
  CK(add_one_thread(body, &c, (const void*)&cut_cond_kernel, cond));

  // the source side: the final BFS over the residual graph
  if (units)
    CK(add_child(g, &last, units[0]));
  else
    CK(add_elementwise(g, &last, (const void*)&cut_seed_kernel, N, seed));
  return add_bfs_loop(g, &last, d0, d1, a[2], R, H, W, n, bfs, nullptr,
                      tot, bfs_units);
}

// The min cut of the carry (e, h, cap_t, caps), which the caller filled
// (h = 0), with the other set (e2, h2, ct2, caps2) as the ping-pong's;
// the pr word holds GO (some e > eps) and LIMIT (max_sweeps). The
// distances of the final BFS end in d0. units: null (the kernels), or the
// six captured units of build_cut (then the data pointers go unused).
extern "C" int phmrf_graph_cut(float* e, int* h, float* cap_t, float* caps,
                               float* e2, int* h2, float* ct2, float* caps2,
                               int* d0, int* d1, int R, int H, int W, int n,
                               int* pr, int* bfs, long long* tot,
                               void* const* units, void** exec) {
  if (!units) CK(phmrf_prepare_mincut());
  cudaGraph_t g;
  CK(cudaGraphCreate(&g, 0));
  float* a[] = {e, cap_t, caps};
  int* ai[] = {h};
  float* b[] = {e2, ct2, caps2};
  int* bi[] = {h2};
  return finish(g, build_cut(g, a, ai, b, bi, d0, d1, R, H, W, n, pr, bfs,
                             tot, units), exec);
}

// begin, then WHILE {the body's units, cond}: `n_units` captured units a
// body (units non-null), or the two K2 pairs l0 -> l1 -> l0
static cudaError_t build_icm(cudaGraph_t g, int* l0, int* l1,
                             const float* unary, const float* w,
                             const int* mask, int R, int K, int H, int W,
                             float beta, int th, int tw, int threads,
                             int* loop, long long* tot, void* const* units,
                             int n_units, int slot, int per_body) {
  cudaGraphConditionalHandle h;
  CK(cudaGraphConditionalHandleCreate(&h, g, 0, 0));
  cudaGraphNode_t last = nullptr;
  void* begin[] = {&loop, &tot, &h};
  CK(add_one_thread(g, &last, (const void*)&icm_begin_kernel, begin));
  cudaGraph_t body;
  CK(add_while(g, &last, h, &body));
  cudaGraphNode_t b = nullptr;
  if (units) {
    for (int k = 0; k < n_units; ++k) CK(add_child(body, &b, units[k]));
  } else {
    CK(phmrf_icm_pair_node(body, &b, l0, l1, unary, w, mask, R, K, H, W,
                           beta, 0, th, tw, threads, loop));
    CK(phmrf_icm_pair_node(body, &b, l1, l0, unary, w, mask, R, K, H, W,
                           beta, 0, th, tw, threads, loop));
  }
  void* cond[] = {&loop, &tot, &slot, &per_body, &h};
  return add_one_thread(body, &b, (const void*)&icm_cond_kernel, cond);
}

// ICM from the labels in l0 (masked to 0 by the caller); the word's LIMIT
// is max_sweeps. The labels end in l0. units: null (K2), or the captured
// plain pairs l0 -> l1, l1 -> l0 (then only loop and tot are used).
extern "C" int phmrf_graph_icm(int* l0, int* l1, const float* unary,
                               const float* w, const int* mask, int R, int K,
                               int H, int W, float beta, int th, int tw,
                               int threads, int* loop, long long* tot,
                               void* const* units, void** exec) {
  if (!units) CK(phmrf_prepare_icm_pair(th, tw));
  cudaGraph_t g;
  CK(cudaGraphCreate(&g, 0));
  return finish(g, build_icm(g, l0, l1, unary, w, mask, R, K, H, W, beta,
                             th, tw, threads, loop, tot, units, 2,
                             units ? T_U2 : T_K2, 2), exec);
}

// A unit loop: begin, then WHILE {unit, cond} on the word `loop` (LIMIT
// written by the caller); the unit ends by updating the word. Its
// launches count `per_body` a body at counter `slot`.
extern "C" int phmrf_graph_unit_loop(void* unit, int* loop, long long* tot,
                                     int slot, int per_body, void** exec) {
  if (slot < 0 || slot >= T_WORDS) return (int)cudaErrorInvalidValue;
  cudaGraph_t g;
  CK(cudaGraphCreate(&g, 0));
  void* units[] = {unit};
  return finish(g, build_icm(g, nullptr, nullptr, nullptr, nullptr,
                             nullptr, 0, 0, 0, 0, 0.0f, 0, 0, 0, loop, tot,
                             units, 1, slot, per_body), exec);
}

extern "C" int phmrf_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

// An executable graph still running finishes first (CUDA frees it
// then).
extern "C" int phmrf_graph_destroy(void* exec) {
  return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}

// The CUDA driver's version (12030: 12.3, the first with conditional
// nodes).
extern "C" int phmrf_driver_version(int* version) {
  return (int)cudaDriverGetVersion(version);
}
