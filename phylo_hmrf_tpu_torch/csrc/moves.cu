// M1 (build) and M2 (apply) of the exact moves: one alpha-beta swap or
// alpha-expansion move's cut graph built in one launch, straight into the
// carry of the min-cut graph (loops.cu), and the move's labels written
// from the cut in a second launch.
//
// Replace no TPU kernel: the JAX package builds a move's graph and its
// labels in XLA (phylo_hmrf_tpu/ops/maxflow_tpu.py::_swap_graph,
// _expansion_graph and _swap_move_batch / _expansion_move_batch, inside
// its move loop). Their plain versions here are the tensor code of
// ops/maxflow.py::_swap_graph / _expansion_graph and the label update of
// _swap_move_batch / _expansion_move_batch: on the card that tensor code is
// ~180 (swap) or ~218 (expansion) launches of PyTorch's elementwise kernels
// a move, and the copies into the cut graph's buffers another ~10, which
// the host has to issue one by one while the card waits (ops/maxflow.py::
// _optimize_batched; the float32 kernel route takes M1 and M2, the CPU, the
// host loop and the float64 plain mode keep the tensor code).
//
// Layouts (contiguous): labels (R, H, W) int32; unary (R, K, H, W) and
// w (R, 4, H, W) float32 (w: DIRS, the weight of the edge p -> p + DIRS[d]
// at p, 0 on edges that leave the grid or touch an invalid pixel); mask and
// in_play (R, H, W) bool (one byte); wsum (R, H, W) float32, beta times the
// incident weight of each pixel (the pass's dominance bound); the carry e,
// cap_t (R, H, W) float32, h (R, H, W) int32, caps (R, 8, H, W) float32 with
// the arc directions of mincut.cu (ALL_DIRS: DIRS, then their reversals).
//
// M1, one thread a pixel: the pixel's in-play test and those of its 8
// neighbours (recomputed from labels, the two unary planes and wsum, all in
// L1), then its t-link costs c0 / c1, summed term by term in the tensor
// code's order with round-to-nearest intrinsics (no FMA contraction), a
// zero added where the tensor code adds where(..., 0.0) so that even the
// signs of zero agree; excess0 = clamp_min(c1 - c0, 0), cap_t0 =
// clamp_min(c0 - c1, 0) as PyTorch's clamp (NaN kept, then max); h = 0;
// the 8 arc planes. So M1 is bitwise _swap_graph / _expansion_graph. It
// also writes the cut's first loop test into the pr word, as
// loops.CutGraph.run does from the host: every block ORs SEEN where some
// pixel has excess0 > eps, and the last block (a ticket, reset by it) sets
// GO = SEEN and LIMIT = max_sweeps and puts SEEN back to 0 (the word rests
// with SEEN and TICKET at 0 between cuts: loops.cuh).
//
// M2, one thread a pixel: in play, the source side of the cut (distance of
// the final BFS >= n) keeps a (swap) or its label (expansion), the sink
// side takes b or alpha; elsewhere the label stays. Each block adds its
// count of changed pixels (__syncthreads_count) into the region's counter
// of the move with one integer atomic: exact in any order.
//
// Bound: memory. M1 reads labels, mask, wsum, two unary planes and the 4
// weight planes and writes e, h, cap_t, in_play and the 8 arc planes: 78
// bytes a pixel, 40 MB at chr21's 672 x 768, 12 us at 3.35 TB/s; the
// neighbours' reads hit L1 / L2. M2 reads d, in_play and labels and writes
// the changed labels: ~9 bytes a pixel, 2 us.
#include "common.cuh"
#include "loops.cuh"

#define MOVE_THREADS 256

namespace {

// One region's operands; i is a pixel's index in the (H, W) plane.
struct Region {
  const int* lab;
  const float* u;              // (K, H, W)
  const unsigned char* mask;
  const float* wsum;
  long HW;
};

// alpha-beta swap: the pixel carries a or b, is valid, and is not
// dominance-frozen (its unary margin for its label strictly beats wsum)
__device__ __forceinline__ bool swap_in_play(const Region& g, long i, int a,
                                             int b) {
  const int l = g.lab[i];
  if (!g.mask[i] || (l != a && l != b)) return false;
  const float ua = g.u[a * g.HW + i], ub = g.u[b * g.HW + i];
  if (l == a) return !(__fsub_rn(ub, ua) > g.wsum[i]);
  return !(__fsub_rn(ua, ub) > g.wsum[i]);
}

// alpha-expansion: the pixel's label (-1 outside the grid) and its part in
// the move: at alpha, in the cut, or valid and frozen at its own label
struct ExpPix {
  int l;
  bool alpha, play, frozen;
};

__device__ __forceinline__ ExpPix exp_pix(const Region& g, long i,
                                          int alpha) {
  ExpPix p;
  p.l = g.lab[i];
  const bool valid = g.mask[i] != 0;
  p.alpha = valid && p.l == alpha;
  const bool movable = valid && p.l != alpha;
  p.play = movable && !(__fsub_rn(g.u[alpha * g.HW + i],
                                  g.u[p.l * g.HW + i]) > g.wsum[i]);
  p.frozen = movable && !p.play;
  return p;
}

// PyTorch's clamp_min(v, 0) on the card: NaN passes, else max(v, 0)
__device__ __forceinline__ float clamp0(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

__device__ __forceinline__ float when(bool c, float v) {
  return c ? v : 0.0f;
}

// The carry of the pixel's cut graph; returns excess0 > eps.
__device__ __forceinline__ bool write_pixel(float c0, float c1, bool play,
                                            const float* cap, long j,
                                            long r, long i, long HW,
                                            float* e, int* h, float* cap_t,
                                            float* caps,
                                            unsigned char* in_play) {
  const float diff = when(play, __fsub_rn(c1, c0));
  const float ex = clamp0(diff);
  e[j] = ex;
  h[j] = 0;
  cap_t[j] = clamp0(-diff);
#pragma unroll
  for (int k = 0; k < 8; ++k) caps[(r * 8 + k) * HW + i] = cap[k];
  in_play[j] = play;
  return ex > PHMRF_CUT_EPS;
}

// The pr word's first test and limit (what loops.CutGraph.run writes from
// the host); every thread of every block calls it.
__device__ __forceinline__ void first_test(int* pr, bool mine, int limit) {
  const int any = __syncthreads_or(mine);
  if (threadIdx.x != 0) return;
  if (any) atomicExch(pr + PHMRF_LOOP_SEEN, 1);
  __threadfence();
  const unsigned blocks = gridDim.x * gridDim.y * gridDim.z;
  if (atomicAdd((unsigned*)(pr + PHMRF_LOOP_TICKET), 1u) != blocks - 1)
    return;
  __threadfence();   // the last block: every other block's SEEN is in
  volatile int* v = pr;
  v[PHMRF_LOOP_GO] = v[PHMRF_LOOP_SEEN] != 0;
  v[PHMRF_LOOP_LIMIT] = limit;
  v[PHMRF_LOOP_SEEN] = 0;
  v[PHMRF_LOOP_TICKET] = 0;
}

// _swap_graph: source side = label a. t-links c0 = cost(a), c1 = cost(b)
// with the frozen neighbours (labels not in {a, b}, or dominance-frozen)
// folded in, forward neighbour then backward one a direction; undirected
// Potts arcs beta * w between in-play neighbours.
__global__ void __launch_bounds__(MOVE_THREADS)
    swap_build_kernel(const int* __restrict__ labels,
                      const float* __restrict__ unary,
                      const float* __restrict__ w,
                      const unsigned char* __restrict__ mask,
                      const float* __restrict__ wsum, float* __restrict__ e,
                      int* __restrict__ h, float* __restrict__ cap_t,
                      float* __restrict__ caps,
                      unsigned char* __restrict__ in_play, int* pr, int R,
                      int K, int H, int W, int a, int b, float beta,
                      int limit) {
  const long HW = (long)H * W;
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  bool mine = false;
  if (j < (long)R * HW) {
    const long r = j / HW, i = j - r * HW;
    const int y = (int)(i / W), x = (int)(i - (long)y * W);
    const Region g{labels + r * HW, unary + r * K * HW, mask + r * HW,
                   wsum + r * HW, HW};
    const float* wr = w + r * 4 * HW;
    const bool play = swap_in_play(g, i, a, b);
    float c0 = when(play, g.u[a * HW + i]);
    float c1 = when(play, g.u[b * HW + i]);
    float cap[8];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int dr = dir_dr(d), dc = dir_dc(d);
#pragma unroll
      for (int s = 1; s >= -1; s -= 2) {
        const int qy = y + s * dr, qx = x + s * dc;
        const bool in = qy >= 0 && qy < H && qx >= 0 && qx < W;
        const long q = (long)qy * W + qx;
        const int nl = in ? g.lab[q] : -1;
        const bool np = in && swap_in_play(g, q, a, b);
        // the edge's weight: at p (forward), at the neighbour (backward)
        const float we = s == 1 ? wr[d * HW + i]
                                : (in ? wr[d * HW + q] : 0.0f);
        const float add = __fmul_rn(when(!np && nl >= 0, we), beta);
        c0 = __fadd_rn(c0, when(nl != a, add));
        c1 = __fadd_rn(c1, when(nl != b, add));
        cap[s == 1 ? d : 4 + d] = when(play && np, __fmul_rn(we, beta));
      }
    }
    mine = write_pixel(c0, c1, play, cap, j, r, i, HW, e, h, cap_t, caps,
                       in_play);
  }
  first_test(pr, mine, limit);
}

// _expansion_graph: source side = keep the current label
// (Kolmogorov-Zabih reduction of the weighted Potts move energy); per
// direction d, with q = p + DIRS[d] and o = p - DIRS[d] (the pixel whose
// edge ends at p), the eight terms of the tensor code in its order; arcs
// p -> q only.
__global__ void __launch_bounds__(MOVE_THREADS)
    expansion_build_kernel(const int* __restrict__ labels,
                           const float* __restrict__ unary,
                           const float* __restrict__ w,
                           const unsigned char* __restrict__ mask,
                           const float* __restrict__ wsum,
                           float* __restrict__ e, int* __restrict__ h,
                           float* __restrict__ cap_t,
                           float* __restrict__ caps,
                           unsigned char* __restrict__ in_play, int* pr,
                           int R, int K, int H, int W, int alpha,
                           float beta, int limit) {
  const long HW = (long)H * W;
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  bool mine = false;
  if (j < (long)R * HW) {
    const long r = j / HW, i = j - r * HW;
    const int y = (int)(i / W), x = (int)(i - (long)y * W);
    const Region g{labels + r * HW, unary + r * K * HW, mask + r * HW,
                   wsum + r * HW, HW};
    const float* wr = w + r * 4 * HW;
    const ExpPix p = exp_pix(g, i, alpha);
    const bool play = p.play;
    float c0 = when(play, g.u[p.l * HW + i]);    // keep the current label
    float c1 = when(play, g.u[alpha * HW + i]);  // take alpha
    const ExpPix out{-1, false, false, false};
    float cap[8];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int dr = dir_dr(d), dc = dir_dc(d);
      const int qy = y + dr, qx = x + dc, oy = y - dr, ox = x - dc;
      const bool qin = qy >= 0 && qy < H && qx >= 0 && qx < W;
      const bool oin = oy >= 0 && oy < H && ox >= 0 && ox < W;
      const long q = (long)qy * W + qx, o = (long)oy * W + ox;
      const ExpPix Q = qin ? exp_pix(g, q, alpha) : out;
      const ExpPix O = oin ? exp_pix(g, o, alpha) : out;
      const float lam = __fmul_rn(wr[d * HW + i], beta);       // p -> q
      const float lam_o = oin ? __fmul_rn(wr[d * HW + o], beta) : 0.0f;
      const bool both = play && Q.play;
      const bool same = Q.l == p.l;
      c1 = __fadd_rn(c1, when(both && same, lam));
      c1 = __fsub_rn(c1, when(O.play && play, lam_o));
      cap[d] = when(both, same ? __fmul_rn(2.0f, lam) : lam);
      c0 = __fadd_rn(c0, when(play && Q.alpha, lam));
      c0 = __fadd_rn(c0, when(O.alpha && play, lam_o));
      c1 = __fadd_rn(c1, when(play && Q.frozen, lam));
      c0 = __fadd_rn(c0, when(play && Q.frozen && !same, lam));
      c1 = __fadd_rn(c1, when(O.frozen && play, lam_o));
      c0 = __fadd_rn(c0, when(O.frozen && play && O.l != p.l, lam_o));
      cap[4 + d] = 0.0f;
    }
    mine = write_pixel(c0, c1, play, cap, j, r, i, HW, e, h, cap_t, caps,
                       in_play);
  }
  first_test(pr, mine, limit);
}

// b >= 0: swap (source side takes a, sink side b); b < 0: expansion of a
// (source side keeps its label, sink side takes a). counts: the move's
// (R,) int32 row.
__global__ void __launch_bounds__(MOVE_THREADS)
    move_apply_kernel(int* __restrict__ labels, const int* __restrict__ d,
                      const unsigned char* __restrict__ in_play,
                      int* __restrict__ counts, long HW, int n, int a,
                      int b) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  bool changed = false;
  if (i < HW) {
    const long j = blockIdx.y * HW + i;
    if (in_play[j]) {
      const bool source = d[j] >= n;
      const int l = labels[j];
      const int nl = b >= 0 ? (source ? a : b) : (source ? l : a);
      changed = nl != l;
      if (changed) labels[j] = nl;
    }
  }
  const int c = __syncthreads_count(changed);
  if (threadIdx.x == 0 && c) atomicAdd(counts + blockIdx.y, c);
}

}  // namespace

// M1: the cut graph of swap (a, b) (b >= 0) or of the expansion of a
// (b = -1) from the labels into the carry (e, h, cap_t, caps), in_play, and
// the pr word's GO and LIMIT (= max_sweeps).
extern "C" int phmrf_move_build(const int* labels, const float* unary,
                                const float* w, const unsigned char* mask,
                                const float* wsum, float* e, int* h,
                                float* cap_t, float* caps,
                                unsigned char* in_play, int* pr, int R,
                                int K, int H, int W, int a, int b,
                                float beta, int max_sweeps, void* stream) {
  const long N = (long)R * H * W;
  if (N == 0 || a < 0 || a >= K || b < -1 || b >= K || b == a)
    return (int)cudaErrorInvalidValue;
  const int blocks = ceil_div(N, MOVE_THREADS);
  if (b >= 0)
    swap_build_kernel<<<blocks, MOVE_THREADS, 0, (cudaStream_t)stream>>>(
        labels, unary, w, mask, wsum, e, h, cap_t, caps, in_play, pr, R, K,
        H, W, a, b, beta, max_sweeps);
  else
    expansion_build_kernel<<<blocks, MOVE_THREADS, 0,
                             (cudaStream_t)stream>>>(
        labels, unary, w, mask, wsum, e, h, cap_t, caps, in_play, pr, R, K,
        H, W, a, beta, max_sweeps);
  return (int)cudaGetLastError();
}

// M2: the move's labels from the cut's distances d (the source side is
// d >= n), in place, and each region's count of changed pixels added into
// counts (R,).
extern "C" int phmrf_move_apply(int* labels, const int* d,
                                const unsigned char* in_play, int* counts,
                                int R, int H, int W, int n, int a, int b,
                                void* stream) {
  const long HW = (long)H * W;
  if (R == 0 || HW == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(ceil_div(HW, MOVE_THREADS), R);
  move_apply_kernel<<<grid, MOVE_THREADS, 0, (cudaStream_t)stream>>>(
      labels, d, in_play, counts, HW, n, a, b);
  return (int)cudaGetLastError();
}
