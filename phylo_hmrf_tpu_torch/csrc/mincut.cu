// K5 (push-relabel iterations) and K6 (BFS min-plus sweeps) of the grid
// min-cut behind the exact polish.
//
// Replace phylo_hmrf_tpu/ops/mincut_pallas.py: K5 is _pr_kernel (entry
// pr_iterations_pallas), K6 is _bfs_kernel (entry bfs_sweeps_pallas); the
// host loop around them is ops/maxflow.py::grid_mincut.
//
// Layouts (contiguous, row-major): e, cap_t (R, H, W) float32; h, d
// (R, H, W) int32; caps, out (R, 8, H, W) float32. Arc direction a has the
// offset ALL_DIRS[a] (phylo_hmrf_tpu/ops/maxflow_tpu.py:32): the four DIRS
// (0,1), (1,0), (1,1), (1,-1), then their reversals; rev(a) = (a + 4) % 8.
// caps[a] at p is the residual capacity of the arc p -> p + ALL_DIRS[a].
// Arcs that leave the grid carry capacity exactly 0 (the move graphs are
// built so), so no flow or distance crosses the border: a neighbour outside
// the grid is skipped, which is what the plain version's filled shift and
// the TPU kernels' zero halo amount to on such graphs.
//
// K6, one Jacobi sweep:  d'(p) = min(d(p), min_{a: caps[a](p) > eps}
// d(p + a) + 1, n). The sink seed (d = 1 where cap_t > eps) is in the
// caller's start d. A sweep reads d and writes a second buffer, so every
// sweep is bitwise the plain version's; a device flag records whether any
// distance changed, read by the host once per call (8 sweeps), as the JAX
// bfs_fixpoint steps by 8.
//
// K5, one Jacobi push-relabel iteration, as two launches because the
// incoming flow at p needs every neighbour's outgoing flow of the same
// iteration (a grid-wide dependency):
//   push:    sink push where h == 1; then, in direction order, the push
//            out[a] = min(e, caps[a]) on every admissible arc
//            (h == h(p + a) + 1, h < n) against the local budget e; caps[a]
//            -= out[a]. Writes e, cap_t, caps and out.
//   relabel: inc[a] = out[rev a] at p + a; caps[a] += inc[a]; e += inc[0],
//            ..., e += inc[7] in that order; then active nodes
//            (e > eps, h < n) lift to max(h, min(min_h + 1, n)) with min_h
//            over the residual arcs of the pre-iteration neighbour heights
//            (and 0 where cap_t > eps). Reads the old h, writes the second
//            h buffer.
// Every add and subtract is a round-to-nearest intrinsic in the plain
// version's order, so the kernel and its plain version agree bitwise and the
// cut is held exactly.
//
// Bound: memory. One iteration moves ~200 bytes per pixel (the 8 capacities
// read and written twice, the 8 out values written and read, e, h, cap_t),
// for a handful of compares and adds; at the chr21 shapes (516k pixels) the
// 8 capacity planes (16.5 MB) and out (16.5 MB) stay in the 50 MB L2. One
// thread per pixel, neighbouring threads on neighbouring columns, so the
// eight neighbour reads are coalesced rows that L1 serves. The TPU kernels
// block 4 iterations / 8 sweeps under an 8-row halo in VMEM; this first
// version keeps one iteration or sweep per launch and spends its effort on
// exactness. The host-side convergence test (once per 4 iterations) and the
// changed-flag read (once per 8 sweeps) bound the launch rate.
#include "common.cuh"

#define PHMRF_CUT_EPS 1e-6f

__device__ __forceinline__ int adir_dr(int a) {
  return a < 4 ? dir_dr(a) : -dir_dr(a - 4);
}
__device__ __forceinline__ int adir_dc(int a) {
  return a < 4 ? dir_dc(a) : -dir_dc(a - 4);
}

// In-plane offset of the direction-a neighbour of (y, x), or -1 outside.
__device__ __forceinline__ long nb_offset(int y, int x, int H, int W, int a) {
  const int ny = y + adir_dr(a), nx = x + adir_dc(a);
  return (ny >= 0 && ny < H && nx >= 0 && nx < W) ? (long)ny * W + nx : -1;
}

__global__ void bfs_sweep_kernel(const int* __restrict__ d_in,
                                 int* __restrict__ d_out,
                                 const float* __restrict__ caps, int R, int H,
                                 int W, int n, int* __restrict__ changed) {
  const long HW = (long)H * W;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  bool moved = false;
  if (idx < (long)R * HW) {
    const int r = (int)(idx / HW);
    const long p = idx - (long)r * HW;
    const int y = (int)(p / W);
    const int x = (int)(p - (long)y * W);
    const int* d_r = d_in + (long)r * HW;
    const float* c_r = caps + (long)r * 8 * HW;
    const int cur = d_r[p];
    int best = cur;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const long q = nb_offset(y, x, H, W, a);
      if (q >= 0 && c_r[a * HW + p] > PHMRF_CUT_EPS) best = min(best, d_r[q] + 1);
    }
    best = min(best, n);
    d_out[idx] = best;
    moved = best != cur;
  }
  // one store per warp that saw a change (every lane reaches the vote)
  if (__any_sync(0xffffffffu, moved) && (threadIdx.x & 31) == 0) *changed = 1;
}

__global__ void pr_push_kernel(float* __restrict__ e,
                               const int* __restrict__ h,
                               float* __restrict__ cap_t,
                               float* __restrict__ caps,
                               float* __restrict__ out, int R, int H, int W,
                               int n) {
  const long HW = (long)H * W;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)R * HW) return;
  const int r = (int)(idx / HW);
  const long p = idx - (long)r * HW;
  const int y = (int)(p / W);
  const int x = (int)(p - (long)y * W);
  const int* h_r = h + (long)r * HW;
  float* c_r = caps + (long)r * 8 * HW;
  float* o_r = out + (long)r * 8 * HW;

  float ev = e[idx];
  float ct = cap_t[idx];
  const int hv = h_r[p];
  if (hv == 1) {   // sink at height 0
    const float dl = fminf(ev, ct);
    ev = __fsub_rn(ev, dl);
    ct = __fsub_rn(ct, dl);
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const long q = nb_offset(y, x, H, W, a);
    const float c = c_r[a * HW + p];
    float o = 0.0f;
    if (q >= 0 && hv < n && hv == h_r[q] + 1) {
      o = fminf(ev, c);
      ev = __fsub_rn(ev, o);
    }
    o_r[a * HW + p] = o;
    c_r[a * HW + p] = __fsub_rn(c, o);
  }
  e[idx] = ev;
  cap_t[idx] = ct;
}

__global__ void pr_relabel_kernel(float* __restrict__ e,
                                  const int* __restrict__ h_old,
                                  int* __restrict__ h_new,
                                  const float* __restrict__ cap_t,
                                  float* __restrict__ caps,
                                  const float* __restrict__ out, int R, int H,
                                  int W, int n) {
  const long HW = (long)H * W;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)R * HW) return;
  const int r = (int)(idx / HW);
  const long p = idx - (long)r * HW;
  const int y = (int)(p / W);
  const int x = (int)(p - (long)y * W);
  const int* h_r = h_old + (long)r * HW;
  float* c_r = caps + (long)r * 8 * HW;
  const float* o_r = out + (long)r * 8 * HW;

  float ev = e[idx];
  const int hv = h_r[p];
  int min_h = cap_t[idx] > PHMRF_CUT_EPS ? 0 : n;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const long q = nb_offset(y, x, H, W, a);
    // the neighbour's push back along the reverse arc lands here
    const float inc = q >= 0 ? o_r[((a + 4) & 7) * HW + q] : 0.0f;
    const float c = __fadd_rn(c_r[a * HW + p], inc);
    c_r[a * HW + p] = c;
    ev = __fadd_rn(ev, inc);
    if (q >= 0 && c > PHMRF_CUT_EPS) min_h = min(min_h, h_r[q]);
  }
  e[idx] = ev;
  const bool active = ev > PHMRF_CUT_EPS && hv < n;
  h_new[idx] = active ? max(hv, min(min_h + 1, n)) : hv;
}

// n_inner sweeps on d in place (scratch: a second (R, H, W) buffer);
// *changed (zeroed here) ends nonzero iff some distance changed.
extern "C" int phmrf_bfs_sweeps(int* d, int* scratch, const float* caps,
                                int R, int H, int W, int n, int n_inner,
                                int* changed, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long total = (long)R * H * W;
  if (n_inner < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (err != cudaSuccess || total == 0) return (int)err;
  const int threads = 256;
  int* src = d;
  for (int i = 0; i < n_inner; ++i) {
    int* dst = (src == d) ? scratch : d;
    bfs_sweep_kernel<<<ceil_div(total, threads), threads, 0, s>>>(
        src, dst, caps, R, H, W, n, changed);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  if (src != d)
    err = cudaMemcpyAsync(d, src, total * sizeof(int), cudaMemcpyDeviceToDevice, s);
  return (int)err;
}

// n_inner iterations on (e, h, cap_t, caps) in place; h_scratch and out
// are (R, H, W) int32 and (R, 8, H, W) float32 work buffers.
extern "C" int phmrf_pr_iterations(float* e, int* h, int* h_scratch,
                                   float* cap_t, float* caps, float* out,
                                   int R, int H, int W, int n, int n_inner,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long total = (long)R * H * W;
  if (n_inner < 1) return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  const int threads = 256;
  const int blocks = ceil_div(total, threads);
  int* h_cur = h;
  cudaError_t err;
  for (int i = 0; i < n_inner; ++i) {
    int* h_nxt = (h_cur == h) ? h_scratch : h;
    pr_push_kernel<<<blocks, threads, 0, s>>>(e, h_cur, cap_t, caps, out, R,
                                              H, W, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    pr_relabel_kernel<<<blocks, threads, 0, s>>>(e, h_cur, h_nxt, cap_t, caps,
                                                 out, R, H, W, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    h_cur = h_nxt;
  }
  if (h_cur != h)
    return (int)cudaMemcpyAsync(h, h_cur, total * sizeof(int),
                                cudaMemcpyDeviceToDevice, s);
  return 0;
}
