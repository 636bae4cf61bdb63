// K5 (push-relabel iterations) and K6 (BFS min-plus sweeps) of the grid
// min-cut behind the exact polish.
//
// Replace phylo_hmrf_tpu/ops/mincut_pallas.py: K5 is _pr_kernel (entry
// pr_iterations_pallas), K6 is _bfs_kernel (entry bfs_sweeps_pallas); the
// host loop around them is ops/maxflow.py::grid_mincut.
//
// Layouts (contiguous, row-major): e, cap_t (R, H, W) float32; h, d
// (R, H, W) int32; caps (R, 8, H, W) float32. Arc direction a has the
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
// caller's start d.
//
// K5, one Jacobi push-relabel iteration:
//   push:    sink push where h == 1; then, in direction order, the push
//            out[a] = min(e, caps[a]) on every admissible arc
//            (h == h(p + a) + 1, h < n) against the local budget e; caps[a]
//            -= out[a].
//   gather:  inc[a] = out[rev a] at p + a; caps[a] += inc[a]; e += inc[0],
//            ..., e += inc[7] in that order;
//   relabel: active nodes (e > eps, h < n) lift to max(h, min(min_h + 1, n))
//            with min_h over the residual arcs of the pre-iteration
//            neighbour heights (and 0 where cap_t > eps).
// Every add and subtract is a round-to-nearest intrinsic in the plain
// version's order, so the kernels and their plain versions agree bitwise
// and the cut is held exactly.
//
// Bound: memory. Per pixel, 4 iterations must read and write e, h, cap_t
// and the 8 capacities once (88 bytes), 8 sweeps read d and the capacities
// and write d (40 bytes); the work per byte is a handful of compares and
// adds. A one-iteration-per-launch design moves ~200 bytes per pixel and
// iteration (the capacities twice, an 8-plane out array) and pays a grid
// barrier per half iteration. So both kernels block in time, as the TPU
// kernels do in VMEM (mincut_pallas.py:10-14), but on 2D tiles with a halo
// on all four sides (the diagonal arcs need columns too, and 227 KB of
// shared memory cannot hold full 768-pixel rows). A thread owns a fixed
// set of the tile's pixels (pixel i = thread + k * threads) and loads them
// with unconditional loads, all in flight at once (a pixel outside the
// grid reads pixel 0 and drops it):
//   K6: a 32 x 64 interior (48 x 80 loaded), 640 threads, 2 blocks an SM.
//       The eight tests caps[a] > eps become one byte of residual-arc bits
//       per owned pixel, in a register beside its margin; the capacities
//       are read once. Up to 8 sweeps run in shared memory, ping-ponging
//       two d planes (30 KB), each sweep on the pixels that are still exact
//       (the region shrinks by one pixel a sweep); the interior is written
//       once.
//   K5: a 32 x 64 interior, 960 threads, one block an SM. A pixel's e,
//       cap_t and 8 capacities live in the registers of the thread that owns
//       it, its height (two planes: the relabel reads the pre-iteration
//       heights) and its 8 outgoing flows in shared memory (150 KB), where
//       the neighbours read them. One iteration has radius 2, so up to 4
//       iterations run under the 8-pixel halo; each phase runs on the
//       pixels that are still exact, behind a block barrier.
// The tiles were picked on an H100 at the chr21 move graph among 10 shapes
// each (16-64 rows, 32-128 columns, 384-960 threads): larger interiors
// lose to wave quantisation and shared memory, smaller ones to the halo.
// Pixels outside the grid load as e = cap_t = caps = 0 and are never
// updated or read (every neighbour read is guarded), so a ragged tile at
// the grid's edge needs nothing else. Both kernels write their interior to
// a second set of buffers (a neighbouring block may still be loading its
// halo from the input) and take part in a loop through a loop word
// (loops.cuh): it keeps going for K6 while some distance changed
// (distances only fall, so that is "changed in some sweep"), for K5 while
// a node is still active after its last iteration. A launch whose loop has
// stopped runs 0 iterations / sweeps: it writes its interior as it loaded
// it. The loops themselves are CUDA graphs (loops.cu) or a host loop
// (ops/maxflow.py::grid_mincut_host).
#include "common.cuh"
#include "loops.cuh"

// Tile geometry: interior rows x columns, halo, threads per block (a
// multiple of 32 that divides the tile's pixels), blocks an SM should hold.
#ifndef PR_TH
#define PR_TH 32
#define PR_TW 64
#define PR_THREADS 960
#endif
#define PR_HALO 8      // 4 iterations of radius 2
#ifndef BFS_TH
#define BFS_TH 32
#define BFS_TW 64
#define BFS_THREADS 640
#define BFS_BLOCKS_PER_SM 2
#endif
#define BFS_HALO 8     // 8 sweeps of radius 1

__host__ __device__ constexpr int adir_dr(int a) {
  return a == 0 ? 0 : (a < 4 ? 1 : (a == 4 ? 0 : -1));
}
__host__ __device__ constexpr int adir_dc(int a) {
  return (a == 0 || a == 2) ? 1 : (a == 1 || a == 5) ? 0
         : (a == 3 || a == 4 || a == 6) ? -1 : 1;
}

// Bits 0-7: the neighbour in direction a lies in the grid; bit 8: the
// pixel itself does; bits 9 and up: its distance to the tile's edge. 0 for
// a pixel outside the grid, so "margin >= 1" implies "in the grid".
__device__ __forceinline__ int pixel_meta(int ly, int lx, int LH, int LW,
                                          int gy, int gx, int H, int W) {
  if (gy < 0 || gy >= H || gx < 0 || gx >= W) return 0;
  int m = 1 << 8;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int ny = gy + adir_dr(a), nx = gx + adir_dc(a);
    if (ny >= 0 && ny < H && nx >= 0 && nx < W) m |= 1 << a;
  }
  const int margin = min(min(ly, LH - 1 - ly), min(lx, LW - 1 - lx));
  return m | (margin << 9);
}

template <int TH, int TW, int HALO, int NT, int MIN_BLOCKS>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
bfs_tile_kernel(const int* __restrict__ d_in, int* __restrict__ d_out,
                const float* __restrict__ caps, int H, int W, int n,
                int n_inner, int* __restrict__ loop) {
  constexpr int LH = TH + 2 * HALO, LW = TW + 2 * HALO, NPX = LH * LW;
  constexpr int P = NPX / NT;              // pixels a thread owns
  static_assert(P * NT == NPX, "threads must divide the tile");
  extern __shared__ int smem[];
  const bool run = loop_runs(loop);
  const int sweeps = run ? n_inner : 0;    // 0: pass the input through
  int* src = smem;                   // d, ping
  int* dst = smem + NPX;             // d, pong
  const long HW = (long)H * W;
  const long r = blockIdx.z;
  const int y0 = (int)blockIdx.y * TH - HALO, x0 = (int)blockIdx.x * TW - HALO;
  const float* c_r = caps + r * 8 * HW;

  // residual-arc bits 0-7 and the margin (bits 9+) of the owned pixels;
  // 0 outside the grid. Every load is unconditional (a pixel outside the
  // grid reads pixel 0 and drops it), so all of them are in flight at once
  int meta[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = threadIdx.x + k * NT;
    const int ly = i / LW, lx = i - (i / LW) * LW;
    const int gy = y0 + ly, gx = x0 + lx;
    const int m = pixel_meta(ly, lx, LH, LW, gy, gx, H, W);
    const long p = m ? (long)gy * W + gx : 0;
    const int dv = d_in[r * HW + p];
    int bits = 0;
#pragma unroll
    for (int a = 0; a < 8; ++a)
      if (c_r[a * HW + p] > PHMRF_CUT_EPS) bits |= 1 << a;
    meta[k] = m ? (bits & m & 0xff) | (m >> 9 << 9) : 0;
    src[i] = m ? dv : n;
  }
  __syncthreads();

  bool moved = false;
  for (int s = 1; s <= sweeps; ++s) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int i = threadIdx.x + k * NT;
      const int m = meta[k];
      if ((m >> 9) < s) continue;    // no longer exact after s sweeps
      const int cur = src[i];
      int best = cur;
#pragma unroll
      for (int a = 0; a < 8; ++a)
        if ((m >> a) & 1)
          best = min(best, src[i + adir_dr(a) * LW + adir_dc(a)] + 1);
      best = min(best, n);
      dst[i] = best;
      if ((m >> 9) >= HALO && best != cur) moved = true;
    }
    __syncthreads();
    int* t = src;
    src = dst;
    dst = t;
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = threadIdx.x + k * NT;
    if ((meta[k] >> 9) >= HALO) {
      const int ly = i / LW, lx = i - (i / LW) * LW;
      d_out[r * HW + (long)(y0 + ly) * W + (x0 + lx)] = src[i];
    }
  }
  loop_finish(loop, run, moved, n_inner);   // every thread reaches it
}

template <int TH, int TW, int HALO, int NT>
__global__ void __launch_bounds__(NT, 1)
pr_tile_kernel(const float* __restrict__ e_in, const int* __restrict__ h_in,
               const float* __restrict__ ct_in,
               const float* __restrict__ caps_in, float* __restrict__ e_out,
               int* __restrict__ h_out, float* __restrict__ ct_out,
               float* __restrict__ caps_out, int H, int W, int n,
               int n_inner, int* __restrict__ loop) {
  constexpr int LH = TH + 2 * HALO, LW = TW + 2 * HALO, NPX = LH * LW;
  constexpr int P = NPX / NT;              // pixels a thread owns
  static_assert(P * NT == NPX, "threads must divide the tile");
  extern __shared__ int smem[];
  const bool run = loop_runs(loop);
  const int iters = run ? n_inner : 0;     // 0: pass the input through
  int* hc = smem;                                     // h, this iteration
  int* hn = smem + NPX;                               // h, the next
  float* out = reinterpret_cast<float*>(smem + 2 * NPX);   // (8, NPX)
  const long HW = (long)H * W;
  const long r = blockIdx.z;
  const int y0 = (int)blockIdx.y * TH - HALO, x0 = (int)blockIdx.x * TW - HALO;

  // the owned pixels' state; every load is unconditional (a pixel outside
  // the grid reads pixel 0, then loads as zeros), so all are in flight
  float ev[P], ct[P], cp[P][8];
  int meta[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = threadIdx.x + k * NT;
    const int ly = i / LW, lx = i - (i / LW) * LW;
    const int gy = y0 + ly, gx = x0 + lx;
    const int m = pixel_meta(ly, lx, LH, LW, gy, gx, H, W);
    const long p = m ? (long)gy * W + gx : 0;
    const float* c = caps_in + r * 8 * HW + p;
    const float e0 = e_in[r * HW + p], ct0 = ct_in[r * HW + p];
    const int h0 = h_in[r * HW + p];
    meta[k] = m;
    ev[k] = m ? e0 : 0.0f;
    ct[k] = m ? ct0 : 0.0f;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float c0 = c[a * HW];
      cp[k][a] = m ? c0 : 0.0f;
    }
    hc[i] = m ? h0 : 0;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // push: exact on pixels 2 it + 1 or more from the tile's edge
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int i = threadIdx.x + k * NT;
      const int m = meta[k];
      if ((m >> 9) < 2 * it + 1) continue;
      const int hv = hc[i];
      float e = ev[k];
      if (hv == 1) {   // sink at height 0
        const float dl = fminf(e, ct[k]);
        e = __fsub_rn(e, dl);
        ct[k] = __fsub_rn(ct[k], dl);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        float o = 0.0f;
        if (((m >> a) & 1) && hv < n &&
            hv == hc[i + adir_dr(a) * LW + adir_dc(a)] + 1) {
          o = fminf(e, cp[k][a]);
          e = __fsub_rn(e, o);
        }
        out[a * NPX + i] = o;
        cp[k][a] = __fsub_rn(cp[k][a], o);
      }
      ev[k] = e;
    }
    __syncthreads();
    // gather and relabel: exact on pixels 2 it + 2 or more from the edge
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int i = threadIdx.x + k * NT;
      const int m = meta[k];
      if ((m >> 9) < 2 * it + 2) continue;
      const int hv = hc[i];
      float e = ev[k];
      int min_h = ct[k] > PHMRF_CUT_EPS ? 0 : n;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int q = i + adir_dr(a) * LW + adir_dc(a);
        const bool ok = (m >> a) & 1;
        // the neighbour's push back along the reverse arc lands here
        const float inc = ok ? out[((a + 4) & 7) * NPX + q] : 0.0f;
        const float c = __fadd_rn(cp[k][a], inc);
        cp[k][a] = c;
        e = __fadd_rn(e, inc);
        if (ok && c > PHMRF_CUT_EPS) min_h = min(min_h, hc[q]);
      }
      ev[k] = e;
      const bool active = e > PHMRF_CUT_EPS && hv < n;
      hn[i] = active ? max(hv, min(min_h + 1, n)) : hv;
    }
    __syncthreads();
    int* t = hc;
    hc = hn;
    hn = t;
  }

  bool active = false;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = threadIdx.x + k * NT;
    const int m = meta[k];
    if ((m >> 9) < HALO) continue;
    const int ly = i / LW, lx = i - (i / LW) * LW;
    const long p = (long)(y0 + ly) * W + (x0 + lx);
    const int hv = hc[i];
    e_out[r * HW + p] = ev[k];
    h_out[r * HW + p] = hv;
    ct_out[r * HW + p] = ct[k];
    float* c = caps_out + r * 8 * HW + p;
#pragma unroll
    for (int a = 0; a < 8; ++a) c[a * HW] = cp[k][a];
    active = active || (ev[k] > PHMRF_CUT_EPS && hv < n);
  }
  loop_finish(loop, run, run && active, n_inner);   // every thread
}

#define BFS_KERNEL \
  bfs_tile_kernel<BFS_TH, BFS_TW, BFS_HALO, BFS_THREADS, BFS_BLOCKS_PER_SM>
#define PR_KERNEL pr_tile_kernel<PR_TH, PR_TW, PR_HALO, PR_THREADS>

static size_t tile_pixels(int th, int tw, int halo) {
  return (size_t)(th + 2 * halo) * (tw + 2 * halo);
}

static size_t bfs_smem() {
  return 2 * sizeof(int) * tile_pixels(BFS_TH, BFS_TW, BFS_HALO);
}
static size_t pr_smem() {
  return 10 * sizeof(int) * tile_pixels(PR_TH, PR_TW, PR_HALO);
}

// The dynamic shared memory attribute of both kernels, on the current
// card: before every launch or node made here, never while a stream
// captures.
cudaError_t phmrf_prepare_mincut() {
  cudaError_t err = cudaFuncSetAttribute(
      BFS_KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bfs_smem());
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      PR_KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pr_smem());
}

static dim3 bfs_grid(int R, int H, int W) {
  return dim3(ceil_div(W, BFS_TW), ceil_div(H, BFS_TH), R);
}
static dim3 pr_grid(int R, int H, int W) {
  return dim3(ceil_div(W, PR_TW), ceil_div(H, PR_TH), R);
}

cudaError_t phmrf_bfs_node(cudaGraph_t g, cudaGraphNode_t* last,
                           const int* d, int* d_out, const float* caps,
                           int R, int H, int W, int n, int n_inner,
                           int* loop) {
  if (n_inner < 1 || n_inner > BFS_HALO || (long)R * H * W == 0)
    return cudaErrorInvalidValue;
  void* args[] = {&d, &d_out, &caps, &H, &W, &n, &n_inner, &loop};
  return graph_append_kernel(g, last, (const void*)&BFS_KERNEL,
                             bfs_grid(R, H, W), dim3(BFS_THREADS),
                             bfs_smem(), args);
}

cudaError_t phmrf_pr_node(cudaGraph_t g, cudaGraphNode_t* last,
                          const float* e, const int* h, const float* cap_t,
                          const float* caps, float* e_out, int* h_out,
                          float* ct_out, float* caps_out, int R, int H,
                          int W, int n, int n_inner, int* loop) {
  if (n_inner < 1 || 2 * n_inner > PR_HALO || (long)R * H * W == 0)
    return cudaErrorInvalidValue;
  void* args[] = {&e,  &h, &cap_t, &caps, &e_out, &h_out, &ct_out,
                  &caps_out, &H, &W, &n, &n_inner, &loop};
  return graph_append_kernel(g, last, (const void*)&PR_KERNEL,
                             pr_grid(R, H, W), dim3(PR_THREADS), pr_smem(),
                             args);
}

// n_inner (<= 8) sweeps from d into d_out (d is not written), a step of
// the loop `loop` (may be null: no loop).
extern "C" int phmrf_bfs_sweeps(const int* d, int* d_out, const float* caps,
                                int R, int H, int W, int n, int n_inner,
                                int* loop, void* stream) {
  if (n_inner < 1 || n_inner > BFS_HALO) return (int)cudaErrorInvalidValue;
  if ((long)R * H * W == 0) return 0;
  // per device: set it on every call (the card may change between calls)
  const cudaError_t attr = phmrf_prepare_mincut();
  if (attr != cudaSuccess) return (int)attr;
  BFS_KERNEL<<<bfs_grid(R, H, W), BFS_THREADS, bfs_smem(),
               (cudaStream_t)stream>>>(d, d_out, caps, H, W, n, n_inner,
                                       loop);
  return (int)cudaGetLastError();
}

// n_inner (<= 4) iterations from (e, h, cap_t, caps) into the *_out
// buffers (the inputs are not written), a step of the loop `loop` (may be
// null).
extern "C" int phmrf_pr_iterations(const float* e, const int* h,
                                   const float* cap_t, const float* caps,
                                   float* e_out, int* h_out, float* ct_out,
                                   float* caps_out, int R, int H, int W,
                                   int n, int n_inner, int* loop,
                                   void* stream) {
  if (n_inner < 1 || 2 * n_inner > PR_HALO) return (int)cudaErrorInvalidValue;
  if ((long)R * H * W == 0) return 0;
  const cudaError_t attr = phmrf_prepare_mincut();
  if (attr != cudaSuccess) return (int)attr;
  PR_KERNEL<<<pr_grid(R, H, W), PR_THREADS, pr_smem(),
              (cudaStream_t)stream>>>(e, h, cap_t, caps, e_out, h_out,
                                      ct_out, caps_out, H, W, n, n_inner,
                                      loop);
  return (int)cudaGetLastError();
}
