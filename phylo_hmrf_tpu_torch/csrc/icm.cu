// K2 and K8: checkerboard ICM on K-major fields.
//
// K2 is icm_pair_kernel below (the eight phases of a sweep pair in one
// launch, on shared-memory tiles); it replaces phylo_hmrf_tpu/ops/
// icm_pallas.py::_icm_sweeppair_kernel (entry _icm_sweep_pair_padded,
// driven by icm_pallas), which runs the phases (a, b) in (0,0), (0,1),
// (1,0), (1,1) twice on a VMEM slab. K8 is icm_halo_kernel at the end of
// this file (the phases of a sweep over all the row shards a device holds
// in one launch); it replaces _icm_phase_kernel (entry icm_phase_pallas,
// halo_extended=True). icm_phase_kernel, one phase of a whole grid a
// launch with the labels updated in place, is the chained reference: eight
// launches of it are what K2 is held to (ops/icm_kernels.py::
// icm_sweep_pair_chained). Pixels of colour (row % 2, col % 2) == (a, b)
// are never 8-neighbours of each other, so a phase may write its pixels in
// place: no thread reads a pixel another thread of the phase writes.
//
// At every valid pixel of the active colour:
//   agree_k = sum_d w_d(p) [s(p+d) == k] + w_d(p-d) [s(p-d) == k]
//   s(p)   <- argmin_k (unary_k - beta * agree_k)   (first index on ties)
// The terms are added in the plain version's order (DIRS order, forward
// then backward) and every add and multiply is a round-to-nearest
// intrinsic, so nvcc cannot contract them into FMAs: labels are compared
// exactly with the plain version, and near-ties would otherwise flip.
//
// icm_phase_kernel touches a quarter of the pixels, reads K unary values
// each, one pixel per thread with the K scores in registers.
#include "common.cuh"
#include "loops.cuh"

__global__ void icm_phase_kernel(int* __restrict__ labels,
                                 const float* __restrict__ unary,
                                 const float* __restrict__ w,
                                 const int* __restrict__ mask, int R, int K,
                                 int H, int W, float beta, int pa, int pb) {
  const int Hc = (H - pa + 1) / 2;   // rows of colour pa
  const int Wc = (W - pb + 1) / 2;   // cols of colour pb
  const long per_r = (long)Hc * Wc;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (per_r == 0 || idx >= (long)R * per_r) return;
  const int r = (int)(idx / per_r);
  const long c = idx - (long)r * per_r;
  const int h = 2 * (int)(c / Wc) + pa;
  const int x = 2 * (int)(c % Wc) + pb;
  const long HW = (long)H * W;
  const long p = (long)h * W + x;
  if (mask[(long)r * HW + p] == 0) return;

  Nbrs n;
  load_nbrs(w + (long)r * 4 * HW, H, W, h, x, n);
  int* lab_r = labels + (long)r * HW;
  int nb[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) nb[s] = n.ok[s] ? lab_r[n.off[s]] : -1;

  const float* u_r = unary + (long)r * K * HW;
  int best = 0;
  float best_score = 0.0f;
#pragma unroll
  for (int k = 0; k < PHMRF_KMAX; ++k) {
    if (k < K) {
      float agree = 0.0f;
#pragma unroll
      for (int s = 0; s < 8; ++s)
        agree = __fadd_rn(agree, nb[s] == k ? n.wt[s] : 0.0f);
      const float score = __fsub_rn(u_r[(long)k * HW + p], __fmul_rn(beta, agree));
      if (k == 0 || score < best_score) {
        best = k;
        best_score = score;
      }
    }
  }
  lab_r[p] = best;
}

extern "C" int phmrf_icm_phase(int* labels, const float* unary,
                               const float* w, const int* mask, int R, int K,
                               int H, int W, float beta, int pa, int pb,
                               void* stream) {
  if (K < 1 || K > PHMRF_KMAX || (pa & ~1) || (pb & ~1))
    return (int)cudaErrorInvalidValue;
  const long n = (long)R * ((H - pa + 1) / 2) * ((W - pb + 1) / 2);
  if (n <= 0) return 0;
  const int threads = 256;
  icm_phase_kernel<<<ceil_div(n, threads), threads, 0, (cudaStream_t)stream>>>(
      labels, unary, w, mask, R, K, H, W, beta, pa, pb);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// K2, the tile kernel: the 8 phases of a sweep pair in one launch.
//
// Eight launches of icm_phase_kernel re-read, per phase, 8 labels, 8
// weights and K unary values of each active pixel, and pay a launch on a
// grid that is 3/4 idle, eight times a pair; each update costs ~33
// instructions per state. Bound of the pair: the bytes it must move
// (labels read and written, the unary, the 4 weight planes and the mask
// read once, 35 MB at chr21 and K = 10), then the instructions of the
// updates. Here a block loads the labels (-1 outside the grid, as the
// plain version's fill) and the 4 forward weight planes (0 outside, by
// zero-filling cp.async copies, all in flight at once) of a TH x TW
// interior with an 8-pixel border on all four sides into shared memory
// once, runs the 8 phases with a barrier between them, and writes the
// interior once, to another buffer than the input (a neighbouring block
// may still be loading its border). Phase j (1..8) updates only the pixels
// at margin >= j from the tile's edge, the ones still exact. A thread owns
// two 2 x 2 quads, each holding one pixel of each colour (TH, TW and the
// border are even, so the tile starts on an even row and column): every
// phase keeps every thread busy with two independent updates.
//
// An update scores the 8 neighbour slots' labels and one label-free
// candidate, not all K states, and gives icm_phase_kernel's label. A
// state k that no neighbour carries has agree_k = +0 exactly (a sum of
// +0.0f terms), so its score u_k - beta * 0 does not depend on the labels:
// the first argmin over all k of those scores, (v0, k0), is taken once per
// pixel and pair, in one pass over the unary in device memory (the only
// full read of the unary; 4 states' loads in flight at a time), and kept
// in shared memory. The label L of each neighbour slot gets its agreement
// as the phase kernel sums it, the slots with label L in slot order (the
// +0.0f terms of the others change nothing: the sum is never -0 when the
// weights are >= 0), and its score with the same intrinsics, u_L read
// again (from L1/L2). The 8 slots are scored without branches (a label on
// several slots scores the same each time), so their 8 chains and loads
// overlap. With beta > 0 such a score is at most its label-free one
// (rounding is monotone), so the first argmin over all k is the least
// (score, k) pair among (v0, k0) and the neighbour labels'. Where that does
// not hold (beta <= 0 or not finite, a unary value not finite, a weight < 0
// or NaN) the pixel runs the phase kernel's K-state loop. The unary is not
// staged in shared memory: at K = 10 its K planes were 4/5 of a tile's
// bytes, which held a block at one an SM, its loads and its phases in
// turn.
//
// Measured on an H100 (tools/icm_stages.py: %globaltimer stamps at each
// stage of one block, chr21, K = 10): loads ~2.6 us, the label-free pass
// ~7.7 us (the unary's bytes times the border's 1.6x), the first phase
// ~6.9 us, each later one ~3.2 us whatever K. One block takes ~43 us of
// the ~57 us launch: the pair is a chain of 10 dependent steps in each
// block, not a stream of bytes, and runs level with the 8 phase launches
// at K = 10 (ahead at K = 30, where their K-state loops cost more); fewer
// instructions an update (only the distinct labels, or only the one label
// of a uniform neighbourhood) did not shorten a phase (PERF.md).
//
// `row_parity` is the colour parity of row 0 (a row shard's slab starts at
// an odd global row when its first row minus the halo depth is odd). When
// `loop` is given, the pair is a step of that loop (loops.cuh): it goes on
// while some label of the grid changed, and a pair whose loop has stopped
// writes the labels as it loaded them.
// ---------------------------------------------------------------------

#define PHMRF_ICM_HALO 8   // 8 phases of radius 1
#define ICM_QP 2           // 2 x 2 quads a thread owns, at most
#define ICM_SKIP (-2)      // k0 of a pixel no phase updates
#define ICM_SLOW (-1)      // k0 of a pixel that runs the K-state loop

// the weight of slot s (DIRS order, forward then backward) of tile pixel
// i: the forward weight at i, the backward one at the neighbour
__device__ __forceinline__ float icm_weight(const float* wf, int NPX, int i,
                                            int LW, int s) {
  const int d = s >> 1;
  const int off = dir_dr(d) * LW + dir_dc(d);
  return wf[d * NPX + ((s & 1) ? i - off : i)];
}

__global__ void __launch_bounds__(1024, 1)
icm_pair_kernel(const int* __restrict__ lab_in, int* __restrict__ lab_out,
                const float* __restrict__ unary, const float* __restrict__ w,
                const int* __restrict__ mask, int K, int H, int W, int TH,
                int TW, float beta, int row_parity, int* __restrict__ loop) {
  extern __shared__ float smem[];
  const int LH = TH + 2 * PHMRF_ICM_HALO, LW = TW + 2 * PHMRF_ICM_HALO;
  const int NPX = LH * LW, QW = LW / 2, NQ = (LH / 2) * QW;
  const int NT = blockDim.x;
  int* lab = reinterpret_cast<int*>(smem);             // labels
  float* wf = smem + NPX;                              // forward weights, 4
  float* v0 = smem + 5 * NPX;                          // label-free minimum
  int* k0 = reinterpret_cast<int*>(smem + 6 * NPX);    // and its state
  const long HW = (long)H * W;
  const long r = blockIdx.z;
  const int y0 = (int)blockIdx.y * TH - PHMRF_ICM_HALO;   // even
  const int x0 = (int)blockIdx.x * TW - PHMRF_ICM_HALO;   // even
  const float* u_r = unary + r * K * HW;
  const bool beta_pos = beta > 0.0f && beta <= 3.402823466e38f;
  const bool run = loop_runs(loop);   // else: no phase, labels as loaded

  // pixel of colour c (= 2a + b, phase (a, b)) of quad q: tile row, column
#define ICM_LY(q, c) (2 * ((q) / QW) + ((((c) >> 1) + row_parity) & 1))
#define ICM_LX(q, c) (2 * ((q) % QW) + ((c) & 1))
  // labels, forward weights; loads of a clamped address, all in flight.
  // k0 marks the pixels no phase updates (outside the grid, masked out, on
  // the tile's edge); only the owner reads a pixel's k0
#pragma unroll
  for (int j = 0; j < ICM_QP; ++j) {
    const int q = threadIdx.x + j * NT;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (q >= NQ) continue;
      const int ly = ICM_LY(q, c), lx = ICM_LX(q, c);
      const int gy = y0 + ly, gx = x0 + lx;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const long p = in ? (long)gy * W + gx : 0;
      const int i = ly * LW + lx;
      const int l0 = lab_in[r * HW + p];
      const bool upd = in && mask[r * HW + p] != 0 &&
                       tile_margin(ly, lx, LH, LW) >= 1;
      lab[i] = in ? l0 : -1;
      k0[i] = upd && run ? 0 : ICM_SKIP;
#pragma unroll
      for (int d = 0; d < 4; ++d)
        cp_async_f32(wf + d * NPX + i, w + (r * 4 + d) * HW + p, in && run);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // the label-free minimum of each pixel this thread updates, pixel by
  // pixel, 4 states' loads in flight at a time
#pragma unroll
  for (int j = 0; j < ICM_QP; ++j) {
    const int q = threadIdx.x + j * NT;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (q >= NQ) continue;
      const int ly = ICM_LY(q, c), lx = ICM_LX(q, c);
      const int i = ly * LW + lx;
      if (k0[i] == ICM_SKIP) continue;
      const float* u = u_r + (long)(y0 + ly) * W + (x0 + lx);
      bool ok = beta_pos;
#pragma unroll
      for (int s = 0; s < 8; ++s)
        ok = ok && icm_weight(wf, NPX, i, LW, s) >= 0.0f;
      int best = 0;
      float best_score = 0.0f;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float uk = u[k * HW];
        ok = ok && fabsf(uk) <= 3.402823466e38f;
        const float score = __fsub_rn(uk, __fmul_rn(beta, 0.0f));
        if (k == 0 || score < best_score) {
          best = k;
          best_score = score;
        }
      }
      v0[i] = best_score;
      k0[i] = ok ? best : ICM_SLOW;
    }
  }

#pragma unroll 1
  for (int ph = 0; ph < (run ? 8 : 0); ++ph) {
    const int c = ph & 3;   // (a, b) = (c >> 1, c & 1), the phase order
#pragma unroll
    for (int j = 0; j < ICM_QP; ++j) {
      const int q = threadIdx.x + j * NT;
      if (q >= NQ) continue;
      const int ly = ICM_LY(q, c), lx = ICM_LX(q, c);
      const int i = ly * LW + lx;
      const int kk = k0[i];
      if (kk == ICM_SKIP || tile_margin(ly, lx, LH, LW) < ph + 1) continue;
      const float* u = u_r + (long)(y0 + ly) * W + (x0 + lx);
      int nb[8];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int d = s >> 1, sg = (s & 1) ? -1 : 1;
        nb[s] = lab[i + sg * (dir_dr(d) * LW + dir_dc(d))];
      }
      int best;
      if (kk >= 0) {
        // the least (score, k) of the label-free minimum and the neighbour
        // labels' (a label on several slots gives the same pair each time)
        float wt[8];
#pragma unroll
        for (int s = 0; s < 8; ++s) wt[s] = icm_weight(wf, NPX, i, LW, s);
        float bvi = v0[i];
        best = kk;
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const int L = nb[s];
          float agree = 0.0f;
#pragma unroll
          for (int t = 0; t < 8; ++t)
            if (nb[t] == L) agree = __fadd_rn(agree, wt[t]);
          const bool in = L >= 0 && L < K;
          const float score =
              __fsub_rn(u[(in ? L : 0) * HW], __fmul_rn(beta, agree));
          if (in && (score < bvi || (score == bvi && L < best))) {
            best = L;
            bvi = score;
          }
        }
      } else {
        float wt[8];
#pragma unroll
        for (int s = 0; s < 8; ++s) wt[s] = icm_weight(wf, NPX, i, LW, s);
        best = 0;
        float best_score = 0.0f;
        for (int k = 0; k < K; ++k) {
          float agree = 0.0f;
#pragma unroll
          for (int s = 0; s < 8; ++s)
            agree = __fadd_rn(agree, nb[s] == k ? wt[s] : 0.0f);
          const float score = __fsub_rn(u[k * HW], __fmul_rn(beta, agree));
          if (k == 0 || score < best_score) {
            best = k;
            best_score = score;
          }
        }
      }
      lab[i] = best;
    }
    __syncthreads();
  }

  bool changed = false;
#pragma unroll
  for (int j = 0; j < ICM_QP; ++j) {
    const int q = threadIdx.x + j * NT;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (q >= NQ) continue;
      const int ly = ICM_LY(q, c), lx = ICM_LX(q, c);
      const int gy = y0 + ly, gx = x0 + lx;
      if (gy < 0 || gy >= H || gx < 0 || gx >= W ||
          tile_margin(ly, lx, LH, LW) < PHMRF_ICM_HALO)
        continue;   // the interior of the grid only
      const long p = r * HW + (long)gy * W + gx;
      const int v = lab[ly * LW + lx];
      lab_out[p] = v;
      changed = changed || v != lab_in[p];
    }
  }
#undef ICM_LY
#undef ICM_LX
  loop_finish(loop, run, changed, 2);   // every thread reaches it
}

static cudaError_t icm_pair_plan(int K, int row_parity, int th, int tw,
                                 int threads, size_t* smem) {
  if (K < 1 || K > PHMRF_KMAX || (row_parity & ~1) || th < 2 || tw < 2 ||
      ((th | tw) & 1) || threads < 32 || threads > 1024 || threads % 32)
    return cudaErrorInvalidValue;
  const int lh = th + 2 * PHMRF_ICM_HALO, lw = tw + 2 * PHMRF_ICM_HALO;
  *smem = sizeof(float) * 7 * (size_t)lh * lw;
  if (ceil_div((long)lh * lw / 4, threads) > ICM_QP || *smem > PHMRF_SMEM_MAX)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The dynamic shared memory attribute of K2 for a th x tw interior, on the
// current card: before every launch or node made here, never while a
// stream captures.
cudaError_t phmrf_prepare_icm_pair(int th, int tw) {
  const int lh = th + 2 * PHMRF_ICM_HALO, lw = tw + 2 * PHMRF_ICM_HALO;
  return cudaFuncSetAttribute(
      icm_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * 7 * (size_t)lh * lw));
}

cudaError_t phmrf_icm_pair_node(cudaGraph_t g, cudaGraphNode_t* last,
                                const int* labels, int* out,
                                const float* unary, const float* w,
                                const int* mask, int R, int K, int H, int W,
                                float beta, int row_parity, int th, int tw,
                                int threads, int* loop) {
  size_t smem;
  const cudaError_t err = icm_pair_plan(K, row_parity, th, tw, threads,
                                        &smem);
  if (err != cudaSuccess) return err;
  if ((long)R * H * W == 0) return cudaErrorInvalidValue;
  void* args[] = {&labels, &out, &unary, &w,    &mask,       &K,   &H,
                  &W,      &th,  &tw,    &beta, &row_parity, &loop};
  return graph_append_kernel(g, last, (const void*)&icm_pair_kernel,
                             dim3(ceil_div(W, tw), ceil_div(H, th), R),
                             dim3(threads), smem, args);
}

// One sweep pair from labels into out (labels is not written), on th x tw
// interiors (even) with an 8-pixel border, `threads` threads a block
// owning its 2 x 2 quads (the plan of ops/icm_kernels.py::icm_tile_plan);
// an error for a plan the kernel cannot take. loop may be null (no loop).
extern "C" int phmrf_icm_pair(const int* labels, int* out, const float* unary,
                              const float* w, const int* mask, int R, int K,
                              int H, int W, float beta, int row_parity,
                              int th, int tw, int threads, int* loop,
                              void* stream) {
  size_t smem;
  const cudaError_t plan = icm_pair_plan(K, row_parity, th, tw, threads,
                                         &smem);
  if (plan != cudaSuccess) return (int)plan;
  if ((long)R * H * W == 0) return 0;
  // per device: set it on every call (the card may change between calls)
  const cudaError_t attr = phmrf_prepare_icm_pair(th, tw);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(ceil_div(W, tw), ceil_div(H, th), R);
  icm_pair_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      labels, out, unary, w, mask, K, H, W, th, tw, beta, row_parity, loop);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// K8: the phases of a checkerboard sweep over every row shard of one
// device in one launch.
//
// Replaces phylo_hmrf_tpu/ops/icm_pallas.py::_icm_phase_kernel (entry
// icm_phase_pallas, halo_extended=True), which the JAX package runs once
// per phase and shard between two one-row label exchanges. On the thin
// shards that reach it a phase is a few thousand pixels: one launch a
// shard and phase is almost all launch. Here one cooperative launch runs
// `n_phases` phases from `phase0` (all 4 of a sweep, in the order (0,0),
// (0,1), (1,0), (1,1)) over the shards of the device's table
// (IcmHaloTable, by value), with a grid barrier between phases, and the
// labels updated in place. The rows above and below a shard are read
// where they lie: in the neighbour's own labels when the neighbour is in
// the table, in a one-row buffer copied from another device before the
// launch (then the launch runs one phase), or as label 0 at the ends of
// the mesh (whose edges carry weight 0). A phase never writes the rows it
// reads across a shard boundary: they are of the other row colour. The
// weights are the shard's 1-row-extended (4, H + 2, W) array. A shard's
// colour row parity is that of its global rows: (a + row0) % 2.
//
// One thread per pixel of the active colour, as icm_phase_kernel, with its
// arithmetic op for op (first index on ties): each phase is bitwise one
// phase of that kernel on the shard's rows with the exchanged rows around
// them. Each launch adds the number of labels it changed to `*changed`:
// per warp a ballot count, one integer atomicAdd a warp at the end (the
// same sum in any order). Bound: the launch, the barriers and the latency
// of a phase on thin shards; the bytes of one phase are those of the
// phase kernel's, plus two rows of labels a shard.
// ---------------------------------------------------------------------

#define ICM_HALO_THREADS 256
#define ICM_HALO_COLS 10   // int64 columns of a shard row of the host table

struct IcmHaloShard {
  int* lab;            // (H, W), updated in place
  const float* unary;  // (K, H, W)
  const int* mask;     // (H, W)
  const float* w;      // (4, H + 2, W)
  const int* row[2];   // rows above / below from another device, (W,)
  int nb[2];           // table index of the neighbour above / below, or -1
  int H;               // rows
  int row0;            // parity of the shard's first global row
};

struct IcmHaloTable {
  IcmHaloShard s[PHMRF_HALO_MAX_SHARDS];
  int n;
};

// the label at shard row hh in [-1, H] and column x of shard i
__device__ __forceinline__ int icm_halo_label(const IcmHaloTable& tab, int i,
                                              int hh, int x, int W) {
  const int H = tab.s[i].H;
  if (hh >= 0 && hh < H) return tab.s[i].lab[(long)hh * W + x];
  const int side = hh < 0 ? 0 : 1;
  const int j = tab.s[i].nb[side];
  if (j >= 0)
    return tab.s[j].lab[side == 0 ? (long)(tab.s[j].H - 1) * W + x : x];
  const int* row = tab.s[i].row[side];
  return row != nullptr ? row[x] : 0;
}

// update of the idx-th active pixel of phase (a, b) over the table's
// shards in order; true when its label changed
__device__ __forceinline__ bool icm_halo_update(const IcmHaloTable& tab,
                                                long idx, int K, int W,
                                                int a, int b, int Wc,
                                                float beta) {
  int i = 0, pa = 0;
  long c = idx;
  for (; i < tab.n; ++i) {
    pa = (a + tab.s[i].row0) & 1;
    const long n_i = (long)((tab.s[i].H - pa + 1) / 2) * Wc;
    if (c < n_i) break;
    c -= n_i;
  }
  const int H = tab.s[i].H;
  const int h = 2 * (int)(c / Wc) + pa;
  const int x = 2 * (int)(c % Wc) + b;
  const long HW = (long)H * W, HWe = (long)(H + 2) * W;
  const long p = (long)h * W + x;
  if (__ldg(tab.s[i].mask + p) == 0) return false;
  const float* w = tab.s[i].w + (long)(h + 1) * W + x;   // extended row
  int nb[8];
  float wt[8];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int dr = dir_dr(d), dc = dir_dc(d);
    const bool fok = x + dc >= 0 && x + dc < W;
    const bool bok = x - dc >= 0 && x - dc < W;
    wt[2 * d] = __ldg(w + d * HWe);
    nb[2 * d] = fok ? icm_halo_label(tab, i, h + dr, x + dc, W) : -1;
    wt[2 * d + 1] = bok ? __ldg(w + d * HWe - (long)dr * W - dc) : 0.0f;
    nb[2 * d + 1] = bok ? icm_halo_label(tab, i, h - dr, x - dc, W) : -1;
  }
  const float* u = tab.s[i].unary + p;
  int best = 0;
  float best_score = 0.0f;
  for (int k = 0; k < K; ++k) {
    float agree = 0.0f;
#pragma unroll
    for (int s = 0; s < 8; ++s)
      agree = __fadd_rn(agree, nb[s] == k ? wt[s] : 0.0f);
    const float score = __fsub_rn(__ldg(u + k * HW), __fmul_rn(beta, agree));
    if (k == 0 || score < best_score) {
      best = k;
      best_score = score;
    }
  }
  int* lab = tab.s[i].lab + p;
  if (*lab == best) return false;
  *lab = best;
  return true;
}

// the active pixels of phase (a, b) over the table's shards
__device__ __forceinline__ long icm_halo_active(const IcmHaloTable& tab,
                                                int a, int Wc) {
  long total = 0;
  for (int i = 0; i < tab.n; ++i)
    total += (long)((tab.s[i].H - ((a + tab.s[i].row0) & 1) + 1) / 2) * Wc;
  return total;
}

__global__ void __launch_bounds__(ICM_HALO_THREADS)
icm_halo_kernel(const IcmHaloTable tab, int K, int W, int phase0,
                int n_phases, float beta, int* changed, unsigned* bar) {
  unsigned count = 0;   // labels this warp changed, in every lane
  for (int ph = 0; ph < n_phases; ++ph) {
    if (ph > 0) grid_barrier(bar);   // phase ph reads what ph - 1 wrote
    const int a = (phase0 + ph) >> 1, b = (phase0 + ph) & 1;
    const int Wc = (W - b + 1) / 2;
    const long total = icm_halo_active(tab, a, Wc);
    // warp-aligned starts: every lane of a warp runs the same iterations
    for (long base = (long)blockIdx.x * blockDim.x; base < total;
         base += (long)gridDim.x * blockDim.x) {
      const long idx = base + threadIdx.x;
      const bool ch =
          idx < total && icm_halo_update(tab, idx, K, W, a, b, Wc, beta);
      count += __popc(__ballot_sync(0xffffffffu, ch));
    }
  }
  if ((threadIdx.x & 31) == 0 && count != 0) atomicAdd(changed, (int)count);
}

// Blocks of the largest co-resident grid of K8 on the current device
// (blocks an SM x SMs); a negative CUDA error on failure.
extern "C" int phmrf_icm_halo_grid() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, icm_halo_kernel, ICM_HALO_THREADS, 0);
  if (e != cudaSuccess) return -(int)e;
  return per_sm * sms;
}

// Phases phase0 .. phase0 + n_phases - 1 (of (0,0), (0,1), (1,0), (1,1))
// of the n shards of `shards` (ICM_HALO_COLS int64 a shard: labels, unary,
// mask, w, row above, row below, neighbour above, neighbour below, H, first
// global row; all on the current device) in one cooperative launch; adds
// the labels changed to *changed; `bar` a zeroed word of this stream. An
// error when the table or the grid cannot be taken.
extern "C" int phmrf_icm_halo(const long long* shards, int n, int K, int W,
                              int phase0, int n_phases, float beta,
                              int* changed, unsigned* bar, void* stream) {
  if (n < 1 || n > PHMRF_HALO_MAX_SHARDS || K < 1 || K > PHMRF_KMAX ||
      W < 1 || phase0 < 0 || n_phases < 1 || phase0 + n_phases > 4)
    return (int)cudaErrorInvalidValue;
  IcmHaloTable tab;
  tab.n = n;
  long most = 0;   // active pixels of the largest phase
  for (int i = 0; i < n; ++i) {
    const long long* r = shards + (long)i * ICM_HALO_COLS;
    IcmHaloShard& sh = tab.s[i];
    sh.lab = (int*)r[0];
    sh.unary = (const float*)r[1];
    sh.mask = (const int*)r[2];
    sh.w = (const float*)r[3];
    sh.row[0] = (const int*)r[4];
    sh.row[1] = (const int*)r[5];
    sh.nb[0] = (int)r[6];
    sh.nb[1] = (int)r[7];
    sh.H = (int)r[8];
    sh.row0 = (int)(r[9] & 1);
    if (sh.H < 1 || sh.nb[0] >= n || sh.nb[1] >= n)
      return (int)cudaErrorInvalidValue;
  }
  for (int ph = phase0; ph < phase0 + n_phases; ++ph) {
    long total = 0;
    for (int i = 0; i < n; ++i)
      total += (long)((tab.s[i].H - (((ph >> 1) + tab.s[i].row0) & 1) + 1) /
                      2) * ((W - (ph & 1) + 1) / 2);
    most = total > most ? total : most;
  }
  const int grid_max = phmrf_icm_halo_grid();
  if (grid_max < 0) return -grid_max;
  if (grid_max == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long want = (most + ICM_HALO_THREADS - 1) / ICM_HALO_THREADS;
  const int grid = (int)(want < grid_max ? (want > 0 ? want : 1) : grid_max);
  void* args[] = {&tab, &K, &W, &phase0, &n_phases, &beta, &changed, &bar};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)icm_halo_kernel, dim3(grid), dim3(ICM_HALO_THREADS), args,
      0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
