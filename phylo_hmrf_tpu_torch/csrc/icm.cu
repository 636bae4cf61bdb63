// K2 and K8: checkerboard ICM on K-major fields.
//
// K2 is icm_pair_kernel below (the eight phases of a sweep pair in one
// launch, on shared-memory tiles); it replaces phylo_hmrf_tpu/ops/
// icm_pallas.py::_icm_sweeppair_kernel (entry _icm_sweep_pair_padded,
// driven by icm_pallas), which runs the phases (a, b) in (0,0), (0,1),
// (1,0), (1,1) twice on a VMEM slab. icm_phase_kernel, one phase a launch
// with the labels updated in place, is K8 with halo = 1: it replaces
// _icm_phase_kernel (entry icm_phase_pallas, halo_extended=True), the
// phase of a row shard between two one-row label exchanges; with halo = 0
// eight launches of it are the chained reference K2 is held to
// (ops/icm_kernels.py::icm_sweep_pair_chained). Pixels of colour
// (row % 2, col % 2) == (a, b) are never 8-neighbours of each other, so a
// phase may write its pixels in place: no thread reads a pixel another
// thread of the phase writes.
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
//
// Halo rows: with halo = 1, labels and w are (R, ., H + 2, W) arrays whose
// first and last rows hold the neighbouring shards' boundary rows (zeros
// at the ends of the mesh), while unary and mask hold only the H center
// rows. The threads cover the center colour; labels and w are read, and
// labels written, at row h + halo of the extended array, whose height
// bounds the neighbour guard; the halo rows are never written. The colour
// row parity pa is that of the center row h: a shard passes its global
// parity, (a + first global row) % 2. K8 moves what one phase of the whole
// grid moves, plus two rows of labels and w per shard.
#include "common.cuh"

__global__ void icm_phase_kernel(int* __restrict__ labels,
                                 const float* __restrict__ unary,
                                 const float* __restrict__ w,
                                 const int* __restrict__ mask, int R, int K,
                                 int H, int W, int halo, float beta, int pa,
                                 int pb) {
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
  const int He = H + 2 * halo;          // rows of labels and w
  const long HWe = (long)He * W;

  Nbrs n;
  load_nbrs(w + (long)r * 4 * HWe, He, W, h + halo, x, n);
  int* lab_r = labels + (long)r * HWe;
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
  lab_r[p + (long)halo * W] = best;
}

extern "C" int phmrf_icm_phase(int* labels, const float* unary,
                               const float* w, const int* mask, int R, int K,
                               int H, int W, int halo, float beta, int pa,
                               int pb, void* stream) {
  if (K < 1 || K > PHMRF_KMAX || (pa & ~1) || (pb & ~1) || (halo & ~1))
    return (int)cudaErrorInvalidValue;
  const long n = (long)R * ((H - pa + 1) / 2) * ((W - pb + 1) / 2);
  if (n <= 0) return 0;
  const int threads = 256;
  icm_phase_kernel<<<ceil_div(n, threads), threads, 0, (cudaStream_t)stream>>>(
      labels, unary, w, mask, R, K, H, W, halo, beta, pa, pb);
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
// `flag` is given, it is set to `tag` iff some label of the grid changed
// over the pair.
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
                int TW, float beta, int row_parity, int* __restrict__ flag,
                int tag) {
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
      k0[i] = upd ? 0 : ICM_SKIP;
#pragma unroll
      for (int d = 0; d < 4; ++d)
        cp_async_f32(wf + d * NPX + i, w + (r * 4 + d) * HW + p, in);
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
  for (int ph = 0; ph < 8; ++ph) {
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
  // every thread reaches the vote; one store per block that saw a change
  if (__syncthreads_or(changed) && threadIdx.x == 0 && flag) *flag = tag;
}

// One sweep pair from labels into out (labels is not written), on th x tw
// interiors (even) with an 8-pixel border, `threads` threads a block
// owning its 2 x 2 quads (the plan of ops/icm_kernels.py::icm_tile_plan);
// an error for a plan the kernel cannot take. flag may be null.
extern "C" int phmrf_icm_pair(const int* labels, int* out, const float* unary,
                              const float* w, const int* mask, int R, int K,
                              int H, int W, float beta, int row_parity,
                              int th, int tw, int threads, int* flag, int tag,
                              void* stream) {
  if (K < 1 || K > PHMRF_KMAX || (row_parity & ~1) || th < 2 || tw < 2 ||
      ((th | tw) & 1) || threads < 32 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  const int lh = th + 2 * PHMRF_ICM_HALO, lw = tw + 2 * PHMRF_ICM_HALO;
  const size_t smem = sizeof(float) * 7 * (size_t)lh * lw;
  if (ceil_div((long)lh * lw / 4, threads) > ICM_QP || smem > PHMRF_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if ((long)R * H * W == 0) return 0;
  // per device: set it on every call (the card may change between calls)
  const cudaError_t attr = cudaFuncSetAttribute(
      icm_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(ceil_div(W, tw), ceil_div(H, th), R);
  icm_pair_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      labels, out, unary, w, mask, K, H, W, th, tw, beta, row_parity, flag,
      tag);
  return (int)cudaGetLastError();
}
