// K3 (Potts energy) and K4 (fused posterior / cost / sufficient-stats pass).
//
// K3 replaces phylo_hmrf_tpu/ops/finish_pallas.py::_energy_kernel (entry
// potts_energy_pallas); K4 replaces ::_finish_kernel (entry
// finish_stats_pallas). Both only reduce: their outputs are a few numbers
// per region.
//
// One launch per call. The grid is sized to the card (RED_BLOCKS blocks
// over all regions, blockIdx.y the region) and each block walks its
// region's pixels with a grid stride. Each block writes its float64 sums
// to its own slot; the last block of a region to finish (an atomicAdd
// ticket after __threadfence) adds that region's slots in block-index
// order, writes the outputs and resets the ticket to 0 for the next call.
// The TPU kernels accumulate in a sequential grid; here every sum has an
// order fixed by the shape alone (per-thread or per-lane in pixel order,
// fixed shuffle trees, warps in warp order, blocks in block order), never
// by block scheduling, and no float atomics: repeated calls are bitwise
// equal. Per-pixel terms are float32, as in the plain version.
//
// Bound: memory. K3 reads per pixel the mask, the labels (and a
// neighbour's, mostly from L1), 4 weights and one unary value per
// labeling: a handful of double adds. K4 reads K + F + 10 words per pixel;
// its statistics are K (1 + F + F (F + 1) / 2) float64 multiply-adds per
// valid pixel (obs2 only for f <= g, mirrored when written), ~150 at K=10,
// F=4, which the float64 tensor cores take in a few us for a chr21 grid.
// What holds K4 above its bytes is the latency of the per-pixel phase
// (two softmaxes over K states, each a chain of loads, exp and divides),
// hidden only as far as its warps fit in shared memory.
#include "common.cuh"

#define RED_BLOCKS 132  // blocks of one launch (an SM each on the H100)
#define FULL_MASK 0xffffffffu

// Each region's ticket: the last block is the one that sees G - 1.
__device__ __forceinline__ bool last_block_of_region(unsigned* ticket,
                                                     int G) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == (unsigned)(G - 1);
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// ---------------------------------------------------------------- K3 ----
//
// NL labelings (1, or 2 for the pair entry) over the same unary, mask and
// weights. Every step of a labeling's sums is the same for NL = 1 and 2,
// so each energy of a pair is bitwise the single call's on that labeling.

#define E_THREADS 1024

template <int NL>
__global__ void __launch_bounds__(E_THREADS, 1)
energy_kernel(const float* __restrict__ unary, const int* __restrict__ mask,
              const int* __restrict__ lab_a, const int* __restrict__ lab_b,
              const float* __restrict__ w, double* __restrict__ partial,
              unsigned* __restrict__ tickets, float* __restrict__ out, int R,
              int K, int H, int W, float beta) {
  __shared__ double warp_sums[2 * NL][E_THREADS / 32];
  const int r = blockIdx.y, G = gridDim.x;
  const long HW = (long)H * W;
  const float* u_r = unary + (long)r * K * HW;
  const int* m_r = mask + (long)r * HW;
  const float* w_r = w + (long)r * 4 * HW;
  const int* l_r[NL];
  l_r[0] = lab_a + (long)r * HW;
  if (NL == 2) l_r[NL - 1] = lab_b + (long)r * HW;

  double eu[NL], ep[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) eu[l] = ep[l] = 0.0;
  for (long p = (long)blockIdx.x * E_THREADS + threadIdx.x; p < HW;
       p += (long)G * E_THREADS) {
    const int h = (int)p / W, x = (int)p % W;
    const bool valid = m_r[p] != 0;
    float wd[4];
    long nb[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      // forward edges only: each edge counted once, at its source pixel;
      // a neighbour outside the grid counts as different (its w is 0)
      const int nh = h + dir_dr(d), nw = x + dir_dc(d);
      nb[d] = (nh >= 0 && nh < H && nw >= 0 && nw < W) ? (long)nh * W + nw
                                                       : -1;
      wd[d] = w_r[d * HW + p];
    }
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int s = l_r[l][p];
      if (valid && s >= 0 && s < K) eu[l] += (double)u_r[(long)s * HW + p];
#pragma unroll
      for (int d = 0; d < 4; ++d)
        if (nb[d] < 0 || l_r[l][nb[d]] != s) ep[l] += (double)wd[d];
    }
  }
  // the warp's sums by a shuffle tree of fixed shape, then the warps in
  // warp order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      eu[l] += __shfl_down_sync(FULL_MASK, eu[l], o);
      ep[l] += __shfl_down_sync(FULL_MASK, ep[l], o);
    }
    if (lane == 0) {
      warp_sums[2 * l][warp] = eu[l];
      warp_sums[2 * l + 1][warp] = ep[l];
    }
  }
  __syncthreads();
  double* slots = partial + (long)r * G * 2 * NL;
  if (threadIdx.x < 2 * NL) {
    double s = 0.0;
    for (int i = 0; i < E_THREADS / 32; ++i) s += warp_sums[threadIdx.x][i];
    slots[(long)blockIdx.x * 2 * NL + threadIdx.x] = s;
  }
  if (!last_block_of_region(&tickets[r], G)) return;
  if (threadIdx.x < 2 * NL) {
    double s = 0.0;
#pragma unroll 8
    for (int b = 0; b < G; ++b)
      s += __ldcg(slots + (long)b * 2 * NL + threadIdx.x);
    warp_sums[threadIdx.x][0] = s;
  }
  __syncthreads();
  if (threadIdx.x < NL) {
    const int l = threadIdx.x;
    // e_u + beta * e_p in float64, rounded once: the plain version's steps
    out[(long)l * R + r] = (float)__dadd_rn(
        warp_sums[2 * l][0], __dmul_rn((double)beta, warp_sums[2 * l + 1][0]));
  }
  if (threadIdx.x == 0) tickets[r] = 0;
}

static int energy_grid(int R, long HW) {
  const int per_region = RED_BLOCKS / R > 1 ? RED_BLOCKS / R : 1;
  const int need = ceil_div(HW, E_THREADS);
  return need < per_region ? need : per_region;
}

// doubles of the partial-sum buffer of a call (the same for 1 and 2
// labelings: 4 per block)
extern "C" int phmrf_energy_slots(int R, int H, int W) {
  return 4 * R * energy_grid(R, (long)H * W);
}

// labels_b null: one labeling, out (R,); else out (2, R).
extern "C" int phmrf_potts_energy(const float* unary, const int* mask,
                                  const int* labels_a, const int* labels_b,
                                  const float* w, double* partial,
                                  unsigned* tickets, float* out, int R, int K,
                                  int H, int W, float beta, void* stream) {
  if (K < 1 || R < 1 || R > 65535 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(energy_grid(R, (long)H * W), R);
  cudaStream_t st = (cudaStream_t)stream;
  if (labels_b == nullptr)
    energy_kernel<1><<<grid, E_THREADS, 0, st>>>(unary, mask, labels_a,
                                                 labels_a, w, partial,
                                                 tickets, out, R, K, H, W,
                                                 beta);
  else
    energy_kernel<2><<<grid, E_THREADS, 0, st>>>(unary, mask, labels_a,
                                                 labels_b, w, partial,
                                                 tickets, out, R, K, H, W,
                                                 beta);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K4 ----
//
// Per valid pixel p with MAP label s (labels fixed by the E-step):
//   pp_k  = beta * (wsum - agree_k)              (pairwise potential)
//   g_k   = softmax_k(logprob_k - pp_k)           (posterior)
//   ppn_k = softmax_k(-pp_k)
// and per region: post_k = sum g_k, obs_kf = sum g_k x_f,
// obs2_kfg = sum g_k x_f x_g, and sums = [pp_s, log(ppn_s + eps),
// logprob_s, 1] over valid pixels. With `negate` the field passed is the
// unary (-logprob) and is flipped here (IEEE negation is exact), so the
// caller needs no second K-major tensor.
//
// Output row of a region: [post (K) | obs (K*F) | obs2 (K*F*F) | sums (4) |
// 0 (4)].
//
// Accumulation. A warp takes 32 consecutive pixels at a time, one a lane;
// a batch with no valid pixel is skipped by a warp vote (the next batch's
// mask is loaded before the vote of this one). Each lane stages its
// pixel's a = [g_0 .. g_{K-1}, 1] and b = [1, x_f (F), x_f x_g (f <= g),
// the 4 cost terms] in float64, converted once, as column `lane` of
// transposed planes at (K + 1 rows) and bt (P + 4 rows), zeros for an
// invalid pixel. The statistics are then at . bt^T over the batch's
// pixels: the float64 tensor-core product mma.m8n8k4 (8 states x 8 b
// columns x 4 pixels) accumulates every 8 x 8 tile of it in the lanes'
// registers, skipping groups of 4 pixels with no valid one. Rows are
// F_ROW = 36 doubles apart: a lane's column writes and the fragment reads
// (4 pixels x 8 rows) both fall in distinct banks. Between batches the
// tiles stay in registers (TG of them; where more tiles than that are
// needed, K and F near PHMRF_KMAX and PHMRF_FMAX, each group's rest in
// the warp's shared accumulator), so the whole range of K and F runs. The
// per-pixel terms pass through shared memory too (pp and the field at k,
// as a float pair in a's slot), so no K-sized register array is held.
// The order of every sum is fixed by the shape: tiles in pixel-group
// order, the warps in warp order, the blocks in block order.

#define F_WARPS 24   // warps of a block, fewer where shared memory is short
#define F_WARPS_WIDE 16   // the same for 7 or 8 tiles a lane (more registers)
#define F_TG 8       // 8 x 8 tiles a lane holds in registers at once

// the warps of a block whose lanes hold TG tiles: the per-pixel phase is
// bound by latency, not issue (on an H100, 16 warps took 1.33x the time
// of 24 on the chr21 grid), and 80 registers hold up to 6 tiles without
// spills
#define F_BLOCK_WARPS(TG) ((TG) >= 7 ? F_WARPS_WIDE : F_WARPS)
#define F_ROW 36     // doubles between two rows of a staged plane

struct FinishPlan {
  int P;      // b's length before the cost terms: 1 + F + F (F + 1) / 2
  int NTM;    // 8-row tiles of a (K + 1 rows) and of b (P + 4 rows)
  int NTN;
  int TG;     // tiles a lane holds in registers
  int NG;     // groups of TG tiles
  int NOP;    // outputs summed, K P + 4, padded to 32
  int NW;     // warps per block
  int G;      // blocks per region
  int per_warp;   // doubles of a warp's shared memory
  size_t smem;
};

static FinishPlan finish_plan(int R, int K, int F, long HW) {
  FinishPlan q;
  q.P = 1 + F + F * (F + 1) / 2;
  q.NTM = ceil_div(K + 1, 8);
  q.NTN = ceil_div(q.P + 4, 8);
  const int T = q.NTM * q.NTN;
  q.TG = T < F_TG ? T : F_TG;
  q.NG = ceil_div(T, q.TG);
  q.NOP = 32 * ceil_div(K * q.P + 4, 32);
  // staging; with one group the tiles are dumped over it at the end, with
  // more they rest in a region of their own between batches
  const int staging = (K + 1 + q.P + 4) * F_ROW;
  q.per_warp = q.NG == 1 ? (staging > 64 * T ? staging : 64 * T)
                         : staging + 64 * T;
  // the fragment reads of the last tiles run up to 7 rows past a plane
  const size_t pad = sizeof(double) * 8 * F_ROW;
  const int fit =
      (int)((PHMRF_SMEM_MAX - pad) / (sizeof(double) * q.per_warp));
  q.NW = fit < F_BLOCK_WARPS(q.TG) ? fit : F_BLOCK_WARPS(q.TG);
  q.smem = sizeof(double) * (size_t)q.NW * q.per_warp + pad;
  const int per_region = RED_BLOCKS / R > 1 ? RED_BLOCKS / R : 1;
  const int need = ceil_div(ceil_div(HW, 32), q.NW);
  q.G = need < per_region ? need : per_region;
  return q;
}

// d += a . b on an 8 x 8 float64 tile over 4 pixels (mma.m8n8k4): lane l
// holds a[l / 4][l % 4] (state, pixel), b[l % 4][l / 4] (pixel, column)
// and d[l / 4][2 (l % 4) + i].
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%4, %5};\n"
      : "=d"(d0), "=d"(d1)
      : "d"(a), "d"(b), "d"(d0), "d"(d1));
}

template <int TG>
__global__ void __launch_bounds__(F_BLOCK_WARPS(TG) * 32, 1)
finish_kernel(const float* __restrict__ lp, const float* __restrict__ img,
              const int* __restrict__ mask, const int* __restrict__ labels,
              const float* __restrict__ w, double* __restrict__ partial,
              unsigned* __restrict__ tickets, void* __restrict__ out, int K,
              int F, int H, int W, float beta, float small_eps, int negate,
              int out_f64, int P, int NTN, int T, int NG, int per_warp,
              int NOP) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NW = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const int r = blockIdx.y, G = gridDim.x;
  const int KP = K * P, NO = KP + 4;
  const long HW = (long)H * W;
  double* const smem = reinterpret_cast<double*>(smem_raw);
  double* const at = smem + warp * per_warp;   // at[k * F_ROW + pixel]
  double* const bt = at + (K + 1) * F_ROW;     // bt[j * F_ROW + pixel]
  // a tile's 64 sums, lane l's two at 8 (l / 4) + 2 (l % 4) + i
  double* const acc = NG == 1 ? at : bt + (P + 4) * F_ROW;
  const int frag = (lane >> 2) * 8 + (lane & 3) * 2;
  if (NG > 1)
    for (int i = lane; i < 64 * T; i += 32) acc[i] = 0.0;

  const float* lp_r = lp + (long)r * K * HW;
  const float* x_r = img + (long)r * F * HW;
  const int* m_r = mask + (long)r * HW;
  const int* l_r = labels + (long)r * HW;
  const float* w_r = w + (long)r * 4 * HW;
  double* const a_col = at + lane;
  double* const b_col = bt + lane;
  const long n_batches = (HW + 31) >> 5, stride = (long)G * NW;

  double c[TG][2];
#pragma unroll
  for (int t = 0; t < TG; ++t) c[t][0] = c[t][1] = 0.0;
  long bt_i = (long)blockIdx.x * NW + warp;
  long p = (bt_i << 5) + lane;
  int m_next = bt_i < n_batches && p < HW ? m_r[p] : 0;
  for (; bt_i < n_batches; bt_i += stride) {
    p = (bt_i << 5) + lane;
    const bool valid = m_next != 0;
    const long pn = p + (stride << 5);
    m_next = pn < HW ? m_r[pn] : 0;
    const unsigned vote = __ballot_sync(FULL_MASK, valid);
    if (vote == 0) continue;
    if (valid) {
      const int h = (int)p / W, x = (int)p % W;
      Nbrs n;
      load_nbrs(w_r, H, W, h, x, n);
      int nb[8];
      float wsum = 0.0f;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        nb[s] = n.ok[s] ? l_r[n.off[s]] : -1;
        wsum = __fadd_rn(wsum, n.wt[s]);
      }
      const int lab = l_r[p];
      float xv[PHMRF_FMAX];
#pragma unroll
      for (int f = 0; f < PHMRF_FMAX; ++f)
        if (f < F) xv[f] = x_r[(long)f * HW + p];
      // pp_k and the field at k, kept as a float pair in a's slot k
      float m1 = -INFINITY, m2 = -INFINITY;
#pragma unroll
      for (int k = 0; k < PHMRF_KMAX; ++k) {
        if (k < K) {
          float agree = 0.0f;
#pragma unroll
          for (int s = 0; s < 8; ++s)
            agree = __fadd_rn(agree, nb[s] == k ? n.wt[s] : 0.0f);
          const float pp = __fmul_rn(beta, __fsub_rn(wsum, agree));
          const float v = lp_r[(long)k * HW + p];
          const float lk = negate ? -v : v;
          m1 = fmaxf(m1, __fsub_rn(lk, pp));
          m2 = fmaxf(m2, -pp);
          *reinterpret_cast<float2*>(a_col + k * F_ROW) = make_float2(pp, lk);
        }
      }
      float s1 = 0.0f, s2 = 0.0f, e2_lab = 0.0f, pp_lab = 0.0f, lp_lab = 0.0f;
      for (int k = 0; k < K; ++k) {
        const float2 t = *reinterpret_cast<const float2*>(a_col + k * F_ROW);
        const float e1 = expf(__fsub_rn(__fsub_rn(t.y, t.x), m1));
        const float e2 = expf(__fsub_rn(-t.x, m2));
        a_col[k * F_ROW] = (double)e1;
        s1 = __fadd_rn(s1, e1);
        s2 = __fadd_rn(s2, e2);
        if (k == lab) {
          e2_lab = e2;
          pp_lab = t.x;
          lp_lab = t.y;
        }
      }
      for (int k = 0; k < K; ++k)
        a_col[k * F_ROW] =
            (double)__fdiv_rn((float)a_col[k * F_ROW], s1);
      a_col[K * F_ROW] = 1.0;
      b_col[0] = 1.0;
      int j = 1;
#pragma unroll
      for (int f = 0; f < PHMRF_FMAX; ++f)
        if (f < F) b_col[F_ROW * j++] = (double)xv[f];
      // x_f x_g for f <= g, row-major; exact in float64
#pragma unroll
      for (int f = 0; f < PHMRF_FMAX; ++f)
#pragma unroll
        for (int g = f; g < PHMRF_FMAX; ++g)
          if (g < F) b_col[F_ROW * j++] = (double)xv[f] * (double)xv[g];
      const bool in_range = lab >= 0 && lab < K;
      const float ppn_lab = in_range ? __fdiv_rn(e2_lab, s2) : 0.0f;
      b_col[F_ROW * P] = (double)pp_lab;
      b_col[F_ROW * (P + 1)] = (double)logf(__fadd_rn(ppn_lab, small_eps));
      b_col[F_ROW * (P + 2)] = (double)lp_lab;
      b_col[F_ROW * (P + 3)] = 1.0;
    } else {
      for (int k = 0; k <= K; ++k) a_col[k * F_ROW] = 0.0;
      for (int j = 0; j < P + 4; ++j) b_col[j * F_ROW] = 0.0;
    }
    __syncwarp();
    for (int g = 0; g < NG; ++g) {
      int a_off[TG], b_off[TG];
#pragma unroll
      for (int t = 0; t < TG; ++t) {
        const int tile = g * TG + t, mt = tile / NTN, nt = tile - mt * NTN;
        a_off[t] = (mt * 8 + (lane >> 2)) * F_ROW + (lane & 3);
        b_off[t] = (nt * 8 + (lane >> 2)) * F_ROW + (lane & 3);
        if (NG > 1 && tile < T) {
          c[t][0] = acc[tile * 64 + frag];
          c[t][1] = acc[tile * 64 + frag + 1];
        }
      }
      for (int s = 0; s < 8; ++s) {
        if (((vote >> (4 * s)) & 15u) == 0) continue;
#pragma unroll
        for (int t = 0; t < TG; ++t)
          if (g * TG + t < T)
            mma_f64(c[t][0], c[t][1], at[a_off[t] + 4 * s],
                    bt[b_off[t] + 4 * s]);
      }
      if (NG > 1) {
#pragma unroll
        for (int t = 0; t < TG; ++t) {
          const int tile = g * TG + t;
          if (tile < T) {
            acc[tile * 64 + frag] = c[t][0];
            acc[tile * 64 + frag + 1] = c[t][1];
          }
        }
      }
    }
    __syncwarp();
  }
  if (NG == 1) {
#pragma unroll
    for (int t = 0; t < TG; ++t) {
      if (t < T) {
        acc[t * 64 + frag] = c[t][0];
        acc[t * 64 + frag + 1] = c[t][1];
      }
    }
  }

  // the block's sums: its warps in warp order, into the block's slot
  __syncthreads();
  const int acc0 = NG == 1 ? 0 : (K + 1 + P + 4) * F_ROW;
  double* const slots = partial + (long)r * G * NOP;
  for (int o = threadIdx.x; o < NO; o += blockDim.x) {
    const int k = o < KP ? o / P : K, j = o < KP ? o - k * P : P + o - KP;
    const int idx = acc0 + ((k >> 3) * NTN + (j >> 3)) * 64 + (k & 7) * 8 +
                    (j & 7);
    double s = 0.0;
    for (int i = 0; i < NW; ++i) s += smem[i * per_warp + idx];
    slots[(long)blockIdx.x * NOP + o] = s;
  }
  if (!last_block_of_region(&tickets[r], G)) return;

  // the region's sums: the blocks in block order, rounded once
  const int nstat = K * (1 + F + F * F);
  const long row = (long)r * (nstat + 8);
  float* const o32 = static_cast<float*>(out) + row;
  double* const o64 = static_cast<double*>(out) + row;
  for (int o = threadIdx.x; o < NO + 4; o += blockDim.x) {
    double s = 0.0;
    if (o < NO) {
#pragma unroll 8
      for (int b = 0; b < G; ++b) s += __ldcg(slots + (long)b * NOP + o);
    }
    int c0, c1 = -1;
    if (o < KP) {
      const int k = o / P, j = o - k * P;
      if (j == 0) {
        c0 = k;
      } else if (j <= F) {
        c0 = K + k * F + j - 1;
      } else {
        int q = j - 1 - F, f = 0;
        while (q >= F - f) q -= F - f++;
        const int g = f + q, base = K + K * F + k * F * F;
        c0 = base + f * F + g;
        c1 = base + g * F + f;
      }
    } else {
      c0 = nstat + o - KP;   // the 4 sums, then 4 zeros
    }
    if (out_f64) {
      o64[c0] = s;
      if (c1 >= 0) o64[c1] = s;
    } else {
      o32[c0] = (float)s;
      if (c1 >= 0) o32[c1] = (float)s;
    }
  }
  if (threadIdx.x == 0) tickets[r] = 0;
}

// doubles of the partial-sum buffer of a call
extern "C" int phmrf_finish_slots(int R, int K, int F, int H, int W) {
  const FinishPlan q = finish_plan(R, K, F, (long)H * W);
  return R * q.G * q.NOP;
}

#define FINISH_LAUNCH(M)                                                    \
  case M: {                                                                 \
    const cudaError_t attr = cudaFuncSetAttribute(                          \
        finish_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,      \
        (int)q.smem);                                                       \
    if (attr != cudaSuccess) return (int)attr;                              \
    finish_kernel<M><<<grid, q.NW * 32, q.smem, st>>>(                      \
        lp, img, mask, labels, w, partial, tickets, out, K, F, H, W, beta,  \
        small_eps, negate, out_f64, q.P, q.NTN, q.NTM * q.NTN, q.NG,        \
        q.per_warp, q.NOP);                                                 \
    break;                                                                  \
  }

// out (R, K (1 + F + F^2) + 8), float32 or, with out_f64, float64 for
// callers that add up several calls' sums (the row shards of one region)
// before rounding once
extern "C" int phmrf_finish_stats(const float* lp, const float* img,
                                  const int* mask, const int* labels,
                                  const float* w, double* partial,
                                  unsigned* tickets, void* out, int R, int K,
                                  int F, int H, int W, float beta,
                                  float small_eps, int negate, int out_f64,
                                  void* stream) {
  if (K < 1 || K > PHMRF_KMAX || F < 1 || F > PHMRF_FMAX || R < 1 ||
      R > 65535 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const FinishPlan q = finish_plan(R, K, F, (long)H * W);
  const dim3 grid(q.G, R);
  cudaStream_t st = (cudaStream_t)stream;
  switch (q.TG) {
    FINISH_LAUNCH(1)
    FINISH_LAUNCH(2)
    FINISH_LAUNCH(3)
    FINISH_LAUNCH(4)
    FINISH_LAUNCH(5)
    FINISH_LAUNCH(6)
    FINISH_LAUNCH(7)
    FINISH_LAUNCH(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
