// K3 (Potts energy) and K4 (fused posterior / cost / sufficient-stats pass).
//
// K3 replaces phylo_hmrf_tpu/ops/finish_pallas.py::_energy_kernel (entry
// potts_energy_pallas); K4 replaces ::_finish_kernel (entry
// finish_stats_pallas). Both only reduce: their outputs are a few numbers
// per region.
//
// Determinism. The TPU kernels accumulate in a sequential grid; on this
// card blocks run in any order, and float atomics would make two fits
// differ. So each block (one region, one tile of rows) writes its partial
// sums to its own slot, and a second launch adds the slots of a region in
// tile order. Inside a block the order is fixed too: K3 by a shared-memory
// tree of fixed shape, K4 by one owner thread per output that walks a
// chunk's pixels in order. Partials are float64, so the reduction order
// costs nothing measurable; per-pixel terms are float32, as in the plain
// version.
//
// Bound: memory for K3 (K + 8 floats and 9 labels per pixel, a handful of
// flops); K4 reads as much and does ~K*(1+F+F^2) multiply-adds per pixel
// for the statistics, which here run in float64 from shared memory: at
// K=10, F=4 that is 210 outputs per block, held in a shared-memory
// accumulator with one owning thread each (too many to keep in registers).
#include "common.cuh"

#define E_TILE_ROWS 2
#define E_THREADS 256
#define F_TILE_ROWS 2
#define F_CHUNK 128   // pixels per chunk = threads per K4 block
#define F_NOUT_MAX (PHMRF_KMAX * (1 + PHMRF_FMAX + PHMRF_FMAX * PHMRF_FMAX) + 4)

// ---------------------------------------------------------------- K3 ----

__global__ void energy_tile_kernel(const float* __restrict__ unary,
                                   const int* __restrict__ mask,
                                   const int* __restrict__ labels,
                                   const float* __restrict__ w,
                                   double* __restrict__ partial, int K, int H,
                                   int W) {
  __shared__ double sh_u[E_THREADS];
  __shared__ double sh_p[E_THREADS];
  const int t = blockIdx.x, r = blockIdx.y, n_tiles = gridDim.x;
  const long HW = (long)H * W;
  const int h0 = t * E_TILE_ROWS;
  const int rows = min(E_TILE_ROWS, H - h0);
  const long tile_n = (long)rows * W;
  const float* u_r = unary + (long)r * K * HW;
  const int* m_r = mask + (long)r * HW;
  const int* l_r = labels + (long)r * HW;
  const float* w_r = w + (long)r * 4 * HW;

  double eu = 0.0, ep = 0.0;
  for (long i = threadIdx.x; i < tile_n; i += blockDim.x) {
    const int h = h0 + (int)(i / W);
    const int x = (int)(i % W);
    const long p = (long)h * W + x;
    const int s = l_r[p];
    if (m_r[p] != 0 && s >= 0 && s < K) eu += (double)u_r[(long)s * HW + p];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      // forward edges only: each edge counted once, at its source pixel;
      // a neighbour outside the grid counts as different (its w is 0)
      const int nh = h + dir_dr(d), nw = x + dir_dc(d);
      const bool in = nh >= 0 && nh < H && nw >= 0 && nw < W;
      if (!in || l_r[(long)nh * W + nw] != s) ep += (double)w_r[d * HW + p];
    }
  }
  sh_u[threadIdx.x] = eu;
  sh_p[threadIdx.x] = ep;
  __syncthreads();
  for (int stride = E_THREADS / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      sh_u[threadIdx.x] += sh_u[threadIdx.x + stride];
      sh_p[threadIdx.x] += sh_p[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partial[((long)r * n_tiles + t) * 2] = sh_u[0];
    partial[((long)r * n_tiles + t) * 2 + 1] = sh_p[0];
  }
}

__global__ void energy_reduce_kernel(const double* __restrict__ partial,
                                     float* __restrict__ out, int R,
                                     int n_tiles, float beta) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  double eu = 0.0, ep = 0.0;
  for (int t = 0; t < n_tiles; ++t) {
    eu += partial[((long)r * n_tiles + t) * 2];
    ep += partial[((long)r * n_tiles + t) * 2 + 1];
  }
  out[r] = (float)(eu + (double)beta * ep);
}

extern "C" int phmrf_energy_tiles(int H) { return ceil_div(H, E_TILE_ROWS); }

extern "C" int phmrf_potts_energy(const float* unary, const int* mask,
                                  const int* labels, const float* w,
                                  double* partial, float* out, int R, int K,
                                  int H, int W, float beta, void* stream) {
  if (K < 1 || R < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int n_tiles = ceil_div(H, E_TILE_ROWS);
  cudaStream_t st = (cudaStream_t)stream;
  energy_tile_kernel<<<dim3(n_tiles, R), E_THREADS, 0, st>>>(
      unary, mask, labels, w, partial, K, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  energy_reduce_kernel<<<ceil_div(R, 128), 128, 0, st>>>(partial, out, R,
                                                         n_tiles, beta);
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
// Output row of a region: [post (K) | obs (K*F) | obs2 (K*F*F) | sums (4)].

__global__ void finish_tile_kernel(const float* __restrict__ lp,
                                   const float* __restrict__ img,
                                   const int* __restrict__ mask,
                                   const int* __restrict__ labels,
                                   const float* __restrict__ w,
                                   double* __restrict__ partial, int K, int F,
                                   int H, int W, float beta, float small_eps,
                                   int negate) {
  __shared__ double acc[F_NOUT_MAX];
  __shared__ float gsh[PHMRF_KMAX * F_CHUNK];
  __shared__ float xsh[PHMRF_FMAX * F_CHUNK];
  __shared__ float ssh[4 * F_CHUNK];
  const int tid = threadIdx.x;
  const int t = blockIdx.x, r = blockIdx.y, n_tiles = gridDim.x;
  const int nstat = K * (1 + F + F * F);
  const int nout = nstat + 4;
  const long HW = (long)H * W;
  const int h0 = t * F_TILE_ROWS;
  const int rows = min(F_TILE_ROWS, H - h0);
  const long tile_n = (long)rows * W;
  const float* lp_r = lp + (long)r * K * HW;
  const float* x_r = img + (long)r * F * HW;
  const int* m_r = mask + (long)r * HW;
  const int* l_r = labels + (long)r * HW;
  const float* w_r = w + (long)r * 4 * HW;

  for (int o = tid; o < nout; o += F_CHUNK) acc[o] = 0.0;

  for (long c0 = 0; c0 < tile_n; c0 += F_CHUNK) {
    const long i = c0 + tid;
    const int h = h0 + (int)(i / W);
    const int x = (int)(i % W);
    const long p = (long)h * W + x;
    const bool valid = i < tile_n && m_r[p] != 0;
    if (valid) {
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
      float pp[PHMRF_KMAX], lk[PHMRF_KMAX];
      float m1 = -INFINITY, m2 = -INFINITY;
#pragma unroll
      for (int k = 0; k < PHMRF_KMAX; ++k) {
        if (k < K) {
          float agree = 0.0f;
#pragma unroll
          for (int s = 0; s < 8; ++s)
            agree = __fadd_rn(agree, nb[s] == k ? n.wt[s] : 0.0f);
          pp[k] = __fmul_rn(beta, __fsub_rn(wsum, agree));
          const float v = lp_r[(long)k * HW + p];
          lk[k] = negate ? -v : v;
          m1 = fmaxf(m1, __fsub_rn(lk[k], pp[k]));
          m2 = fmaxf(m2, -pp[k]);
        }
      }
      float s1 = 0.0f, s2 = 0.0f, e2_lab = 0.0f, pp_lab = 0.0f, lp_lab = 0.0f;
#pragma unroll
      for (int k = 0; k < PHMRF_KMAX; ++k) {
        if (k < K) {
          const float e1 = expf(__fsub_rn(__fsub_rn(lk[k], pp[k]), m1));
          const float e2 = expf(__fsub_rn(-pp[k], m2));
          gsh[k * F_CHUNK + tid] = e1;
          s1 = __fadd_rn(s1, e1);
          s2 = __fadd_rn(s2, e2);
          if (k == lab) {
            e2_lab = e2;
            pp_lab = pp[k];
            lp_lab = lk[k];
          }
        }
      }
      for (int k = 0; k < K; ++k)
        gsh[k * F_CHUNK + tid] = __fdiv_rn(gsh[k * F_CHUNK + tid], s1);
      for (int f = 0; f < F; ++f) xsh[f * F_CHUNK + tid] = x_r[(long)f * HW + p];
      const bool in_range = lab >= 0 && lab < K;
      const float ppn_lab = in_range ? __fdiv_rn(e2_lab, s2) : 0.0f;
      ssh[0 * F_CHUNK + tid] = pp_lab;
      ssh[1 * F_CHUNK + tid] = logf(__fadd_rn(ppn_lab, small_eps));
      ssh[2 * F_CHUNK + tid] = lp_lab;
      ssh[3 * F_CHUNK + tid] = 1.0f;
    } else {
      for (int k = 0; k < K; ++k) gsh[k * F_CHUNK + tid] = 0.0f;
      for (int f = 0; f < F; ++f) xsh[f * F_CHUNK + tid] = 0.0f;
      for (int m = 0; m < 4; ++m) ssh[m * F_CHUNK + tid] = 0.0f;
    }
    __syncthreads();
    // each output has one owner thread, which adds the chunk's pixels in
    // order: the block's sums do not depend on thread scheduling
    for (int o = tid; o < nout; o += F_CHUNK) {
      double s = 0.0;
      if (o < K) {
        const float* g = gsh + o * F_CHUNK;
        for (int j = 0; j < F_CHUNK; ++j) s += (double)g[j];
      } else if (o < K + K * F) {
        const int q = o - K, k = q / F, f = q % F;
        const float* g = gsh + k * F_CHUNK;
        const float* xf = xsh + f * F_CHUNK;
        for (int j = 0; j < F_CHUNK; ++j) s += (double)g[j] * (double)xf[j];
      } else if (o < nstat) {
        const int q = o - K - K * F, k = q / (F * F), ff = q % (F * F);
        const float* g = gsh + k * F_CHUNK;
        const float* xf = xsh + (ff / F) * F_CHUNK;
        const float* xg = xsh + (ff % F) * F_CHUNK;
        for (int j = 0; j < F_CHUNK; ++j)
          s += (double)g[j] * ((double)xf[j] * (double)xg[j]);
      } else {
        const float* v = ssh + (o - nstat) * F_CHUNK;
        for (int j = 0; j < F_CHUNK; ++j) s += (double)v[j];
      }
      acc[o] += s;
    }
    __syncthreads();
  }
  double* out = partial + ((long)r * n_tiles + t) * nout;
  for (int o = tid; o < nout; o += F_CHUNK) out[o] = acc[o];
}

// out is float32, or float64 for callers that add up several calls' sums
// (the row shards of one region) before rounding once
template <typename T>
__global__ void finish_reduce_kernel(const double* __restrict__ partial,
                                     T* __restrict__ out, int R,
                                     int n_tiles, int nout) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)R * nout) return;
  const int r = (int)(idx / nout), o = (int)(idx % nout);
  double s = 0.0;
  for (int t = 0; t < n_tiles; ++t)
    s += partial[((long)r * n_tiles + t) * nout + o];
  out[idx] = (T)s;
}

extern "C" int phmrf_finish_tiles(int H) { return ceil_div(H, F_TILE_ROWS); }

extern "C" int phmrf_finish_stats(const float* lp, const float* img,
                                  const int* mask, const int* labels,
                                  const float* w, double* partial, void* out,
                                  int R, int K, int F, int H, int W,
                                  float beta, float small_eps, int negate,
                                  int out_f64, void* stream) {
  if (K < 1 || K > PHMRF_KMAX || F < 1 || F > PHMRF_FMAX || R < 1 || H < 1 ||
      W < 1)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = ceil_div(H, F_TILE_ROWS);
  const int nout = K * (1 + F + F * F) + 4;
  cudaStream_t st = (cudaStream_t)stream;
  finish_tile_kernel<<<dim3(n_tiles, R), F_CHUNK, 0, st>>>(
      lp, img, mask, labels, w, partial, K, F, H, W, beta, small_eps, negate);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n = (long)R * nout;
  if (out_f64)
    finish_reduce_kernel<double><<<ceil_div(n, 256), 256, 0, st>>>(
        partial, (double*)out, R, n_tiles, nout);
  else
    finish_reduce_kernel<float><<<ceil_div(n, 256), 256, 0, st>>>(
        partial, (float*)out, R, n_tiles, nout);
  return (int)cudaGetLastError();
}
