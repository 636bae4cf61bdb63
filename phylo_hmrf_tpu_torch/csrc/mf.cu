// K1 and K7: damped mean-field (Jacobi) sweeps at temperature T.
//
// K1 is mf_tile_kernel below (up to 8 sweeps a launch on shared-memory
// tiles); it replaces phylo_hmrf_tpu/ops/mf_pallas.py::
// _mf_multisweep_kernel (entry mf_sweeps_pallas). mf_sweep_kernel, one
// sweep a launch, is K7 with halo = 1: it replaces _mf_sweep_kernel (entry
// mf_sweep_pallas, halo_extended=True), the sweep of a row shard between
// two one-row halo exchanges; with halo = 0 it is the chained reference K1
// is held to bitwise (ops/mf_kernels.py::mf_sweeps_chained). Per pixel p
// and state k:
//   agree_k = sum_d w_d(p) q_k(p+d) + w_d(p-d) q_k(p-d)   (DIRS order,
//             forward then backward term of each direction)
//   field_k = base_k - beta * agree_k     (base = unary + beta * wsum)
//   q'_k    = damp * q_k + (1 - damp) * softmax_k(-field / T)
// with the softmax taken after subtracting the max (T goes down to 0.25).
//
// mf_sweep_kernel is bound by memory: each sweep reads q and base (K
// floats each) and the four weights, and writes K floats, ~12 bytes per
// state and pixel against a few dozen flops; the eight-neighbour re-reads
// of q are left to L1/L2 (neighbouring threads read neighbouring
// addresses). It reads `q` and writes `out`, never in place. One thread per
// pixel keeps the K field values in registers (K <= PHMRF_KMAX, unrolled
// and predicated on the runtime K).
//
// Halo rows: with halo = 1, q and w are (R, ., H + 2, W) arrays whose first
// and last rows hold the neighbouring shards' boundary rows (zeros at the
// ends of the mesh), while base and out hold only the H center rows. The
// threads cover the center; q and w are read at row h + halo of the
// extended array, whose height bounds the neighbour guard. K7 moves the
// same bytes per pixel as one sweep of the whole grid, plus two rows of q
// and w per shard.
#include "common.cuh"

__global__ void mf_sweep_kernel(const float* __restrict__ q,
                                const float* __restrict__ base,
                                const float* __restrict__ w,
                                float* __restrict__ out, int R, int K, int H,
                                int W, int halo, float T, float damp,
                                float omd, float beta) {
  const long HW = (long)H * W;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)R * HW) return;
  const int r = (int)(idx / HW);
  const long p = idx - (long)r * HW;
  const int h = (int)(p / W);
  const int x = (int)(p - (long)h * W);
  const int He = H + 2 * halo;          // rows of q and w
  const long HWe = (long)He * W;
  const long pe = p + (long)halo * W;   // p in the extended plane

  Nbrs n;
  load_nbrs(w + (long)r * 4 * HWe, He, W, h + halo, x, n);
  const float* q_r = q + (long)r * K * HWe;
  const float* b_r = base + (long)r * K * HW;
  float* o_r = out + (long)r * K * HW;

  float z[PHMRF_KMAX];
  float zmax = -INFINITY;
#pragma unroll
  for (int k = 0; k < PHMRF_KMAX; ++k) {
    if (k < K) {
      const float* qk = q_r + (long)k * HWe;
      float agree = 0.0f;
#pragma unroll
      for (int s = 0; s < 8; ++s)
        if (n.ok[s]) agree = __fadd_rn(agree, __fmul_rn(n.wt[s], qk[n.off[s]]));
      const float field = __fsub_rn(b_r[(long)k * HW + p], __fmul_rn(beta, agree));
      z[k] = __fdiv_rn(-field, T);
      zmax = fmaxf(zmax, z[k]);
    }
  }
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < PHMRF_KMAX; ++k) {
    if (k < K) {
      z[k] = expf(__fsub_rn(z[k], zmax));
      sum = __fadd_rn(sum, z[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < PHMRF_KMAX; ++k) {
    if (k < K) {
      o_r[(long)k * HW + p] = __fadd_rn(
          __fmul_rn(damp, q_r[(long)k * HWe + pe]),
          __fmul_rn(omd, __fdiv_rn(z[k], sum)));
    }
  }
}

extern "C" int phmrf_mf_sweep(const float* q, const float* base,
                              const float* w, float* out, int R, int K, int H,
                              int W, int halo, float T, float damp, float omd,
                              float beta, void* stream) {
  if (K < 1 || K > PHMRF_KMAX || (halo & ~1)) return (int)cudaErrorInvalidValue;
  const long n = (long)R * H * W;
  if (n == 0) return 0;
  const int threads = 256;
  mf_sweep_kernel<<<ceil_div(n, threads), threads, 0, (cudaStream_t)stream>>>(
      q, base, w, out, R, K, H, W, halo, T, damp, omd, beta);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// K1, the tile kernel: up to `halo` sweeps at one temperature per launch.
//
// Replaces phylo_hmrf_tpu/ops/mf_pallas.py::_mf_multisweep_kernel (entry
// mf_sweeps_pallas), the TPU kernel that keeps a row slab in VMEM across
// the 8 sweeps of a temperature under a shrinking halo. mf_sweep_kernel
// above (one sweep a launch) re-reads q, base and the weights from device
// memory every sweep: ~12 bytes per state and pixel a sweep, 8x the bytes
// of the unit. Here a block loads a TH x TW interior with a `halo`-pixel
// border on all four sides (the diagonal terms need columns too) once,
// runs n_inner <= halo sweeps in shared memory and writes the interior
// once, so the unit moves its bytes once (the bound: q and base read, q
// written, the 4 weight planes read).
//
// Then the bound is instructions: a sweep costs ~60 per state and pixel
// (8 shared loads, multiplies and adds of the agreement, two IEEE
// divisions, expf, the damping), and the border is recomputed by every
// block that loads it. Tensor cores do not apply: there is no matrix
// product, only an 8-neighbour stencil and a K-way softmax. What the
// design does about it: the tile is as large as shared memory allows at
// that K (the plan, ops/mf_kernels.py::mf_tile_plan, picks it and the
// depth); sweep s runs only on the pixels at margin >= s from the tile's
// edge, the ones still exact; a pixel whose 8 neighbours all lie in the
// grid (most) adds its 8 terms without tests. The arithmetic is
// mf_sweep_kernel's, op for op (the same round-to-nearest intrinsics in
// DIRS order, forward term then backward term, __fdiv_rn, expf), so the
// result is bitwise that of n_inner launches of it.
//
// Shared memory (planes of LH x LW floats, LH = TH + 2 halo, LW likewise):
// q (K planes), base (K), and a second q (max(K, 4)) that a sweep writes
// (Jacobi: every sweep reads the old q everywhere; its z and exp values
// pass through the new plane, so no K-sized register array is needed), then
// the two q planes swap. Pixels outside the grid load as 0 through
// zero-filling cp.async copies and are never computed; a term whose
// neighbour lies outside the grid is skipped, as mf_sweep_kernel skips
// it. The 8 edge weights and a byte of "neighbour in the grid" bits of
// each of a thread's P pixels (pixel i = thread + j * threads) stay in
// registers. The interior goes to `out`, another buffer than q: a
// neighbouring block may still be loading its border from q.
// ---------------------------------------------------------------------

#define PHMRF_MF_MAX_HALO 8
#define PHMRF_MF_MAX_P 2   // pixels a thread owns

// agreement of pixel i for one state plane sk: DIRS order, forward term
// then backward term; ALL: every neighbour lies in the grid
template <bool ALL>
__device__ __forceinline__ float mf_agree(const float* sk, int i, int LW,
                                          const float* wt, int ok) {
  float agree = 0.0f;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int d = s >> 1, sg = (s & 1) ? -1 : 1;
    const int off = sg * (dir_dr(d) * LW + dir_dc(d));
    if (ALL || ((ok >> s) & 1))
      agree = __fadd_rn(agree, __fmul_rn(wt[s], sk[i + off]));
  }
  return agree;
}

template <int P>
__global__ void __launch_bounds__(1024, 1)
mf_tile_kernel(const float* __restrict__ q, const float* __restrict__ base,
               const float* __restrict__ w, float* __restrict__ out, int K,
               int H, int W, int TH, int TW, int halo, int n_inner, float T,
               float damp, float omd, float beta) {
  extern __shared__ float smem[];
  const int LH = TH + 2 * halo, LW = TW + 2 * halo, NPX = LH * LW;
  const int NT = blockDim.x;
  float* src = smem;                     // q, K planes
  const float* b_s = smem + K * NPX;     // base, K planes
  float* dst = smem + 2 * K * NPX;       // the next q, max(K, 4) planes
  const long HW = (long)H * W;
  const long r = blockIdx.z;
  const int y0 = (int)blockIdx.y * TH - halo, x0 = (int)blockIdx.x * TW - halo;
  const float* q_r = q + r * K * HW;
  const float* b_r = base + r * K * HW;
  const float* w_r = w + r * 4 * HW;

  // per owned pixel: bits 0-7 "neighbour of slot s in the grid", bits 8+
  // the margin (0 outside the grid or the tile); its 8 edge weights
  int meta[P];
  float wt[P][8];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = threadIdx.x + j * NT;
    const int ly = i / LW, lx = i - (i / LW) * LW;
    const int gy = y0 + ly, gx = x0 + lx;
    const bool in = i < NPX && gy >= 0 && gy < H && gx >= 0 && gx < W;
    const long p = in ? (long)gy * W + gx : 0;
    int m = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int dr = dir_dr(d), dc = dir_dc(d);
      const int fy = gy + dr, fx = gx + dc, by = gy - dr, bx = gx - dc;
      const bool fok = fy >= 0 && fy < H && fx >= 0 && fx < W;
      const bool bok = by >= 0 && by < H && bx >= 0 && bx < W;
      // unconditional loads of a clamped address, all in flight at once
      const float wf = w_r[d * HW + p];
      const float wb = w_r[d * HW + (in && bok ? (long)by * W + bx : 0)];
      wt[j][2 * d] = in ? wf : 0.0f;
      wt[j][2 * d + 1] = in && bok ? wb : 0.0f;
      m |= (fok ? 1 : 0) << (2 * d);
      m |= (bok ? 1 : 0) << (2 * d + 1);
    }
    meta[j] = in ? (m | tile_margin(ly, lx, LH, LW) << 8) : 0;
    if (i < NPX) {
      for (int k = 0; k < K; ++k) {
        cp_async_f32(src + k * NPX + i, q_r + k * HW + p, in);
        cp_async_f32(smem + (K + k) * NPX + i, b_r + k * HW + p, in);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  for (int s = 1; s <= n_inner; ++s) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int m = meta[j];
      if ((m >> 8) < s) continue;   // no longer exact after s sweeps
      const int i = threadIdx.x + j * NT;
      const bool all = (m & 0xff) == 0xff;
      float zmax = -INFINITY;
      for (int k = 0; k < K; ++k) {
        const float* sk = src + k * NPX;
        const float agree = all ? mf_agree<true>(sk, i, LW, wt[j], m)
                                : mf_agree<false>(sk, i, LW, wt[j], m);
        const float field = __fsub_rn(b_s[k * NPX + i], __fmul_rn(beta, agree));
        const float z = __fdiv_rn(-field, T);
        dst[k * NPX + i] = z;
        zmax = fmaxf(zmax, z);
      }
      float sum = 0.0f;
      for (int k = 0; k < K; ++k) {
        const float e = expf(__fsub_rn(dst[k * NPX + i], zmax));
        dst[k * NPX + i] = e;
        sum = __fadd_rn(sum, e);
      }
      for (int k = 0; k < K; ++k)
        dst[k * NPX + i] = __fadd_rn(__fmul_rn(damp, src[k * NPX + i]),
                                     __fmul_rn(omd, __fdiv_rn(dst[k * NPX + i], sum)));
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }

  float* o_r = out + r * K * HW;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if ((meta[j] >> 8) < halo) continue;   // the interior only
    const int i = threadIdx.x + j * NT;
    const int ly = i / LW, lx = i - (i / LW) * LW;
    const long p = (long)(y0 + ly) * W + (x0 + lx);
    for (int k = 0; k < K; ++k) o_r[k * HW + p] = src[k * NPX + i];
  }
}

static size_t mf_tile_smem(int K, int npx) {
  return sizeof(float) * (size_t)npx * (2 * K + (K > 4 ? K : 4));
}

template <int P>
static int mf_tile_launch(dim3 grid, int threads, size_t smem,
                          cudaStream_t st, const float* q, const float* base,
                          const float* w, float* out, int K, int H, int W,
                          int th, int tw, int halo, int n_inner, float T,
                          float damp, float omd, float beta) {
  // per device: set it on every call (the card may change between calls)
  const cudaError_t attr = cudaFuncSetAttribute(
      mf_tile_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  mf_tile_kernel<P><<<grid, threads, smem, st>>>(
      q, base, w, out, K, H, W, th, tw, halo, n_inner, T, damp, omd, beta);
  return (int)cudaGetLastError();
}

// n_inner (<= halo) sweeps from q into out (q is not written), on th x tw
// interiors with a halo-pixel border and `threads` threads a block (the
// plan of ops/mf_kernels.py::mf_tile_plan); an error for a plan the
// kernel cannot take.
extern "C" int phmrf_mf_tiles(const float* q, const float* base,
                              const float* w, float* out, int R, int K, int H,
                              int W, int n_inner, float T, float damp,
                              float omd, float beta, int th, int tw, int halo,
                              int threads, void* stream) {
  if (K < 1 || K > PHMRF_KMAX || halo < 1 || halo > PHMRF_MF_MAX_HALO ||
      n_inner < 1 || n_inner > halo || th < 1 || tw < 1 || threads < 32 ||
      threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  const int npx = (th + 2 * halo) * (tw + 2 * halo);
  const int P = ceil_div(npx, threads);
  const size_t smem = mf_tile_smem(K, npx);
  if (P > PHMRF_MF_MAX_P || smem > PHMRF_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if ((long)R * H * W == 0) return 0;
  const dim3 grid(ceil_div(W, tw), ceil_div(H, th), R);
  const cudaStream_t st = (cudaStream_t)stream;
  if (P == 1)
    return mf_tile_launch<1>(grid, threads, smem, st, q, base, w, out, K, H, W,
                             th, tw, halo, n_inner, T, damp, omd, beta);
  return mf_tile_launch<2>(grid, threads, smem, st, q, base, w, out, K, H, W,
                           th, tw, halo, n_inner, T, damp, omd, beta);
}
