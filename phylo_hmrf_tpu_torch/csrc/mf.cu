// K1: one damped mean-field (Jacobi) sweep at temperature T.
//
// Replaces phylo_hmrf_tpu/ops/mf_pallas.py::_mf_multisweep_kernel (entry
// mf_sweeps_pallas). Per pixel p and state k:
//   agree_k = sum_d w_d(p) q_k(p+d) + w_d(p-d) q_k(p-d)   (DIRS order,
//             forward then backward term of each direction)
//   field_k = base_k - beta * agree_k     (base = unary + beta * wsum)
//   q'_k    = damp * q_k + (1 - damp) * softmax_k(-field / T)
// with the softmax taken after subtracting the max (T goes down to 0.25).
//
// Bound: memory. Each sweep reads q and base (K floats each) and the four
// weights, and writes K floats: ~12 bytes per state and pixel, against a
// few dozen flops. The TPU kernel keeps a row slab in VMEM across eight
// sweeps under a shrinking halo (temporal blocking); this first version
// does one sweep per launch and leaves the eight-neighbour re-reads of q to
// L1/L2 (neighbouring threads read neighbouring addresses). The sweep is
// Jacobi: it reads `q` and writes `out`, never in place, so the caller
// ping-pongs two buffers. One thread per pixel keeps the K field values in
// registers (K <= PHMRF_KMAX, unrolled and predicated on the runtime K).
#include "common.cuh"

__global__ void mf_sweep_kernel(const float* __restrict__ q,
                                const float* __restrict__ base,
                                const float* __restrict__ w,
                                float* __restrict__ out, int R, int K, int H,
                                int W, float T, float damp, float omd,
                                float beta) {
  const long HW = (long)H * W;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)R * HW) return;
  const int r = (int)(idx / HW);
  const long p = idx - (long)r * HW;
  const int h = (int)(p / W);
  const int x = (int)(p - (long)h * W);

  Nbrs n;
  load_nbrs(w + (long)r * 4 * HW, H, W, h, x, n);
  const float* q_r = q + (long)r * K * HW;
  const float* b_r = base + (long)r * K * HW;
  float* o_r = out + (long)r * K * HW;

  float z[PHMRF_KMAX];
  float zmax = -INFINITY;
#pragma unroll
  for (int k = 0; k < PHMRF_KMAX; ++k) {
    if (k < K) {
      const float* qk = q_r + (long)k * HW;
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
      const long i = (long)k * HW + p;
      o_r[i] = __fadd_rn(__fmul_rn(damp, q_r[i]),
                         __fmul_rn(omd, __fdiv_rn(z[k], sum)));
    }
  }
}

extern "C" int phmrf_mf_sweep(const float* q, const float* base,
                              const float* w, float* out, int R, int K, int H,
                              int W, float T, float damp, float omd,
                              float beta, void* stream) {
  if (K < 1 || K > PHMRF_KMAX) return (int)cudaErrorInvalidValue;
  const long n = (long)R * H * W;
  if (n == 0) return 0;
  const int threads = 256;
  mf_sweep_kernel<<<ceil_div(n, threads), threads, 0, (cudaStream_t)stream>>>(
      q, base, w, out, R, K, H, W, T, damp, omd, beta);
  return (int)cudaGetLastError();
}
