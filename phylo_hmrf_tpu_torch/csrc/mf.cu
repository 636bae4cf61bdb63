// K1 and K7: one damped mean-field (Jacobi) sweep at temperature T.
//
// K1 (halo = 0) replaces phylo_hmrf_tpu/ops/mf_pallas.py::
// _mf_multisweep_kernel (entry mf_sweeps_pallas); K7 (halo = 1) replaces
// _mf_sweep_kernel (entry mf_sweep_pallas, halo_extended=True), the sweep
// of a row shard between two one-row halo exchanges. Per pixel p and
// state k:
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
//
// Halo rows: with halo = 1, q and w are (R, ., H + 2, W) arrays whose first
// and last rows hold the neighbouring shards' boundary rows (zeros at the
// ends of the mesh), while base and out hold only the H center rows. The
// threads cover the center; q and w are read at row h + halo of the
// extended array, whose height bounds the neighbour guard. With halo = 0
// this is K1's code exactly. K7 is bounded like K1: one sweep moves the
// same bytes per pixel, plus two rows of q and w per shard.
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
