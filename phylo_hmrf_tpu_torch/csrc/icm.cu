// K2 and K8: one checkerboard-ICM phase, labels updated in place.
//
// K2 (halo = 0) replaces phylo_hmrf_tpu/ops/icm_pallas.py::
// _icm_sweeppair_kernel (entry _icm_sweep_pair_padded, driven by
// icm_pallas); K8 (halo = 1) replaces _icm_phase_kernel (entry
// icm_phase_pallas, halo_extended=True), the phase of a row shard between
// two one-row label exchanges. The TPU sweep-pair kernel runs the
// eight phases of two sweeps, (a, b) in (0,0),(0,1),(1,0),(1,1) twice, on a
// VMEM slab; here each phase is one launch, so eight launches make the same
// sweep pair. Pixels of colour (row % 2, col % 2) == (a, b) are never
// 8-neighbours of each other, so a phase may write its pixels in place:
// no thread of the launch reads a pixel another thread writes.
//
// At every valid pixel of the active colour:
//   agree_k = sum_d w_d(p) [s(p+d) == k] + w_d(p-d) [s(p-d) == k]
//   s(p)   <- argmin_k (unary_k - beta * agree_k)   (first index on ties)
// The terms are added in the plain version's order (DIRS order, forward
// then backward) and every add and multiply is a round-to-nearest
// intrinsic, so nvcc cannot contract them into FMAs: labels are compared
// exactly with the plain version, and near-ties would otherwise flip.
//
// Bound: memory and latency. A phase touches a quarter of the pixels and
// reads K unary values each; one pixel per thread, the K scores in
// registers. The two-sweep temporal blocking of the TPU kernel (one unary
// read per pair) is later work.
//
// Halo rows: with halo = 1, labels and w are (R, ., H + 2, W) arrays whose
// first and last rows hold the neighbouring shards' boundary rows (zeros
// at the ends of the mesh), while unary and mask hold only the H center
// rows. The threads cover the center colour; labels and w are read, and
// labels written, at row h + halo of the extended array, whose height
// bounds the neighbour guard; the halo rows are never written. The colour
// row parity pa is that of the center row h: a shard passes its global
// parity, (a + first global row) % 2. With halo = 0 this is K2's code
// exactly. K8 is bounded like K2, plus two rows of labels and w per shard.
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
