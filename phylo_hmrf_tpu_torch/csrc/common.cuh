// Shared helpers of the E-step kernels (K1-K4).
//
// Layouts (all contiguous, row-major):
//   state fields  q, base, unary, logprob   (R, K, H, W) float32
//   edge weights  w                          (R, 4, H, W) float32
//   labels, mask                             (R, H, W)    int32
//   features      img                        (R, F, H, W) float32
//
// Edge convention (phylo_hmrf_tpu/data/regions.py::DIRS): direction d has
// offset (dr, dc) in ((0,1), (1,0), (1,1), (1,-1)). w[d] at pixel p is the
// weight of the edge p -> p + (dr, dc) (the forward edge); the backward
// edge p - (dr, dc) -> p carries the weight stored at the neighbour. Edges
// that leave the grid or touch an invalid pixel have weight exactly 0.
//
// The TPU kernels zero-pad halo rows and shift zeros into columns; here
// every neighbour read outside [0,H) x [0,W) is guarded instead and
// contributes nothing, which is bitwise the same as adding a zero product.
// Arithmetic that must match the plain PyTorch version op for op uses the
// round-to-nearest intrinsics, so nvcc cannot contract it into an FMA.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

#define PHMRF_KMAX 32   // largest n_states the kernels take
#define PHMRF_FMAX 8    // largest feature count (species) K4 takes

__device__ __forceinline__ int dir_dr(int d) { return d == 0 ? 0 : 1; }
__device__ __forceinline__ int dir_dc(int d) {
  return d == 0 ? 1 : (d == 1 ? 0 : (d == 2 ? 1 : -1));
}

// The 8 neighbours of (h, w): slot 2d is the forward neighbour of DIRS[d],
// slot 2d+1 the backward one. off[] is the in-plane offset (h'*W + w') and
// wt[] the edge weight; a neighbour outside the grid has ok[] false. The
// forward weight is read at the pixel itself even when its neighbour is
// outside (the plain version adds it to wsum either way); the backward
// weight of an outside neighbour is 0, as the plain zero-filled shift.
struct Nbrs {
  int off[8];
  float wt[8];
  bool ok[8];
};

__device__ __forceinline__ void load_nbrs(const float* __restrict__ w_r,
                                          int H, int W, int h, int x,
                                          Nbrs& n) {
  const long HW = (long)H * W;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int dr = dir_dr(d), dc = dir_dc(d);
    const int fh = h + dr, fw = x + dc;
    const bool fok = fh >= 0 && fh < H && fw >= 0 && fw < W;
    n.ok[2 * d] = fok;
    n.off[2 * d] = fok ? fh * W + fw : 0;
    n.wt[2 * d] = w_r[d * HW + (long)h * W + x];
    const int bh = h - dr, bw = x - dc;
    const bool bok = bh >= 0 && bh < H && bw >= 0 && bw < W;
    n.ok[2 * d + 1] = bok;
    n.off[2 * d + 1] = bok ? bh * W + bw : 0;
    n.wt[2 * d + 1] = bok ? w_r[d * HW + (long)bh * W + bw] : 0.0f;
  }
}

static inline int ceil_div(long a, long b) { return (int)((a + b - 1) / b); }

// Largest dynamic shared memory of one block on the H100 (227 KB).
#define PHMRF_SMEM_MAX 232448

// Distance of tile pixel (ly, lx) to the edge of its LH x LW tile.
__device__ __forceinline__ int tile_margin(int ly, int lx, int LH, int LW) {
  return min(min(ly, LH - 1 - ly), min(lx, LW - 1 - lx));
}

// 4-byte asynchronous copy global -> shared that writes 0.0f instead when
// `ok` is false (src must be a valid address either way); all of a
// thread's copies are in flight until cp_async_wait_all().
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool ok) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
#else
  *dst = ok ? *src : 0.0f;
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Close the group of this thread's copies issued since the last commit;
// cp_async_wait_prior<1>() waits for all but the newest group.
__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void cp_async_wait_prior() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// ---------------------------------------------------------------------
// Row shards (K7, K8): the per-device table and the grid barrier.
//
// A launch of the row-shard kernels covers every shard its device holds,
// listed in a by-value table. Each shard names a source for its row above
// and its row below: the neighbour shard's own array when the neighbour
// is in the same table (read in place), a one-row buffer copied from
// another device before the launch, or nothing at the ends of the mesh,
// which reads as zeros (label 0, q 0; the weights of those edges are 0).
#define PHMRF_HALO_MAX_SHARDS 16

// Grid-wide barrier of a cooperative launch, the scheme of
// cooperative_groups' grid.sync(): block 0 adds 2^31 - (blocks - 1), every
// other block 1, so the top bit of *bar flips once all blocks arrived and
// the low bits return to 0 (a zeroed word serves every later launch on its
// stream). The release fence before the add and the acquire load and
// fence after it make every block's writes before the barrier visible to
// every block's reads after it (L1 included).
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, add);
    unsigned now;
    do {
#ifdef __CUDA_ARCH__
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(now)
                   : "l"(bar)
                   : "memory");
#else
      now = *(volatile unsigned*)bar;
#endif
    } while (((old ^ now) & 0x80000000u) == 0);
    __threadfence();
  }
  __syncthreads();
}
