// K1 and K7: damped mean-field (Jacobi) sweeps at temperature T.
//
// K1 is mf_tile_kernel below (up to 8 sweeps a launch on shared-memory
// tiles); it replaces phylo_hmrf_tpu/ops/mf_pallas.py::
// _mf_multisweep_kernel (entry mf_sweeps_pallas). K7 is mf_halo_kernel at
// the end of this file (the sweeps of all the row shards a device holds in
// one launch); it replaces _mf_sweep_kernel (entry mf_sweep_pallas,
// halo_extended=True). mf_sweep_kernel, one sweep of a whole grid a
// launch, is the chained reference both are held to bitwise
// (ops/mf_kernels.py::mf_sweeps_chained). Per pixel p and state k:
//   agree_k = sum_d w_d(p) q_k(p+d) + w_d(p-d) q_k(p-d)   (DIRS order,
//             forward then backward term of each direction)
//   field_k = base_k - beta * agree_k     (base = unary + beta * wsum)
//   q'_k    = damp * q_k + (1 - damp) * softmax_k(-field / T)
// with the softmax taken after subtracting the max (T goes down to 0.25).
//
// mf_sweep_kernel reads `q` and writes `out`, never in place, one thread
// per pixel with the K field values in registers (K <= PHMRF_KMAX,
// unrolled and predicated on the runtime K); the eight-neighbour re-reads
// of q are left to L1/L2.
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
      o_r[(long)k * HW + p] = __fadd_rn(
          __fmul_rn(damp, q_r[(long)k * HW + p]),
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

// ---------------------------------------------------------------------
// K7: the sweeps of every row shard of one device in one launch.
//
// Replaces phylo_hmrf_tpu/ops/mf_pallas.py::_mf_sweep_kernel (entry
// mf_sweep_pallas, halo_extended=True), which the JAX package runs once per
// sweep and shard between two one-row halo exchanges. A shard's rows are
// thin (the spatial fit's off-diagonal blocks give 6-row shards), so one
// launch a shard and sweep is almost all launch; here one cooperative
// launch runs `n_sweeps` sweeps over all the shards of the device's table
// (MfHaloTable, by value), with a grid barrier between sweeps. The rows
// above and below a shard are read where they lie: in the neighbour's own
// array when the neighbour is in the table (its q of the same sweep), in a
// one-row buffer copied from another device before the launch (then the
// launch runs one sweep), or as zeros at the ends of the mesh. q ping-pongs
// between two buffers a shard: sweep s writes buf[s & 1] and reads the
// input (s = 0) or buf[(s - 1) & 1]; the input is never written. The
// weights are the shard's 1-row-extended (4, H + 2, W) array, fixed for
// the E-step.
//
// Bound: memory once a shard is thick (each sweep reads q and base, K
// floats each, and the 4 weights, and writes K floats); on thin shards the
// barrier and the latency of a sweep. A block takes 30-column tiles of TH
// <= 8 rows of one shard, one pixel a thread, one warp a tile row: the q
// rows h - 1 .. h + TH of all K planes, 32 columns (one a lane, with the
// column on each side), go to shared memory by zero-filling cp.async
// copies (a row source is resolved once a warp and row), double-buffered
// so the next tile's rows load while this one computes; the eight
// neighbours then come from shared memory, and base and the weights from
// device memory once a pixel. Each thread's K field values (then their
// exponentials) pass through its own column of shared memory, so the
// loops over the states run K times (held in registers, they need loops
// unrolled to PHMRF_KMAX and predicated on K; PERF.md). The arithmetic
// is mf_sweep_kernel's, op for op (the same round-to-nearest intrinsics
// in DIRS order, forward term then backward term, __fdiv_rn by T, expf
// after the max): each sweep is bitwise one sweep of that kernel
// on the shard's rows with the exchanged rows around them. A neighbour
// outside the columns is skipped as there; the zero rows at the mesh ends
// add w * 0 as the zero-filled halo rows of the per-shard route did.
// ---------------------------------------------------------------------

#define MF_HALO_TW 30     // interior columns of a tile
#define MF_HALO_LW 32     // loaded columns: one a lane
#define MF_HALO_MAX_TH 8  // rows of a tile: one warp each
#define MF_HALO_COLS 10   // int64 columns of a shard row of the host table

struct MfHaloShard {
  const float* src;     // q of the first sweep, (K, H, W), never written
  float* buf[2];        // sweep s writes buf[s & 1]
  const float* base;    // (K, H, W)
  const float* w;       // (4, H + 2, W)
  const float* row[2];  // rows above / below from another device, (K, 1, W)
  int nb[2];            // table index of the neighbour above / below, or -1
  int H;                // rows
  int tile0;            // first tile of the shard in the launch's order
};

struct MfHaloTable {
  MfHaloShard s[PHMRF_HALO_MAX_SHARDS];
  int n, tiles, tiles_x;
};

__device__ __forceinline__ const float* mf_halo_read(const MfHaloTable& tab,
                                                     int i, int s) {
  return s == 0 ? tab.s[i].src : tab.s[i].buf[(s - 1) & 1];
}

// the shard and its first row and column of tile t
__device__ __forceinline__ int mf_halo_tile(const MfHaloTable& tab, int t,
                                            int TH, int& y0, int& x0) {
  int i = 0;
  while (i + 1 < tab.n && t >= tab.s[i + 1].tile0) ++i;
  const int local = t - tab.s[i].tile0;
  y0 = (local / tab.tiles_x) * TH;
  x0 = (local % tab.tiles_x) * MF_HALO_TW;
  return i;
}

// cp.async copies of tile t's rows y0 - 1 .. y0 + TH, columns x0 - 1 ..
// x0 + 30, all K planes, into dst (K planes of (TH + 2) x 32)
__device__ __forceinline__ void mf_halo_load(const MfHaloTable& tab, int s,
                                             int t, int K, int W, int TH,
                                             float* dst) {
  int y0, x0;
  const int i = mf_halo_tile(tab, t, TH, y0, x0);
  const int H = tab.s[i].H;
  const int lane = threadIdx.x & 31;
  const int NPX = (TH + 2) * MF_HALO_LW;
  const int x = x0 + lane - 1;
  const bool xin = x >= 0 && x < W;
  for (int ly = threadIdx.x >> 5; ly < TH + 2; ly += blockDim.x >> 5) {
    const int h = y0 + ly - 1;
    const float* row = nullptr;
    long stride = 0;
    if (h >= 0 && h < H) {
      row = mf_halo_read(tab, i, s) + (long)h * W;
      stride = (long)H * W;
    } else if (h == -1 || h == H) {
      const int side = h < 0 ? 0 : 1;
      const int j = tab.s[i].nb[side];
      if (j >= 0) {
        const int Hj = tab.s[j].H;
        row = mf_halo_read(tab, j, s) + (side == 0 ? (long)(Hj - 1) * W : 0);
        stride = (long)Hj * W;
      } else if (tab.s[i].row[side] != nullptr) {
        row = tab.s[i].row[side];
        stride = W;
      }
    }
    const bool ok = row != nullptr && xin;
    const float* src = ok ? row + x : tab.s[i].base;   // valid either way
    float* d = dst + ly * MF_HALO_LW + lane;
    for (int k = 0; k < K; ++k)
      cp_async_f32(d + k * NPX, src + (ok ? k * stride : 0), ok);
  }
}

// one sweep of tile t's pixel of this thread (tile row threadIdx.x / 32,
// column lane) from the staged q planes; its K field values pass through
// its own column of zbuf (K floats, stride blockDim.x)
__device__ __forceinline__ void mf_halo_update(const MfHaloTable& tab, int s,
                                               int t, int K, int W, int TH,
                                               const float* stage,
                                               float* zbuf, float T,
                                               float damp, float omd,
                                               float beta) {
  int y0, x0;
  const int i = mf_halo_tile(tab, t, TH, y0, x0);
  const int H = tab.s[i].H;
  const int lane = threadIdx.x & 31, ly = threadIdx.x >> 5;
  const int h = y0 + ly, x = x0 + lane;
  if (lane >= MF_HALO_TW || h >= H || x >= W) return;
  const int NPX = (TH + 2) * MF_HALO_LW, NT = blockDim.x;
  const int c = (ly + 1) * MF_HALO_LW + lane + 1;   // the pixel in a plane
  const long HW = (long)H * W, HWe = (long)(H + 2) * W;
  const long p = (long)h * W + x;
  const float* w = tab.s[i].w + (long)(h + 1) * W + x;   // extended row
  float wt[8];
  int off[8];
  bool ok[8];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int dr = dir_dr(d), dc = dir_dc(d);
    ok[2 * d] = x + dc >= 0 && x + dc < W;
    off[2 * d] = dr * MF_HALO_LW + dc;
    wt[2 * d] = __ldg(w + d * HWe);
    ok[2 * d + 1] = x - dc >= 0 && x - dc < W;
    off[2 * d + 1] = -(dr * MF_HALO_LW + dc);
    wt[2 * d + 1] =
        ok[2 * d + 1] ? __ldg(w + d * HWe - (long)dr * W - dc) : 0.0f;
  }
  const float* b = tab.s[i].base + p;
  float* o = tab.s[i].buf[s & 1] + p;
  float* z = zbuf + threadIdx.x;

  float zmax = -INFINITY;
  for (int k = 0; k < K; ++k) {
    const float* sk = stage + k * NPX + c;
    float agree = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (ok[j]) agree = __fadd_rn(agree, __fmul_rn(wt[j], sk[off[j]]));
    const float field = __fsub_rn(__ldg(b + k * HW), __fmul_rn(beta, agree));
    const float zk = __fdiv_rn(-field, T);
    z[k * NT] = zk;
    zmax = fmaxf(zmax, zk);
  }
  float sum = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float e = expf(__fsub_rn(z[k * NT], zmax));
    z[k * NT] = e;
    sum = __fadd_rn(sum, e);
  }
  for (int k = 0; k < K; ++k)
    o[k * HW] = __fadd_rn(__fmul_rn(damp, stage[k * NPX + c]),
                          __fmul_rn(omd, __fdiv_rn(z[k * NT], sum)));
}

// 5 blocks an SM (<= 48 registers): 6.6% faster than 4 at 10 kb (PERF.md)
__global__ void __launch_bounds__(MF_HALO_LW * MF_HALO_MAX_TH, 5)
mf_halo_kernel(const MfHaloTable tab, int K, int W, int TH, int n_sweeps,
               float T, float damp, float omd, float beta, unsigned* bar) {
  extern __shared__ float smem[];
  const int plane_set = K * (TH + 2) * MF_HALO_LW;   // one stage
  float* zbuf = smem + 2 * plane_set;
  for (int s = 0; s < n_sweeps; ++s) {
    if (s > 0) grid_barrier(bar);   // sweep s reads what s - 1 wrote
    int t = blockIdx.x, cur = 0;
    if (t < tab.tiles) mf_halo_load(tab, s, t, K, W, TH, smem);
    cp_async_commit();
    for (; t < tab.tiles; t += gridDim.x) {
      const int next = t + gridDim.x;
      if (next < tab.tiles)
        mf_halo_load(tab, s, next, K, W, TH, smem + (cur ^ 1) * plane_set);
      cp_async_commit();
      cp_async_wait_prior<1>();   // tile t's copies landed
      __syncthreads();
      mf_halo_update(tab, s, t, K, W, TH, smem + cur * plane_set, zbuf, T,
                     damp, omd, beta);
      __syncthreads();   // the stage is free for the tile after next
      cur ^= 1;
    }
  }
}

// two stages of K planes of (TH + 2) x 32, and K field values a thread
static size_t mf_halo_smem(int K, int TH) {
  return sizeof(float) * (size_t)K * MF_HALO_LW * (2 * (TH + 2) + TH);
}

// Blocks of the largest co-resident grid of K7 at (K, TH) on the current
// device (blocks an SM x SMs); a negative CUDA error on failure.
extern "C" int phmrf_mf_halo_grid(int K, int TH) {
  if (K < 1 || K > PHMRF_KMAX || TH < 1 || TH > MF_HALO_MAX_TH)
    return -(int)cudaErrorInvalidValue;
  const size_t smem = mf_halo_smem(K, TH);
  cudaError_t e = cudaFuncSetAttribute(
      mf_halo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mf_halo_kernel, MF_HALO_LW * TH, smem);
  if (e != cudaSuccess) return -(int)e;
  return per_sm * sms;
}

// n_sweeps sweeps of the n shards of `shards` (MF_HALO_COLS int64 a shard:
// src, buf0, buf1, base, w, row above, row below, neighbour above,
// neighbour below, H; all on the current device) in one cooperative launch
// of TH-row tiles; `bar` a zeroed word of this stream. An error when the
// table or the grid cannot be taken.
extern "C" int phmrf_mf_halo(const long long* shards, int n, int K, int W,
                             int TH, int n_sweeps, float T, float damp,
                             float omd, float beta, unsigned* bar,
                             void* stream) {
  if (n < 1 || n > PHMRF_HALO_MAX_SHARDS || K < 1 || K > PHMRF_KMAX ||
      W < 1 || TH < 1 || TH > MF_HALO_MAX_TH || n_sweeps < 1)
    return (int)cudaErrorInvalidValue;
  MfHaloTable tab;
  tab.n = n;
  tab.tiles_x = ceil_div(W, MF_HALO_TW);
  tab.tiles = 0;
  for (int i = 0; i < n; ++i) {
    const long long* r = shards + (long)i * MF_HALO_COLS;
    MfHaloShard& sh = tab.s[i];
    sh.src = (const float*)r[0];
    sh.buf[0] = (float*)r[1];
    sh.buf[1] = (float*)r[2];
    sh.base = (const float*)r[3];
    sh.w = (const float*)r[4];
    sh.row[0] = (const float*)r[5];
    sh.row[1] = (const float*)r[6];
    sh.nb[0] = (int)r[7];
    sh.nb[1] = (int)r[8];
    sh.H = (int)r[9];
    if (sh.H < 1 || sh.nb[0] >= n || sh.nb[1] >= n)
      return (int)cudaErrorInvalidValue;
    sh.tile0 = tab.tiles;
    tab.tiles += ceil_div(sh.H, TH) * tab.tiles_x;
  }
  const int grid_max = phmrf_mf_halo_grid(K, TH);
  if (grid_max < 0) return -grid_max;
  if (grid_max == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = grid_max < tab.tiles ? grid_max : tab.tiles;
  void* args[] = {&tab, &K, &W, &TH, &n_sweeps, &T, &damp, &omd, &beta,
                  &bar};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)mf_halo_kernel, dim3(grid), dim3(MF_HALO_LW * TH), args,
      mf_halo_smem(K, TH), (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
