// KM1-KM3, the init's k-means: the k-means++ seeding of every trial in one
// launch (KM1), then the Lloyd steps of all trials in lockstep (KM2) and the
// end of the call (KM3: each trial's inertia, the best trial, its labels) in
// one cooperative launch.
//
// Replaces no TPU kernel: the JAX package runs k-means as one vmapped XLA
// program, every trial in lockstep (phylo_hmrf_tpu/ops/kmeans.py::
// _kmeans_multi). On the card the port's plain version (ops/kmeans.py::
// kmeans_plain) is a few dozen PyTorch kernels a Lloyd step and trial, some
// 20,000 host launches a call at n_init = 10 and 100 steps, which the host
// issues one by one while the card waits (0.4-0.8 s a call). Here the host
// issues the generator's draws and two launches.
//
// Bound: operations. A Lloyd step reads X once (N F 4 bytes: 3.4 MB at
// chr21, N = 213,531, F = 4, L2-resident after the first step) and does
// 3 N K F operations a trial for the distances (a subtract, a multiply and
// an add a feature). Over 100 steps of 10 trials that is 2.6e10 operations
// at chr21 (K = 10) and 1.1e11 at the canonical run (K = 20, N = 448,486):
// 0.38 ms and 1.6 ms at 67 TFLOP/s float32. The distances are not
// contracted into FMAs (they are the plain version's bits), and the
// per-cluster sums scan every (trial, center) pair of a tile in float64 and
// cost about as much as the distances: on an H100 at 700 W, KM1 and KM2/KM3
// take 7.5% (chr21) and 10.4% (canonical run) of that bound.
//
// Arithmetic, as the plain version's:
// - a squared distance is sum_f (x_f - c_f)^2, features added in order, each
//   operation rounded on its own (no FMA contraction);
// - the nearest center is the first of the least distance (argmin's ties);
// - a k-means++ pick is the first subsample index whose inclusive prefix
//   sum of the weights max(d2, 0) + 1e-12 (float64) exceeds u times their
//   total, u the trial's uniform draw (the draws are the wrapper's, from the
//   model's generator); d2 is each point's least squared distance to the
//   trial's centers so far;
// - a Lloyd step's new center is the float64 sum of its points over their
//   float64 count, rounded to float32; an empty cluster keeps its center;
// - a trial's inertia is the float64 sum of its points' least distances;
//   the best trial is the first of the least inertia (strict <).
// The float64 sums are taken in a fixed order (no float atomics): the same
// draws give bitwise the same centers, labels and inertia on a card, run
// after run. They differ from the plain version's only in the last bits of
// a float64 sum, so the two agree bitwise but for a value that lands within
// an ulp of a float32 rounding boundary.
//
// KM1, one block of KM_THREADS threads a trial; warp w keeps a contiguous
// range of the m subsample points, lane l its points l, l + 32, ... (loads
// coalesced). The first draw copies the trial's subsample into a contiguous
// scratch (the later draws read it there, not through the permutation). A
// draw is a min-update of the points' d2 (kept in global memory) against the
// newest center with each lane's float64 weight sum, a warp xor tree and a
// scan of the warp totals, then the pick: the first warp whose inclusive
// sum exceeds the target rescans its range 32 points at a time (a warp scan
// a round, carried) for the first point whose running sum does.
//
// KM2, one cooperative launch of G blocks (every block co-resident), each
// walking tiles of KM_THREADS points (block b takes tiles b, b + G, ...).
// Every trial's centers sit in shared memory. A tile's points are assigned
// for every trial (a thread a point), the labels and points staged in
// shared memory (each trial's labels a row); then thread (r, q) of the R
// replicas of the T K (trial, center) pairs walks the r-th R-th of the tile,
// 4 labels a word (__vcmpeq4), and adds each point of label q's center into
// its float64 registers, in point order. At the end of the step the replicas
// are added in order into the block's slot of `part`; behind a grid barrier
// a warp a pair (the pairs dealt over the blocks) adds the G slots (a
// strided sum a lane, coalesced, then an xor tree) and writes the new
// center; behind a second barrier every block reloads the centers.
// KM3 is the launch's tail: a tile's least distances of each trial summed
// by a block tree, the tiles in order, the blocks' sums in `ipart`; behind a
// barrier every block adds them in block order, takes the best trial and
// writes its labels; block 0 writes its centers and inertia.
#include "common.cuh"

#define KM_THREADS 1024
#define KM_TMAX 32      // trials a call (the labels of a tile: KM_THREADS x T bytes)
// a trial's row of a tile's labels: KM_THREADS bytes and a pad, so that the
// rows of the trials a warp reads start in different banks
#define KM_LAB_STRIDE (KM_THREADS + 16)

namespace {

// Loads F floats from shared memory, as float4 where F allows (c 16-byte
// aligned there).
template <int F>
__device__ __forceinline__ void load_f(const float* c, float* out) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int f = 0; f < F; f += 4) {
      const float4 v = *reinterpret_cast<const float4*>(c + f);
      out[f] = v.x;
      out[f + 1] = v.y;
      out[f + 2] = v.z;
      out[f + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) out[f] = c[f];
  }
}

// Loads F doubles from shared memory, as double2 where F allows (c 16-byte
// aligned there).
template <int F>
__device__ __forceinline__ void load_d(const double* c, double* out) {
  if constexpr (F % 2 == 0) {
#pragma unroll
    for (int f = 0; f < F; f += 2) {
      const double2 v = *reinterpret_cast<const double2*>(c + f);
      out[f] = v.x;
      out[f + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) out[f] = c[f];
  }
}

// sum_f (x_f - c_f)^2, features in order, no contraction; 0 + y is y for
// every square, so the first term is the plain version's first square.
template <int F>
__device__ __forceinline__ float sq_dist(const float* x, const float* c) {
  float d = 0.0f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float diff = __fsub_rn(x[f], c[f]);
    d = __fadd_rn(d, __fmul_rn(diff, diff));
  }
  return d;
}

// The first nearest of the K centers at c (K x F, in shared memory); its
// distance in *dmin.
template <int F>
__device__ __forceinline__ int nearest(const float* x, const float* c, int K,
                                       float* dmin) {
  float cv[F];
  load_f<F>(c, cv);
  float bd = sq_dist<F>(x, cv);
  int best = 0;
  for (int k = 1; k < K; ++k) {
    load_f<F>(c + k * F, cv);
    const float d = sq_dist<F>(x, cv);
    if (d < bd) {
      bd = d;
      best = k;
    }
  }
  *dmin = bd;
  return best;
}

template <int F>
__device__ __forceinline__ void load_x(const float* __restrict__ X, long row,
                                       float* x) {
#pragma unroll
  for (int f = 0; f < F; ++f) x[f] = X[row * F + f];
}

// A k-means++ weight: max(d2, 0) + 1e-12 in float64.
__device__ __forceinline__ double pp_weight(float d2) {
  return (double)fmaxf(d2, 0.0f) + 1e-12;
}

// The block's sum of v in a fixed order (xor trees), in every lane of warp
// 0; wt is free again on return.
__device__ double block_sum(double v, double* wt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) wt[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (warp == 0) {
    s = wt[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  }
  __syncthreads();
  return s;
}

// KM1: block t seeds trial t. X (N, F); perm (T, m) int64, the trial's
// subsample of X's rows (null: m = N, the rows themselves); first (T,)
// int64, the first pick; u (T, K - 1) float64, the draws' uniforms; xsub
// (T, m, F) scratch (with perm) and d2 (T, m) scratch; centers (T, K, F)
// out.
template <int F>
__global__ void __launch_bounds__(KM_THREADS)
    km_seed_kernel(const float* __restrict__ X,
                   const long long* __restrict__ perm,
                   const long long* __restrict__ first,
                   const double* __restrict__ u, int m, int K,
                   float* __restrict__ xsub, float* __restrict__ d2,
                   float* __restrict__ centers) {
  __shared__ double wt[32];
  __shared__ float cen[F];
  __shared__ int pick;
  const int t = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long* pt = perm == nullptr ? nullptr : perm + (long)t * m;
  float* xt = pt == nullptr ? nullptr : xsub + (long)t * m * F;
  const float* xs = pt == nullptr ? X : xt;
  float* dt = d2 + (long)t * m;
  float* ct = centers + (long)t * K * F;
  const int per_warp = ((m + KM_THREADS / 32 - 1) / (KM_THREADS / 32) + 31) / 32 * 32;
  const int w0 = min(warp * per_warp, m), w1 = min(w0 + per_warp, m);
  if (tid == 0) pick = (int)first[t];
  __syncthreads();
  for (int i = 0;; ++i) {
    if (tid < F) {
      const long row = pt == nullptr ? pick : pt[pick];
      cen[tid] = X[row * F + tid];
      ct[i * F + tid] = cen[tid];
    }
    __syncthreads();
    if (i == K - 1) break;
    float c[F];
#pragma unroll
    for (int f = 0; f < F; ++f) c[f] = cen[f];
    double s = 0.0;
#pragma unroll 4
    for (int p = w0 + lane; p < w1; p += 32) {
      float x[F];
      if (i == 0 && pt != nullptr) {
        load_x<F>(X, pt[p], x);
#pragma unroll
        for (int f = 0; f < F; ++f) xt[(long)p * F + f] = x[f];
      } else {
        load_x<F>(xs, p, x);
      }
      const float dn = sq_dist<F>(x, c);
      const float nd = i == 0 ? dn : fminf(dt[p], dn);
      dt[p] = nd;
      s += pp_weight(nd);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) wt[warp] = s;
    __syncthreads();
    if (warp == 0) {
      double e = wt[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double y = __shfl_up_sync(0xffffffffu, e, o);
        if (lane >= o) e += y;
      }
      wt[lane] = e;
    }
    __syncthreads();
    const double target = u[(long)t * (K - 1) + i] * wt[31];
    int cw = 32;
    for (int w = 0; w < 32; ++w) {
      if (wt[w] > target) {
        cw = w;
        break;
      }
    }
    if (warp == cw) {
      // the range's last point if rounding leaves its running sum short
      int pk = w1 > w0 ? w1 - 1 : m - 1;
      double carry = cw > 0 ? wt[cw - 1] : 0.0;
      for (int b = w0; b < w1; b += 32) {
        const int p = b + lane;
        double v = p < w1 ? pp_weight(dt[p]) : 0.0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const double y = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += y;
        }
        const unsigned hit =
            __ballot_sync(0xffffffffu, p < w1 && carry + v > target);
        if (hit != 0u) {
          pk = b + __ffs(hit) - 1;
          break;
        }
        carry += __shfl_sync(0xffffffffu, v, 31);
      }
      if (lane == 0) pick = pk;
    } else if (cw == 32 && tid == 0) {
      pick = m - 1;   // u * total rounded up to the total
    }
    __syncthreads();
  }
}

// Shared memory of KM2 (bytes, each part 16-byte aligned): the centers
// (T K F floats), the tile's points (KM_THREADS F doubles, converted once
// a tile and not once a trial), the replicas'
// sums (R T K (F + 1) doubles), the trials' inertia (T doubles), the tile's
// labels (T rows of KM_LAB_STRIDE bytes).
struct LloydSmem {
  size_t cs, xs, red, acc, lab, total;
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

__host__ __device__ inline LloydSmem lloyd_smem(int F, int K, int T) {
  const int TK = T * K, R = KM_THREADS / TK;
  LloydSmem s;
  s.cs = 0;
  s.xs = s.cs + align16(sizeof(float) * (size_t)TK * F);
  s.red = s.xs + align16(sizeof(double) * (size_t)KM_THREADS * F);
  s.acc = s.red + align16(sizeof(double) * (size_t)R * TK * (F + 1));
  s.lab = s.acc + align16(sizeof(double) * (size_t)T);
  s.total = s.lab + align16((size_t)KM_LAB_STRIDE * T);
  return s;
}

// KM2 and KM3: n_iters Lloyd steps of the T trials from centers (T, K, F),
// updated in place; part (T K, F + 1, G) and ipart (G, T) float64 slots;
// out: the best trial's centers (K, F), labels (N,) int32 and inertia; bar
// a zeroed grid-barrier word of the stream.
template <int F>
__global__ void __launch_bounds__(KM_THREADS, 1)
    km_lloyd_kernel(const float* __restrict__ X, int N, int K, int T,
                    int n_iters, float* centers, double* part, double* ipart,
                    float* __restrict__ out_centers, int* __restrict__ labels,
                    float* __restrict__ out_inertia, unsigned* bar) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LloydSmem L = lloyd_smem(F, K, T);
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  double* xs = reinterpret_cast<double*>(smem + L.xs);
  double* red = reinterpret_cast<double*>(smem + L.red);
  double* acc = reinterpret_cast<double*>(smem + L.acc);
  unsigned char* lab = smem + L.lab;
  __shared__ double wt[32];
  const int TK = T * K, R = KM_THREADS / TK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (N + KM_THREADS - 1) / KM_THREADS;
  const bool adds = tid < R * TK;
  const int r = tid / TK, q = tid % TK, qt = q / K, qk = q % K;
  // replica r's points of a tile: [j0, j0 + span), whole 4-label words
  const int span = ((KM_THREADS + R - 1) / R + 3) / 4 * 4, j0 = r * span;
  const unsigned kk = 0x01010101u * (unsigned)qk;
  const unsigned char* lab_q = lab + qt * KM_LAB_STRIDE;
  const int G = gridDim.x;

  for (int i = tid; i < TK * F; i += KM_THREADS) cs[i] = __ldcg(centers + i);
  __syncthreads();
  for (int step = 0; step < n_iters; ++step) {
    double s[F];
#pragma unroll
    for (int f = 0; f < F; ++f) s[f] = 0.0;
    int cnt = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int np = min(KM_THREADS, N - tile * KM_THREADS);
      if (tid < np) {
        float x[F];
        load_x<F>(X, (long)tile * KM_THREADS + tid, x);
#pragma unroll
        for (int f = 0; f < F; ++f) xs[tid * F + f] = (double)x[f];
        for (int t = 0; t < T; ++t) {
          float d;
          lab[t * KM_LAB_STRIDE + tid] =
              (unsigned char)nearest<F>(x, cs + t * K * F, K, &d);
        }
      }
      __syncthreads();
      if (adds) {
        const int j1 = min(j0 + span, np);
        for (int j = j0; j < j1; j += 4) {
          // a byte 0xff for each of the 4 points labelled qk
          unsigned m = __vcmpeq4(
              *reinterpret_cast<const unsigned*>(lab_q + j), kk);
          if (j1 - j < 4) m &= (1u << (8 * (j1 - j))) - 1u;
          while (m != 0u) {
            const int b = (__ffs(m) - 1) >> 3;
            m &= ~(0xffu << (8 * b));
            double x[F];
            load_d<F>(xs + (j + b) * F, x);
            ++cnt;
#pragma unroll
            for (int f = 0; f < F; ++f) s[f] += x[f];
          }
        }
      }
      __syncthreads();
    }
    if (adds) {
      double* o = red + (size_t)tid * (F + 1);
#pragma unroll
      for (int f = 0; f < F; ++f) o[f] = s[f];
      o[F] = (double)cnt;
    }
    __syncthreads();
    for (int qq = tid; qq < TK; qq += KM_THREADS) {
      double v[F + 1];
#pragma unroll
      for (int f = 0; f <= F; ++f) v[f] = 0.0;
      for (int rr = 0; rr < R; ++rr) {
        const double* o = red + (size_t)(rr * TK + qq) * (F + 1);
#pragma unroll
        for (int f = 0; f <= F; ++f) v[f] += o[f];
      }
      double* o = part + (size_t)qq * (F + 1) * G + blockIdx.x;
#pragma unroll
      for (int f = 0; f <= F; ++f) o[(size_t)f * G] = v[f];
    }
    grid_barrier(bar);
    // a warp a pair, the pairs dealt over the blocks first; coalesced reads
    for (int qq = blockIdx.x + warp * G; qq < TK; qq += G * (KM_THREADS / 32)) {
      double v[F + 1];
#pragma unroll
      for (int f = 0; f <= F; ++f) v[f] = 0.0;
      const double* o = part + (size_t)qq * (F + 1) * G;
      for (int b = lane; b < G; b += 32) {
#pragma unroll
        for (int f = 0; f <= F; ++f) v[f] += __ldcg(o + (size_t)f * G + b);
      }
#pragma unroll
      for (int f = 0; f <= F; ++f) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v[f] += __shfl_xor_sync(0xffffffffu, v[f], o);
      }
      if (lane == 0 && v[F] > 0.0) {
#pragma unroll
        for (int f = 0; f < F; ++f)
          centers[(size_t)qq * F + f] = __double2float_rn(__ddiv_rn(v[f], v[F]));
      }
    }
    grid_barrier(bar);
    for (int i = tid; i < TK * F; i += KM_THREADS) cs[i] = __ldcg(centers + i);
    __syncthreads();
  }

  // KM3: each trial's inertia, the best trial, its labels
  if (tid < T) acc[tid] = 0.0;
  __syncthreads();
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int np = min(KM_THREADS, N - tile * KM_THREADS);
    float x[F];
    if (tid < np) load_x<F>(X, (long)tile * KM_THREADS + tid, x);
    for (int t = 0; t < T; ++t) {
      float d = 0.0f;
      if (tid < np) nearest<F>(x, cs + t * K * F, K, &d);
      const double sum = block_sum((double)d, wt);
      if (tid == 0) acc[t] += sum;
    }
  }
  __syncthreads();
  if (tid < T) ipart[(size_t)blockIdx.x * T + tid] = acc[tid];
  grid_barrier(bar);
  if (tid < T) {
    double v = 0.0;
    for (int b = 0; b < (int)gridDim.x; ++b) v += __ldcg(ipart + (size_t)b * T + tid);
    acc[tid] = v;
  }
  __syncthreads();
  int best = 0;
  for (int t = 1; t < T; ++t)
    if (acc[t] < acc[best]) best = t;
  const float* cb = cs + best * K * F;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long p = (long)tile * KM_THREADS + tid;
    if (p < N) {
      float x[F], d;
      load_x<F>(X, p, x);
      labels[p] = nearest<F>(x, cb, K, &d);
    }
  }
  if (blockIdx.x == 0) {
    for (int i = tid; i < K * F; i += KM_THREADS) out_centers[i] = cb[i];
    if (tid == 0) *out_inertia = __double2float_rn(acc[best]);
  }
}

// Blocks of KM2's grid for N points: the fewest that keep the tiles a
// block of the largest co-resident grid; a negative CUDA error on failure.
template <int F>
int lloyd_grid(int N, int K, int T) {
  const size_t smem = lloyd_smem(F, K, T).total;
  cudaError_t e = cudaFuncSetAttribute(
      km_lloyd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, km_lloyd_kernel<F>, KM_THREADS, smem);
  if (e != cudaSuccess) return -(int)e;
  const int grid_max = per_sm * sms;
  if (grid_max < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
  const int tiles = ceil_div(N, KM_THREADS);
  return ceil_div(tiles, ceil_div(tiles, grid_max));
}

bool valid_shape(int N, int F, int K, int T) {
  return N >= 1 && F >= 1 && F <= PHMRF_FMAX && K >= 1 && K <= PHMRF_KMAX &&
         T >= 1 && T <= KM_TMAX && T * K <= KM_THREADS;
}

}  // namespace

#define KM_BY_F(CALL)           \
  switch (F) {                  \
    case 1: CALL(1); break;     \
    case 2: CALL(2); break;     \
    case 3: CALL(3); break;     \
    case 4: CALL(4); break;     \
    case 5: CALL(5); break;     \
    case 6: CALL(6); break;     \
    case 7: CALL(7); break;     \
    case 8: CALL(8); break;     \
    default: return (int)cudaErrorInvalidValue; \
  }

// KM1 over T trials of m subsample points each (shapes above).
extern "C" int phmrf_kmeans_seed(const float* X, const long long* perm,
                                 const long long* first, const double* u,
                                 int N, int m, int F, int K, int T,
                                 float* xsub, float* d2, float* centers,
                                 void* stream) {
  if (!valid_shape(N, F, K, T) || m < 1 || m > N)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define KM_SEED(FF)                                                  \
  km_seed_kernel<FF><<<T, KM_THREADS, 0, s>>>(X, perm, first, u, m, K, \
                                               xsub, d2, centers)
  KM_BY_F(KM_SEED)
#undef KM_SEED
  return (int)cudaGetLastError();
}

// Blocks of KM2's grid (the first dimension of its part and ipart slots);
// a negative CUDA error when none can be taken.
extern "C" int phmrf_kmeans_grid(int N, int F, int K, int T) {
  if (!valid_shape(N, F, K, T)) return -(int)cudaErrorInvalidValue;
  int g = 0;
#define KM_GRID(FF) g = lloyd_grid<FF>(N, K, T)
  KM_BY_F(KM_GRID)
#undef KM_GRID
  return g;
}

// KM2 and KM3 in one cooperative launch of `grid` blocks
// (phmrf_kmeans_grid's).
extern "C" int phmrf_kmeans_lloyd(const float* X, int N, int F, int K, int T,
                                  int n_iters, int grid, float* centers,
                                  double* part, double* ipart,
                                  float* out_centers, int* labels,
                                  float* out_inertia, unsigned* bar,
                                  void* stream) {
  if (!valid_shape(N, F, K, T) || n_iters < 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const int want = phmrf_kmeans_grid(N, F, K, T);
  if (want < 0) return -want;
  if (grid != want) return (int)cudaErrorInvalidValue;
  void* args[] = {&X,       &N,     &K,           &T,      &n_iters,
                  &centers, &part,  &ipart,       &out_centers,
                  &labels,  &out_inertia, &bar};
  const size_t smem = lloyd_smem(F, K, T).total;
  cudaError_t e = cudaSuccess;
#define KM_LLOYD(FF)                                                      \
  e = cudaLaunchCooperativeKernel((const void*)km_lloyd_kernel<FF>,       \
                                  dim3(grid), dim3(KM_THREADS), args, smem, \
                                  (cudaStream_t)stream)
  KM_BY_F(KM_LLOYD)
#undef KM_LLOYD
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
