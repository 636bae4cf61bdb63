// The loop word of K2, K5 and K6, and the graph nodes that launch them.
//
// The JAX package runs the ICM sweep pairs, the push-relabel iterations
// and the BFS sweeps of its min cut inside lax.while_loop: the device
// decides when each loop ends. Here the loops are CUDA graphs whose
// conditional WHILE nodes the card decides (loops.cu), and the same
// kernels also serve a loop on the host that reads the word after each
// launch (ops/maxflow.py::grid_mincut_host, ops/icm_kernels.py). A
// replayed graph bakes its arguments in, so the word cannot carry a tag
// that changes from call to call: instead every launch of a loop
//   - reads GO at its start. Where it is 0 the loop has stopped and the
//     launch passes its input through to its output unchanged (the
//     ping-pong of the buffers then ends where it began, whatever the
//     launch that stopped the loop);
//   - where it runs, ORs SEEN when a block saw what keeps the loop going
//     (a label or distance changed, a node is still active);
//   - ends in its last block (a ticket after __threadfence, reset by that
//     block): COUNT += step, LAST = SEEN, GO = SEEN && COUNT < LIMIT, SEEN
//     back to 0. A launch that passed through changes no word.
// Every block reads GO before it takes its ticket, and the last block
// writes GO only after every block took one, so all blocks of a launch see
// the same GO. The arithmetic of a launch that runs is unchanged.
#pragma once

#include <cuda_runtime.h>

#define PHMRF_CUT_EPS 1e-6f

#define PHMRF_LOOP_GO 0       // the next launch runs
#define PHMRF_LOOP_SEEN 1     // a block of this launch saw a change
#define PHMRF_LOOP_TICKET 2   // blocks of this launch that finished
#define PHMRF_LOOP_COUNT 3    // iterations / sweeps the loop ran
#define PHMRF_LOOP_LIMIT 4    // the loop stops once COUNT reaches it
#define PHMRF_LOOP_LAST 5     // SEEN of the last launch that ran
#define PHMRF_LOOP_WORDS 8    // int32 words of one loop (2 spare)

// Whether this launch runs (no word: it always does).
__device__ __forceinline__ bool loop_runs(const int* loop) {
  return loop == nullptr ||
         *(volatile const int*)(loop + PHMRF_LOOP_GO) != 0;
}

// The end of a launch; every thread of every block calls it. `mine`: this
// thread saw what keeps the loop going; `step`: iterations or sweeps a
// launch that runs adds to COUNT.
__device__ __forceinline__ void loop_finish(int* loop, bool run, bool mine,
                                            int step) {
  const int any = __syncthreads_or(mine);
  if (loop == nullptr || threadIdx.x != 0) return;
  if (any) atomicExch(loop + PHMRF_LOOP_SEEN, 1);
  __threadfence();
  const unsigned blocks = gridDim.x * gridDim.y * gridDim.z;
  if (atomicAdd((unsigned*)(loop + PHMRF_LOOP_TICKET), 1u) != blocks - 1)
    return;
  __threadfence();   // the last block: every other block's SEEN is in
  volatile int* v = loop;
  if (run) {
    const int seen = v[PHMRF_LOOP_SEEN] != 0;
    const int count = v[PHMRF_LOOP_COUNT] + step;
    v[PHMRF_LOOP_COUNT] = count;
    v[PHMRF_LOOP_LAST] = seen;
    v[PHMRF_LOOP_GO] = seen && count < v[PHMRF_LOOP_LIMIT];
    v[PHMRF_LOOP_SEEN] = 0;
  }
  v[PHMRF_LOOP_TICKET] = 0;
}

// Append a kernel node to `g` behind *last (no dependency when *last is
// null) and make it the new *last. The kernel's dynamic shared memory
// attribute must be set before (it is read when the node is made).
inline cudaError_t graph_append_kernel(cudaGraph_t g, cudaGraphNode_t* last,
                                       const void* func, dim3 grid,
                                       dim3 block, size_t smem,
                                       void** args) {
  cudaKernelNodeParams p = {};
  p.func = const_cast<void*>(func);
  p.gridDim = grid;
  p.blockDim = block;
  p.sharedMemBytes = (unsigned)smem;
  p.kernelParams = args;
  p.extra = nullptr;
  cudaGraphNode_t node;
  const cudaError_t err = cudaGraphAddKernelNode(
      &node, g, *last ? last : nullptr, *last ? 1 : 0, &p);
  if (err == cudaSuccess) *last = node;
  return err;
}

// Node makers of the kernels (mincut.cu, icm.cu): the same launch as
// phmrf_bfs_sweeps / phmrf_pr_iterations / phmrf_icm_pair, as a node.
cudaError_t phmrf_prepare_mincut();
cudaError_t phmrf_prepare_icm_pair(int th, int tw);
cudaError_t phmrf_bfs_node(cudaGraph_t g, cudaGraphNode_t* last,
                           const int* d, int* d_out, const float* caps,
                           int R, int H, int W, int n, int n_inner,
                           int* loop);
cudaError_t phmrf_pr_node(cudaGraph_t g, cudaGraphNode_t* last,
                          const float* e, const int* h, const float* cap_t,
                          const float* caps, float* e_out, int* h_out,
                          float* ct_out, float* caps_out, int R, int H,
                          int W, int n, int n_inner, int* loop);
cudaError_t phmrf_icm_pair_node(cudaGraph_t g, cudaGraphNode_t* last,
                                const int* labels, int* out,
                                const float* unary, const float* w,
                                const int* mask, int R, int K, int H, int W,
                                float beta, int row_parity, int th, int tw,
                                int threads, int* loop);
