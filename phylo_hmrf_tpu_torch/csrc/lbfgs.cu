// The M-step's boxed L-BFGS solve of the OU parameters: one launch a solve.
//
// Replaces no TPU kernel. The JAX package runs this solve as a vmapped
// lax.while_loop (phylo_hmrf_tpu/ops/lbfgs.py::minimize_boxed over the
// objectives of phylo_hmrf_tpu/models/ou.py), which XLA fuses on the TPU.
// The port ran it as ~1,230 small PyTorch kernels a step, replayed from CUDA
// graphs (ops/lbfgs.py::GraphSolve); here the whole solve of every row runs
// in one launch, with the carry on chip from the first step to the last.
//
// Bound: latency. A solve is B independent rows (the K states) of
// P = 3 n_nodes - 1 parameters. A step is 10 line-search points, each an OU
// recursion over the tree, an F x F covariance, its Cholesky and
// tr(V^-1 S) with their reverse-mode gradient (a few thousand flops), and
// the two-loop recursion over 10 pairs of P-vectors. The inputs are a few
// KB and a 150-step solve at K = 10 is ~16 MFLOP: each far below a
// microsecond of the card. The floor is the chain of up to 150 dependent
// steps, each a chain of dependent scalar operations and warp reductions.
//
// Layout: one warp a row (blockIdx.x), its carry in registers and shared
// memory for the whole solve. Lane l keeps coordinates l and l + 32 of x,
// g and the search direction, and its columns of the S / Y rings; the dot
// products of the two-loop recursion are xor-shuffle trees, so every lane
// holds the same sum bit for bit and every branch is warp-uniform. The 10
// line-search points run on lanes 0-9 at once, each the objective's value
// and gradient; the accepted point's gradient is the gradient at the new x
// (lbfgs_step's value_and_grad there computes the same function of the same
// input). The leaf count F is a template argument for F = 4 (the
// reference's tree, which every configuration runs), so the F x F matrices
// live in registers (128 registers in float32, 208 in float64, no spills);
// one more instantiation reads F (2-8) at run time, its matrices in local
// memory (unrolled for every count, the float64 sizes spilled and ptxas took
// minutes). The node recursion (n <= 16) reads the tree's index arrays from
// shared memory.
//
// The kernel is in lbfgs.cuh; this file builds the float32 entry and
// lbfgs_f64.cu the float64 one, so nvcc compiles the two in parallel.
//
// The arithmetic is lbfgs_step's and ou_nll_stats's, in the solve's dtype:
// IEEE exp, log, log1p, sqrt and division (no fast-math intrinsics), a
// division by a scalar done as PyTorch's CUDA kernels do it (a multiply by
// the reciprocal). The gradient is the reverse-mode derivative of the
// objective along the branches autograd takes (zero through the alpha
// floor's where, through a clamped Cholesky pivot and through the +inf
// log-determinant of a non-PD V). A row stops after 5 steps without a
// relative gain above 1e-7, or after n_iters steps, and keeps the carry the
// batched driver keeps for a stopped row; each row's step count is written
// out. No atomics and fixed reduction orders: repeated launches are bitwise
// equal.
#include "lbfgs.cuh"

PHMRF_LBFGS_ENTRY(phmrf_lbfgs_ou_f32, float)
