// The fused L-BFGS solve of the OU parameters (lbfgs.cuh): the float64 entry.
#include "lbfgs.cuh"

PHMRF_LBFGS_ENTRY(phmrf_lbfgs_ou_f64, double)
