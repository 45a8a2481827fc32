// The kWide forms of B3/B4 (sx_fused_kernel) and B5 (sx_blocked_kernel):
// layouts whose systematics transform a sample field past the fourth
// (nload > SX_MAXOBS), as the JAX package's kernels take any field.
// Built in a translation unit of their own: beside the other forms'
// runtime choice of binning, the binning that holds every field cost
// registers (up to 64 from 55) and, in the lock-step B5 forms, spills
// (measured with ptxas -v); and the two units compile in parallel.

#include "sxmc_fused.cuh"

const void* sx_fused_fn_wide(int nchains, int form) {
  return sx_fused_fn_t<true>(nchains, form);
}

const void* sx_blocked_fn_wide(int nchains, bool grouped) {
  return sx_blocked_fn_t<true>(nchains, grouped);
}
