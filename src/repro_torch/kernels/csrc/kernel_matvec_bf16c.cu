// B1 and B2 built for bf16 X, compensated: the bf16 policy's sweeps
// (csrc/sweep.cuh holds the tile code; kernel_matvec.cu the entry points).
// A source of its own, so that its nvcc runs beside the others.
#include "sweep.cuh"

namespace rt {

RT_SWEEP_VARIANT(bf16c, __nv_bfloat16, true)

}  // namespace rt
