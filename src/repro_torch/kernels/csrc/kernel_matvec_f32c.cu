// B1 and B2 built for fp32 X, compensated: the reference's compensated=True fp32 case
// (csrc/sweep.cuh holds the tile code; kernel_matvec.cu the entry points).
// A source of its own, so that its nvcc runs beside the others.
#include "sweep.cuh"

namespace rt {

RT_SWEEP_VARIANT(f32c, float, true)

}  // namespace rt
