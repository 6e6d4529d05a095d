// B1 and B2 built for float16 X, compensated: a float16 policy's sweeps
// (csrc/sweep.cuh holds the tile code; kernel_matvec.cu the entry points).
// A source of its own, so that its nvcc runs beside the others.
#include "sweep.cuh"

namespace rt {

RT_SWEEP_VARIANT(f16c, __half, true)

}  // namespace rt
