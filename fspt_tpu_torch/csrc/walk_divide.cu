// csrc/walk.cu with the leaf tests' reciprocals left to the compiler's
// 1.0f / x (a call of its division subroutine where the range test fails, a
// branch around it elsewhere) instead of walk.cu's split sequence that runs
// two triangles' reciprocals side by side.  A measurement build, loaded by
// fspt_tpu_torch/scripts/perf_walk_launches.py alone, which times it beside
// walk.cu to show what the split buys; the results are the same to the bit.
#define FSPT_RCP_BY_DIVIDE
#include "walk.cu"
