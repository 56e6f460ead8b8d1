// Kernel H for 3 movers, circle collision shape: the four instantiations
// (layout rule x noise mode) of planning_multi.cuh, compiled by their own
// nvcc process beside the other mover counts and shapes.

#include "planning_multi.cuh"

namespace gprt {
template GPRT_MULTI_LAUNCH_SIGNATURE(3, false);
}  // namespace gprt
