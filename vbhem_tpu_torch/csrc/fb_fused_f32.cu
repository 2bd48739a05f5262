// Kernel B2 (fb.cuh), the kernels of the fused E-step (the emission scores
// formed from x, D = 1..3) in float, K = 1..8.
#include "fb.cuh"

namespace vbhem_fb {

int fused_f32(const Args& a) { return launch_k<Fused, float>(a); }

}  // namespace vbhem_fb
