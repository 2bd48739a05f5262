// Kernel B2 (fb.cuh), the kernels of the fused E-step (the emission scores
// formed from x, D = 1..3) in double, K = 1..8.
#include "fb.cuh"

namespace vbhem_fb {

int fused_f64(const Args& a) { return launch_k<Fused, double>(a); }

}  // namespace vbhem_fb
