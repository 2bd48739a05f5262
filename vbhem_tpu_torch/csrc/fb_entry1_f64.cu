// Kernel B2 (fb.cuh), the kernels of entry 1 (log_rho given; the resident
// and the streamed design) in double, K = 1..8.
#include "fb.cuh"

namespace vbhem_fb {

int entry1_f64(const Args& a) { return launch_k<Entry1, double>(a); }

}  // namespace vbhem_fb
