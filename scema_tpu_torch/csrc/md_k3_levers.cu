// K3's design steps as instances of their own (md_charged.cuh), for the
// timings of chip_smoke.py phase 6 only; no path of the port launches them.
//   0  t  the type table and window, one row per thread, 896 threads
//   1  u  two rows per thread, unpinned (ptxas's own register count)
//   2  i  the path (two rows, 896 threads) with 1 / sqrtf for rsqrtf
//   3  n  the path without the bonded and SHAKE/RATTLE passes
//   4  np the path without the bonded passes
//   5  ns the path without the SHAKE/RATTLE passes
#include "md_charged.cuh"

namespace {

Lever k3_lever(int id) {
  switch (id) {
    case 0: return lever<false, 0, K3_THREADS>();
    case 1: return lever<false, V_TWO, 0>();
    case 2: return lever<false, K3_PATH | V_IEEE, K3_THREADS>();
    case 3: return lever<false, K3_PATH | V_NOBOND, K3_THREADS>();
    case 4: return lever<false, K3_PATH | V_NOPAT, K3_THREADS>();
    case 5: return lever<false, K3_PATH | V_NOSHK, K3_THREADS>();
    default: return {nullptr, false};
  }
}

}  // namespace

extern "C" int md_k3_lever_run_f32(const void* a, int id, void* stream) {
  const Lever L = k3_lever(id);
  if (a == nullptr || L.kernel == nullptr) return (int)cudaErrorInvalidValue;
  const CArgs& A = *static_cast<const CArgs*>(a);
  if (!c_lever_ok(A, false)) return (int)cudaErrorInvalidValue;
  return (int)c_launch_run_kernel(L.kernel, A, L.two, static_cast<cudaStream_t>(stream));
}

extern "C" int md_k3_lever_info(int id, int N, int T, int* out) {
  const Lever L = k3_lever(id);
  if (out == nullptr || N <= 0 || T < 1 || L.kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)c_run_info(L.kernel, N, T, L.two, out);
}
