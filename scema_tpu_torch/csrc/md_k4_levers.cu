// K4's design steps as instances of their own (md_charged.cuh), for the
// timings of chip_smoke.py phase 8 only; no path of the port launches them.
//   0  a     the compact slot alone: every row reads all K slots, one row
//            per thread, 768 threads (the first design's width)
//   1  b     a + each row stops at its count of live slots
//   2  c     b + two rows per thread in one slot loop
//   3  c1024 c at 1024 threads (64 registers)
//   4  c576  c at 576 threads (113 registers)
//   5  cu    c unpinned (ptxas's own register count)
//   6  n     the path without the bonded and SHAKE/RATTLE passes
//   7  p2    c with each row's next 2 slot words loaded ahead
//   8  p4    c with each row's next 4 slot words loaded ahead
//   9  p4s   b (one row per thread) with its next 4 words loaded ahead
//   10 p8s   b with its next 8 words loaded ahead (the path)
//   11 np    the path without the bonded passes
//   12 ns    the path without the SHAKE/RATTLE passes
#include "md_charged.cuh"

namespace {

Lever k4_lever(int id) {
  switch (id) {
    case 0: return lever<true, 0, 768>();
    case 1: return lever<true, V_COUNT, 768>();
    case 2: return lever<true, V_COUNT | V_TWO, 768>();
    case 3: return lever<true, V_COUNT | V_TWO, 1024>();
    case 4: return lever<true, V_COUNT | V_TWO, 576>();
    case 5: return lever<true, V_COUNT | V_TWO, 0>();
    case 6: return lever<true, K4_PATH | V_NOBOND, K4_THREADS>();
    case 7: return lever<true, V_COUNT | V_TWO | V_AHEAD2, 768>();
    case 8: return lever<true, V_COUNT | V_TWO | V_AHEAD4, 768>();
    case 9: return lever<true, V_COUNT | V_AHEAD4, 768>();
    case 10: return lever<true, V_COUNT | V_AHEAD8, 768>();
    case 11: return lever<true, K4_PATH | V_NOPAT, K4_THREADS>();
    case 12: return lever<true, K4_PATH | V_NOSHK, K4_THREADS>();
    default: return {nullptr, false};
  }
}

}  // namespace

extern "C" int md_k4_lever_run_f32(const void* a, int id, void* stream) {
  const Lever L = k4_lever(id);
  if (a == nullptr || L.kernel == nullptr) return (int)cudaErrorInvalidValue;
  const CArgs& A = *static_cast<const CArgs*>(a);
  if (!c_lever_ok(A, true)) return (int)cudaErrorInvalidValue;
  return (int)c_launch_run_kernel(L.kernel, A, L.two, static_cast<cudaStream_t>(stream));
}

extern "C" int md_k4_lever_info(int id, int N, int T, int* out) {
  const Lever L = k4_lever(id);
  if (out == nullptr || N <= 0 || T < 1 || L.kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)c_run_info(L.kernel, N, T, L.two, out);
}
