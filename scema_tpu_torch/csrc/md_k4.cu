// K4 (and its streamed job-grid form K4s), redesigned for Hopper: the
// compact-list instances of md_charged.cuh (design notes there), exported
// for ops/md_fused.py.
#include "md_charged.cuh"

// the argument structure has internal linkage: the entries take it untyped
extern "C" int md_k4_run_f32(const void* a, void* stream) {
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  return (int)c_dispatch_run<true, K4_PATH, K4_THREADS>(*static_cast<const CArgs*>(a),
                                                         static_cast<cudaStream_t>(stream));
}

extern "C" int md_k4_forces_f32(const void* a, void* stream) {
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  return (int)c_dispatch_forces<true>(*static_cast<const CArgs*>(a),
                                      static_cast<cudaStream_t>(stream));
}

// out[4] as md_k3_info's, for K4's run (entry 0) and force (entry 1) kernels
extern "C" int md_k4_info(int entry, int N, int T, int* out) {
  if (out == nullptr || N <= 0 || T < 1 || entry < 0 || entry > 1)
    return (int)cudaErrorInvalidValue;
  if (entry == 1) return (int)c_forces_info<true>(N, T, out);
  return (int)c_run_info(k34_run_kernel<true, true, true, true, true, true, K4_PATH, K4_THREADS>,
                         N, T, true, false, out);
}
