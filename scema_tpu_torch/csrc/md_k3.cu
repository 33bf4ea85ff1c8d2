// K3, redesigned for Hopper: the all-pairs instances of md_charged.cuh
// (design notes there), exported for ops/md_fused.py.
#include "md_charged.cuh"

// the argument structure has internal linkage: the entries take it untyped
extern "C" int md_k3_run_f32(const void* a, void* stream) {
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  return (int)c_dispatch_run<false, K3_PATH, K3_THREADS>(*static_cast<const CArgs*>(a),
                                                        static_cast<cudaStream_t>(stream));
}

extern "C" int md_k3_forces_f32(const void* a, void* stream) {
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  return (int)c_dispatch_forces<false>(*static_cast<const CArgs*>(a),
                                       static_cast<cudaStream_t>(stream));
}

// out[4] = (registers, local bytes, blocks per SM, threads) of the run
// kernel (entry 0, the charged slice's flag set) or of the force entry's
// (entry 1) at N atoms of T types
extern "C" int md_k3_info(int entry, int N, int T, int* out) {
  if (out == nullptr || N <= 0 || T < 1 || entry < 0 || entry > 1)
    return (int)cudaErrorInvalidValue;
  if (entry == 1) return (int)c_forces_info<false>(N, T, out);
  return (int)c_run_info(k34_run_kernel<false, true, true, true, true, true, K3_PATH, K3_THREADS>,
                         N, T, true, false, out);
}
