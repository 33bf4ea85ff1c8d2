// K4's form for list boxes above one block's shared memory (md_charged.cuh's
// V_GLOBAL: the velocities and the role/SHAKE buffer in a per-job scratch
// in device memory, design notes there), exported for ops/md_fused.py,
// which sends a K4 run here when its box exceeds the shared form's cap.  A
// source of its own, so that nvcc builds its instances beside md_k4.cu's.
// Replaces, with md_k4.cu, the gather-list branch of the TPU kernel
// scema_tpu/ops/md_fused.py::_make_kernel (pair_tile :1269-1300) in its
// HBM-streamed job-grid form (_build_streamed_grid_call :1603, :1678).
#include "md_charged.cuh"

// the argument structure has internal linkage: the entry takes it untyped
extern "C" int md_k4_big_run_f32(const void* a, void* stream) {
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  return (int)c_dispatch_run<true, K4_BIG_PATH, K4_THREADS>(*static_cast<const CArgs*>(a),
                                                             static_cast<cudaStream_t>(stream));
}

// out[4] as md_k4_info's, for the global form's run kernel (the charged
// slices' flag set) at N atoms of T types
extern "C" int md_k4_big_info(int N, int T, int* out) {
  if (out == nullptr || N <= 0 || T < 1) return (int)cudaErrorInvalidValue;
  return (int)c_run_info(
      k34_run_kernel<true, true, true, true, true, true, K4_BIG_PATH, K4_THREADS>, N, T, false,
      true, out);
}
