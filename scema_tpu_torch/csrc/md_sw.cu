// K5's first design: the Stillinger-Weber sweeps of the fused MD kernel
// (device code and design notes in md_kernel.cuh), exported for
// ops/md_fused.py's A/B and checks (_run_first, _forces_first); the path
// runs the redesign, md_k5.cu.  Replaces
// the TPU kernel's SW branch, scema_tpu/ops/md_fused.py FusedSpec.sw ->
// forces_allpairs_sw (:910-1081), launched by the pallas_call at :1850.
#include "md_kernel.cuh"

// the argument structure has internal linkage: the entries take it untyped
extern "C" int md_sw_run_f32(const void* a, void* stream) {
  return run_entry<false, true>(static_cast<const MDArgs*>(a), stream);
}

extern "C" int md_sw_forces_f32(const void* a, void* stream) {
  return forces_entry<false, true>(static_cast<const MDArgs*>(a), stream);
}
