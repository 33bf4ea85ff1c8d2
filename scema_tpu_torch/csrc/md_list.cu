// K4 (and its streamed job-grid form K4s): the gather-list pair loop of
// the fused MD kernel (device code and design notes in md_kernel.cuh),
// exported for ops/md_fused.py.  Replaces the TPU kernel's gather-list
// branch, scema_tpu/ops/md_fused.py forces -> pair_tile (:1261-1411) with
// gather3 (:855), and the streamed grid call of :1603-1722.
#include "md_kernel.cuh"

// the argument structure has internal linkage: the entries take it untyped
extern "C" int md_list_run_f32(const void* a, void* stream) {
  return run_entry<true>(static_cast<const MDArgs*>(a), stream);
}

extern "C" int md_list_forces_f32(const void* a, void* stream) {
  return forces_entry<true>(static_cast<const MDArgs*>(a), stream);
}
