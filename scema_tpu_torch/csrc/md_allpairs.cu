// K1 and K3: the all-pairs pair loop of the fused MD kernel (device code
// in md_kernel.cuh), exported for ops/md_fused.py.
#include "md_kernel.cuh"

// the argument structure has internal linkage: the entries take it untyped
extern "C" int md_allpairs_run_f32(const void* a, void* stream) {
  return run_entry<false>(static_cast<const MDArgs*>(a), stream);
}

extern "C" int md_allpairs_forces_f32(const void* a, void* stream) {
  return forces_entry<false>(static_cast<const MDArgs*>(a), stream);
}
