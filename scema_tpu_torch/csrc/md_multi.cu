// K1m's first design: K1's first design with J jobs per thread block in
// turn (md_run_multi_kernel in md_kernel.cuh, design notes there),
// exported for ops/md_fused.py's A/B and checks (_run_multi_first); the
// path runs the redesign, md_k1m.cu.  A source of its own, so that nvcc
// builds it beside md_allpairs.cu and not after it.  Replaces the TPU kernel's FusedSpec.jobs > 1 program,
// scema_tpu/ops/md_fused.py:1850 (entries :2415, :2450).
#include "md_kernel.cuh"

// K1's flag set only, J = 2 or 4 jobs per block, B a multiple of J; the
// argument structure has internal linkage, so the entry takes it untyped
extern "C" int md_allpairs_run_multi_f32(const void* args, int jobs, void* stream) {
  const MDArgs* a = static_cast<const MDArgs*>(args);
  if (!args_ok<false>(a) || a->coul || a->ewald || a->topo3.n_pat || a->topo3.n_shk ||
      a->fext || a->K || a->sw.rc > 0.f || jobs < 1 || a->B % jobs != 0)
    return (int)cudaErrorInvalidValue;
  RunArgs A{a->invm, a->mftm, a->state, a->vxi, a->press, a->n_run, a->gstep0, a->n_tot,
            a->fscal, a->fext, a->deform, a->sample, a->ndof, a->boltz, a->nktv2p, a->tdamp};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (jobs) {
    case 2: return static_cast<int>(launch_run_multi<2>(params_of(a), a->topo3, A, a->B, s));
    case 4: return static_cast<int>(launch_run_multi<4>(params_of(a), a->topo3, A, a->B, s));
    default: return (int)cudaErrorInvalidValue;
  }
}
