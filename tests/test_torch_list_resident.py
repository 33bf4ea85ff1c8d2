"""K4's plain version against the JAX package's gather-list Pallas kernel
in interpret mode, resident form (k_chunk = 0: the whole channel set in
one block), one 10-step deform chunk of a 20-step run with SHAKE and the
frozen k-space force, on JAX's own channels: 1e-10 A (the same formulas
in float64; ~50 s, the interpret-mode compile)."""
from torch_list_util import fused_chunk_vs_plain, systems


def test_plain_list_run_matches_resident_kernel():
    jsys, jst, tsys, _ = systems()
    assert jsys.fused.spec.k_chunk == 0 and not jsys.fused.spec.allpairs
    assert tsys.fused.spec.k == jsys.fused.spec.k == 56
    dpos, dvel, dvxi = fused_chunk_vs_plain(jsys, jst, tsys, n_run=10, gstep0=10, n_tot=20)
    assert dpos < 1e-10 and dvel < 1e-10 and dvxi < 1e-10
