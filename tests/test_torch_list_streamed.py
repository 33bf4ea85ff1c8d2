"""K4's plain version against the JAX package's HMM-streamed gather-list
kernel in its job-grid launch form (K4s: ``force_k_chunk=8``,
``_build_streamed_grid_call``, forced in interpret mode by
SCEMA_TEST_GRID_CALL=1 as tests/test_allatom_fused.py does), one 10-step
deform chunk with SHAKE and the frozen k-space force, on JAX's own
channels: 1e-10 A (~50 s, the interpret-mode compile)."""
import jax

from torch_list_util import fused_chunk_vs_plain, systems


def test_plain_list_run_matches_streamed_grid_kernel(monkeypatch):
    jsys, jst, tsys, _ = systems(force_k_chunk=8)
    assert jsys.fused.spec.k_chunk == 8 and jsys.fused.spec.k == 56
    monkeypatch.setenv("SCEMA_TEST_GRID_CALL", "1")
    jax.clear_caches()
    try:
        dpos, dvel, dvxi = fused_chunk_vs_plain(jsys, jst, tsys)
    finally:
        monkeypatch.setenv("SCEMA_TEST_GRID_CALL", "0")
        jax.clear_caches()
    assert dpos < 1e-10 and dvel < 1e-10 and dvxi < 1e-10
