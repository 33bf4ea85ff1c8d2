"""The benchmark's frozen copies hold equal to their originals (chip_smoke.py,
profile_slice and the port's plain kernel arithmetic) on small shapes."""
from __future__ import annotations

import importlib.util
import os
from types import SimpleNamespace

import pytest
import torch

from _tiny import ROOT

from hmm_bench import roofline as RL
from hmm_bench import trace as TR
from hmm_bench.reference import fe as RF
from hmm_bench.reference import md as RM


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_original",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _boxes(n=40, b=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    h = torch.diag_embed(torch.rand((b, 3), generator=g, dtype=torch.float64) * 4 + 9)
    h[:, 0, 1] = 0.7
    h[:, 0, 2] = -0.4
    h[:, 1, 2] = 0.3
    pos = torch.rand((b, n, 3), generator=g, dtype=torch.float64) @ h.transpose(-1, -2)
    return pos, h


def test_roofline_counts_match_chip_smoke():
    cs = _chip_smoke()
    assert (RL.HBM_BPS, RL.F32_FLOPS) == (cs.HBM_BPS, cs.F32_FLOPS)
    assert (RL.FLOP_GEOM, RL.FLOP_LJ, RL.FLOP_EWALD, RL.FLOP_APPLY, RL.FLOP_VIRIAL) == (
        cs.FLOP_GEOM, cs.FLOP_LJ, cs.FLOP_EWALD, cs.FLOP_APPLY, cs.FLOP_VIRIAL)
    assert (RL.FLOP_SW, RL.FLOP_SW_VIRIAL) == (cs.FLOP_SW, cs.FLOP_SW_VIRIAL)
    pos, h = _boxes()
    skip = torch.zeros((40, 40), dtype=torch.bool)
    skip[0, 1] = skip[1, 0] = True
    for args in ((16.0,), (25.0, 9.0), (16.0, 0.0, skip)):
        assert RL.pair_fractions(pos, h, *args) == cs.pair_fractions(pos, h, *args)
    assert RL.sw_live_pairs(pos, h, 14.0) == cs.sw_live_pairs(pos, h, 14.0)
    for v in (False, True):
        assert RL.pair_flops(512, 1100, 0.26, 0.1, v) == cs.pair_flops(512, 1100, 0.26, 0.1, v)
        assert RL.sw_flops(216, 1100, 1300.5, v) == cs.sw_flops(216, 1100, 1300.5, v)
    for b, f in ((1e6, 1e9), (1e9, 1e6)):
        assert RL.bound(b, f) == cs.bound(b, f)


def test_device_busy_matches_profile_slice():
    from scema_tpu_torch.profile_slice import _device_busy_us

    ev = [SimpleNamespace(time_range=SimpleNamespace(start=s, end=e))
          for s, e in ((0, 5), (3, 9), (12, 14), (13, 13.5), (20, 21))]
    assert TR.device_busy_us(ev) == _device_busy_us(ev) == 12.0


def _port_runner(sys_kind):
    from scema_tpu_torch.md import material as M

    spec = (M.MaterialSpec(name="si", force_field="sw", n_cells=2) if sys_kind == "sw" else
            M.MaterialSpec(name="g0", force_field="opls", n_chains=8, opls_lj_cutoff=6.0,
                           validate=False))
    sys_, st = M.build_system(spec, dtype=torch.float64, device="cpu")
    return sys_, st


@pytest.mark.parametrize("kind", ["chain", "sw"])
def test_reference_md_matches_the_plain_kernels(kind):
    """The reference's tables, forces and strained + sampled run equal the
    port's plain versions from one state (float64)."""
    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md.homogenization import MDParams, strain_and_homogenize

    sys_, st = _port_runner("sw" if kind == "sw" else "chain")
    ref = RM.sw_system((2, 2, 2)) if kind == "sw" else RM.g0_system(8, 8, 6.0)
    g = torch.Generator().manual_seed(3)
    B = 3
    pos = (st.pos + 0.05 * torch.randn((B,) + st.pos.shape, generator=g, dtype=torch.float64))
    vel = 0.002 * torch.randn(pos.shape, generator=g, dtype=torch.float64)
    h = st.h.expand(B, 3, 3).clone()
    vxi = torch.zeros((B, 3), dtype=torch.float64)
    state = E.MDState(pos=pos, vel=vel, h=h, vxi=vxi)
    F, W = E.forces_virial(sys_, pos, h)
    f, w6 = RM.forces(ref, [pos[..., a] for a in range(3)], RM.h6_of(h), True)
    assert torch.allclose(torch.stack(f, -1), F, rtol=1e-10, atol=1e-10)
    assert torch.allclose(torch.stack(w6, -1), W, rtol=1e-10, atol=1e-8)
    params = MDParams(temperature=300.0, dt=2.0, strain_rate=1e-4, nsteps_sample=20)
    dl = torch.tensor([[2e-3, -1e-3, 5e-4, 3e-4, 0.0, -2e-4]], dtype=torch.float64) * \
        torch.tensor([[1.0], [2.0], [0.5]], dtype=torch.float64) * 10.0
    out, sig = strain_and_homogenize(sys_, state, dl, params)
    p, v, xi, hr, sr, nts = RM.strain_and_sample(ref, pos, vel, vxi, h, dl, 1e-4, 2.0, 300.0, 20)
    assert torch.allclose(sr, sig, rtol=1e-9, atol=1e-3)
    assert torch.allclose(p, out.pos, atol=1e-9)
    assert torch.allclose(hr, out.h, atol=1e-12)


def test_reference_fe_geometry_matches_the_port():
    from scema_tpu_torch.config import HMMConfig
    from scema_tpu_torch.fem import shapes
    from scema_tpu_torch.fem.problem_types import make_dogbone

    cfg = HMMConfig()
    prob = make_dogbone(cfg, torch.float64, "cpu")
    geom = shapes.precompute_geometry(prob.mesh.nodes, prob.mesh.cells, 2)
    g = RF.geometry({"quadrature formula": 2, "input": {}}, torch.float64, "cpu")
    assert torch.equal(g.cells, geom.cells)
    assert torch.allclose(g.grads, geom.grads, rtol=0, atol=1e-12)
    assert torch.allclose(g.jxw, geom.jxw, rtol=1e-14, atol=0)
    bc = RF.dogbone(g, 0.002, 5e-7, torch.float64, "cpu")
    assert torch.equal(bc.constrained, prob.constrained_mask(1))
    assert torch.equal(bc.pulled, prob.bc_inc_velocity(1))
