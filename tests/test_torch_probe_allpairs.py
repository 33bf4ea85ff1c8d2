"""P1, the kernel lab's slim all-pairs LJ run (scripts/probe_allpairs.py
``run_slim``), against the port (scema_tpu_torch.ops.md_slim and
scema_tpu_torch.probe_allpairs), float64 on the CPU.

The JAX side is the lab's own ``run_slim`` with its Pallas kernel in TPU
interpret mode (``pl.pallas_call`` wrapped, as tests/test_sw_pallas.py
does); the lab is imported by path and left as it is.  Its ``N_ATOMS``
global sets the thermostat's ndof when the kernel is traced, so each run
sets it first and traces afresh.  The lab's cached variants read their
image scratch before the first refresh (ROADMAP §3): interpret mode with
zeroed scratch gives them the right images only on a box whose images at
step 0 are all zero, which is where the variants are compared one to one.

Boxes (128 or 256 atoms per job, and 640 above the redesign's first
instance; 25 steps of 2 fs at 300 K, so the image refresh at step 20 runs,
with a tilted box under a mixed strain):
* the cluster: a simple-cubic cluster (4.4 A) inside a 70 A box (100 A at
  640 atoms), every pair within half the box, so every image is zero;
* the lattice: a periodic simple-cubic lattice (6.2 A) filling the box,
  so pairs cross the boundary; half the shortest box length exceeds the
  cutoff by 2.4 A, the drift the cached images allow.

Tolerance 1e-10 (A, A/fs, and relative on the chain and 2 KE) everywhere:
the compared runs differ only in summation order.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scema_tpu_torch import interop
from scema_tpu_torch import probe_allpairs as PA
from scema_tpu_torch.ops import md_slim as MS
from torch_port_util import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RUN = 25
EPS = [1e-3, 0.0, 3e-4, 2e-4, 0.0, 1e-4]
VXI = (0.01, -0.02, 0.005)
TILT = (0.6, 0.3, 0.4)
TOL = 1e-10
# lane tiles per job and jobs per program of each variant's comparison
# (Newton halving by tile needs two tiles to reach its reaction side)
CASES = {"v1": (1, 1), "v2": (1, 1), "v3": (1, 1), "v4": (1, 1), "v5": (2, 1),
         "v5p": (2, 1), "v5r": (2, 1), "v5m": (2, 1), "v8": (2, 1), "v7": (2, 2),
         "v7p": (2, 2), "v7d4": (1, 4)}


@pytest.fixture(scope="module")
def lab(one_torch_thread):
    spec = importlib.util.spec_from_file_location(
        "probe_allpairs_lab", os.path.join(REPO, "scripts", "probe_allpairs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_run(lab, variant, nt, jobs, state, w4e, sig2, iscal, fscal, n_atoms=None,
             interpret=None):
    """The lab's run_slim traced afresh with N_ATOMS set, its kernel in
    interpret mode (zeroed scratch unless ``interpret`` says otherwise)."""
    lab.N_ATOMS = nt * MS.LANE if n_atoms is None else n_atoms
    ip = pltpu.InterpretParams(uninitialized_memory="zero") if interpret is None else interpret
    orig = lab.pl.pallas_call
    lab.pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": ip})

    def fresh(state, w4e, sig2, iscal, fscal):  # a new function: jit traces it anew
        return lab.run_slim.__wrapped__(variant, nt, state, w4e, sig2, iscal, fscal, jobs=jobs)

    try:
        out, sacc = jax.jit(fresh)(jnp.asarray(state), jnp.asarray(w4e), jnp.asarray(sig2),
                                   jnp.asarray(iscal, jnp.int32), jnp.asarray(fscal))
        return np.asarray(out), np.asarray(sacc)
    finally:
        lab.pl.pallas_call = orig


def _grid(shape, a, seed, origin=0.0):
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*(np.arange(k) for k in shape), indexing="ij"), -1)
    return origin + a * g.reshape(-1, 3) + 0.05 * rng.standard_normal((g.size // 3, 3))


def _box(kind, nt, seed):
    """One job's (positions, h6) of 128 nt atoms, nt = 1, 2 or 5."""
    shape = {1: (4, 4, 8), 2: (4, 8, 8), 5: (8, 8, 10)}[nt]
    if kind == "cluster":
        L = 70.0 if nt <= 2 else 100.0
        h6 = np.array([L, L, L, *TILT])
        return _grid(shape, 4.4, seed, origin=L / 2 - 4.4 * np.array(shape) / 2), h6
    a = 6.2
    lx, ly, lz = (a * k for k in shape)
    H = np.array([[lx, TILT[0], TILT[1]], [0.0, ly, TILT[2]], [0.0, 0.0, lz]])
    frac = (_grid(shape, 1.0, seed) + 0.5) / np.array(shape)
    return frac @ H.T, np.array([lx, ly, lz, *TILT])


def _planes(n, seed):
    """The lab's kind of planes at n atoms: two types, chain exclusions,
    uniform sigma (so v4's scalar sigma is the plane's)."""
    rng = np.random.default_rng(seed)
    types = rng.integers(0, 2, n)
    eps_t = np.array([0.175, 0.118])
    w = 1.0 - np.eye(n)
    for i in range(n - 1):
        w[i, i + 1] = w[i + 1, i] = 0.0
    w4e = 4.0 * np.sqrt(eps_t[types][:, None] * eps_t[types][None, :]) * w
    return w4e, np.full((n, n), MS.SIG2_UNIFORM)


def _inputs(kind, nt, jobs, copies=False, seed=0):
    """A program of ``jobs`` boxes (distinct velocities and noise, or
    ``copies`` of one box): state (8, J NT, 128), w4e, sig2, iscal, fscal."""
    n = nt * MS.LANE
    rng = np.random.default_rng(100 + seed)
    states = []
    for j in range(jobs):
        pos, h6 = _box(kind, nt, seed if copies else seed + j)
        vel = (np.random.default_rng(200 + seed) if copies else rng).normal(0, 0.004, (n, 3))
        masses = np.where(np.arange(n) % 2, 14.0, 15.0)
        states.append(MS.pack_state(pos, vel, masses, np.float64))
    w4e, sig2 = _planes(n, seed)
    fscal = MS.make_fscal(h6, EPS, vxi=VXI)
    return np.concatenate(states, 1), w4e, sig2, np.array([N_RUN, N_RUN]), fscal


def _port(variant, state, w4e, sig2, iscal, fscal):
    w, s = MS.variant_planes(variant, w4e, sig2)
    out, sacc = MS.slim_run(variant, *interop.slim_inputs_from_jax(state, w, s, iscal, fscal))
    return out[0].numpy(), sacc[0].numpy()


def _close(port, ref):
    (st, sacc), (st_r, sacc_r) = port, ref
    assert np.isfinite(st).all() and np.isfinite(sacc).all()
    assert np.abs(st[:6] - st_r[:6]).max() < TOL
    assert np.array_equal(st[6:], st_r[6:])
    assert np.abs(sacc[:4] - sacc_r[:4]).max() < TOL * max(1.0, np.abs(sacc_r[:4]).max())
    assert not sacc[4:].any()


@pytest.fixture(scope="module")
def cluster_runs(lab):
    """JAX's run of each variant on the cluster program of its case, with
    zeroed scratch (right here: every image at step 0 is zero)."""
    runs = {}

    def get(variant):
        if variant not in runs:
            nt, jobs = CASES[variant]
            inp = _inputs("cluster", nt, jobs)
            w, s = MS.variant_planes(variant, inp[1], inp[2])
            runs[variant] = inp, _jax_run(lab, variant, nt, jobs, inp[0], w, s, *inp[3:])
        return runs[variant]
    return get


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_build_inputs_and_pack_state_match_lab(lab, dtype):
    lab.N_ATOMS = MS.N_ATOMS
    mine = MS.build_inputs(MS.N_ATOMS, dtype)
    theirs = [np.asarray(a) for a in lab.build_inputs(jnp.dtype(dtype))]
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    st = MS.pack_state(mine[0], mine[1], mine[2], dtype)
    st_lab = np.asarray(lab.pack_state(*(jnp.asarray(a) for a in theirs[:3]), jnp.dtype(dtype)))
    assert st.dtype == st_lab.dtype and np.array_equal(st, st_lab)


@pytest.mark.parametrize("variant", list(MS.VARIANTS))
def test_variant_matches_lab_on_zero_image_box(cluster_runs, variant):
    inp, ref = cluster_runs(variant)
    assert np.abs(ref[0][:3] - inp[0][:3]).max() > 1e-3  # the atoms moved
    _close(_port(variant, *inp), ref)


@pytest.fixture(scope="module")
def lattice_v1(lab):
    """JAX's v1 (no image cache) on the lattice at 1 and 2 tiles, and with
    2 KE x J and ndof x J, which is each box of J copies under one chain."""
    runs = {}

    def get(nt, jobs):
        if (nt, jobs) not in runs:
            state, w4e, sig2, iscal, fscal = _inputs("lattice", nt, 1, copies=True)
            state = state.copy()
            state[7] *= jobs  # 2 KE of J copies
            n_atoms = jobs * (nt * MS.LANE - 1) + 1  # 3 N' - 3 = J (3 N - 3)
            runs[nt, jobs] = _jax_run(lab, "v1", nt, 1, state, w4e, sig2, iscal, fscal,
                                      n_atoms=n_atoms)
        return runs[nt, jobs]
    return get


@pytest.mark.parametrize("variant", [v for v in MS.VARIANTS if v != "v1"])
def test_cached_variant_matches_lab_v1_across_boundaries(lattice_v1, variant):
    nt, jobs = CASES[variant]
    state, w4e, sig2, iscal, fscal = _inputs("lattice", nt, jobs, copies=True)
    lx = fscal[2]
    pos = state[:3].reshape(3, -1)
    assert np.abs(pos[0][:, None] - pos[0][None, :]).max() > lx / 2  # images are not all 0
    st, sacc = _port(variant, state, w4e, sig2, iscal, fscal)
    ref_st, ref_sacc = lattice_v1(nt, jobs)
    ref_st = ref_st.reshape(8, -1).copy()
    ref_st[7] /= jobs
    for j in range(jobs):
        _close((st.reshape(8, jobs, -1)[:, j], sacc), (ref_st, ref_sacc))


# 640 atoms per box (nt = 5): above the redesign's first instance, run on
# its big-box instance on the card; here the plain version against the lab
NT_BIG = 5


@pytest.fixture(scope="module")
def big_v7_cluster(lab):
    """JAX's v7 on two 640-atom cluster boxes (every image zero, so its
    zeroed scratch is right before the first refresh)."""
    inp = _inputs("cluster", NT_BIG, 2)
    w, s = MS.variant_planes("v7", inp[1], inp[2])
    return inp, _jax_run(lab, "v7", NT_BIG, 2, inp[0], w, s, *inp[3:])


@pytest.mark.parametrize("variant,kind", [("v1", "lattice"), ("v7", "cluster"),
                                          ("v7", "lattice")])
def test_640_atom_boxes_match_lab(lattice_v1, big_v7_cluster, variant, kind):
    """At 640 atoms per box, the lab's N_ATOMS set to 640: v1 (J = 1) on the
    periodic lattice against the lab's v1; v7 (J = 2) on the cluster against
    the lab's v7, and on two copies of the lattice (images not all zero,
    refreshed at step 20) against the lab's v1 over the same copies under
    one chain."""
    J = MS.VARIANTS[variant].jobs
    if kind == "cluster":
        inp, ref = big_v7_cluster
        assert np.abs(ref[0][:3] - inp[0][:3]).max() > 1e-3  # the atoms moved
        _close(_port(variant, *inp), ref)
        return
    state, w4e, sig2, iscal, fscal = _inputs("lattice", NT_BIG, J, copies=True)
    pos = state[:3].reshape(3, -1)
    assert np.abs(pos[0][:, None] - pos[0][None, :]).max() > fscal[2] / 2  # images not all 0
    st, sacc = _port(variant, state, w4e, sig2, iscal, fscal)
    ref_st, ref_sacc = lattice_v1(NT_BIG, J)
    ref_st = ref_st.reshape(8, -1).copy()
    ref_st[7] /= J
    for j in range(J):
        _close((st.reshape(8, J, -1)[:, j], sacc), (ref_st, ref_sacc))


def test_lab_cache_read_before_refresh_and_port_repair(lab, cluster_runs):
    """ROADMAP §3: the lab's v2 reads its image scratch before the first
    refresh; interpret mode's uninitialised memory is NaN, so one step makes
    the state NaN.  The port refreshes first, and its v2 is JAX's v1."""
    inp = _inputs("cluster", 1, 1)
    one = np.array([1, N_RUN])
    st, _ = _jax_run(lab, "v2", 1, 1, inp[0], inp[1], inp[2], one, inp[4], interpret=True)
    assert np.isnan(st[:6]).any()
    (_, ref) = cluster_runs("v1")
    _close(_port("v2", *inp), ref)


@pytest.mark.parametrize("variant", ["v1", "v2", "v5", "v7"])
def test_plain_image_guard(variant):
    """The kernel's int8 image cache holds no image beyond +-127: a program
    with one atom 200 box lengths out comes back with NaN positions, and the
    plain version does the same; the other program is untouched, and v1,
    which keeps no cache, runs the moved atom in the same box."""
    nt, jobs = CASES[variant]
    state, w4e, sig2, _, fscal = _inputs("cluster", nt, jobs)
    w, s = MS.variant_planes(variant, w4e, sig2)
    x, w, s, _, fs = interop.slim_inputs_from_jax(state, w, s, np.array([1, 1]), fscal)
    x = torch.cat([x, x])
    x[1, 0, 0, 0] += 200.0 * fscal[2]
    out, _ = MS.slim_run(variant, x, w, s, torch.tensor([1, 1]), fs[0])
    assert torch.isnan(out[:, :3]).flatten(1).any(1).tolist() == [False, variant != "v1"]
    alone, _ = MS.slim_run(variant, x[:1], w, s, torch.tensor([1, 1]), fs[0])
    assert torch.allclose(out[0], alone[0], rtol=0, atol=TOL)
    if variant == "v1":  # all but the moved atom's x, which the remap scales
        keep = torch.ones_like(out[1], dtype=torch.bool)
        keep[0, 0, 0] = False
        assert torch.allclose(out[1][keep], alone[0][keep], rtol=0, atol=1e-8)


def test_probe_main_runs_on_cpu(one_torch_thread):
    res = PA.main(["v0", "v1", "v5"], n_jobs=2, n_steps=20, device="cpu", repeats=1,
                  out=lambda s: None)
    assert set(res) == {"v0", "v1", "v5"}
    for r in res.values():
        assert r["finite"] and r["ms"] > 0 and np.isfinite(r["ke2"]) and r["ke2"] > 0
    assert abs(res["v1"]["ke2"] - res["v5"]["ke2"]) < 1e-3 * res["v1"]["ke2"]
