"""The port's run surface against the JAX package, on the CPU in float64:
checkpoints, reference-format (lcts.*) restarts, the output writers, the
init.* files and the thermal stiffness probe.

Inputs: a 1x1x2-cell dogbone (16 qps) on the Hooke backend, and the
64-atom diamond-Si SW box (2^3 cells) for the MD-coupled carry and the
probe.  JAX's results come from one module fixture.  Tolerances, each with
its reason:
* a checkpoint of either package restored in the other, then 2 Hooke
  steps: 1e-12 relative (the same float64 state; only the reduction order
  differs between XLA and PyTorch, ~1e-15);
* the port's own save -> restore -> continue: bit for bit (the CPU sums in
  a fixed order), on the Hooke and the MD-coupled carries;
* lcts.* written by one package and read by the other: 1e-12 (the files
  themselves are compared byte for byte); the reference-restart
  continuation: 1e-9, as tests/test_output_checkpoint.py holds JAX;
* output files written from one shared FE state: byte for byte (float64
  on the CPU, the same format strings); the DG projection of a linear
  field: exact to 1e-12;
* init.* files for the same InitData: byte for byte;
* ``measure`` with the thermal stiffness probe on a JAX-made state (the
  port's K5 plain version, the probe's 12 boxes in one sampling call,
  against JAX's XLA engine, one probe at a time): 1e-8 relative on the
  stress and on the pressures' 6x6 difference quotient, as
  tests/test_torch_hmm_sw.py holds this box's stresses (10-step runs, one
  XLA neighbor chunk, so both integrate one force history)."""
import dataclasses
import os
import re
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.config import HMMConfig as JCfg
from scema_tpu.fem import output as JO
from scema_tpu.fem import reference_restart as JR
from scema_tpu.hmm import checkpoint as JC
from scema_tpu.hmm.problem import build_hooke_hmm as j_build_hooke
from scema_tpu.md import homogenization as JH
from scema_tpu.md import material as JM

from scema_tpu_torch import interop
from scema_tpu_torch import native
from scema_tpu_torch.config import HMMConfig as TCfg
from scema_tpu_torch.fem import output as TO
from scema_tpu_torch.fem import reference_restart as TR
from scema_tpu_torch.fem.mesh import build_cuboid
from scema_tpu_torch.hmm import checkpoint as TC
from scema_tpu_torch.hmm.md_coupling import build_md_hmm as t_build_md_hmm
from scema_tpu_torch.hmm.problem import build_hooke_hmm as t_build_hooke
from scema_tpu_torch.md import homogenization as TH
from scema_tpu_torch.md import material as TM

from torch_port_util import np64, one_torch_thread, rel_err  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SW = dict(name="sic", force_field="sw", n_cells=2)


def _small(cls):
    cfg = cls()
    return cfg.replace(
        mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=2),
        time=cfg.time.__class__(timestep_length=5.0e-7, start_timestep=1, end_timestep=10),
        bridging=cfg.bridging.__class__(stress_method=0, approx_md_with_hookes_law=True))


def _leaves(carry) -> list:
    """The port carry's leaves, in the checkpoint's order."""
    return [leaf for leaf, _ in TC._flatten(carry)]


def _equal_leaves(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if torch.is_tensor(x) else (type(x) is type(y) and x == y)
        for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def hooke():
    """3 JAX Hooke steps, the same state in the port, and each package's
    next 2 steps from it."""
    jh = j_build_hooke(_small(JCfg))
    th = t_build_hooke(_small(TCfg), device="cpu")
    step = jax.jit(jh.step)
    js = jh.init_state()
    for _ in range(3):
        js, jo = step(js)
    js5 = js
    for _ in range(2):
        js5, _ = step(js5)
    return dict(jh=jh, th=th, step=step, js=js, js5=js5, jo=jo, ts=interop.fe_state(js))


def test_jax_checkpoint_restores_in_port(hooke, tmp_path):
    p = str(tmp_path / "jax.npz")
    JC.save_checkpoint(p, hooke["js"])
    th = hooke["th"]
    ts = TC.load_checkpoint(p, th.init_state())
    assert ts.timestep == 3 and type(ts.timestep) is int
    assert type(ts.time) is float and type(ts.hist.count) is int
    assert ts.qp.material.dtype == torch.int64 and ts.u.dtype == torch.float64
    for _ in range(2):
        ts, _ = th.step(ts)
    js5 = hooke["js5"]
    assert ts.timestep == int(js5.timestep) == 5
    for t, j in ((ts.u, js5.u), (ts.v, js5.v), (ts.qp.new_stress, js5.qp.new_stress),
                 (ts.qp.new_strain, js5.qp.new_strain), (ts.hist.buffer, js5.hist.buffer)):
        assert rel_err(np64(t), np.asarray(j)) < 1e-12


def test_port_checkpoint_restores_in_jax(hooke, tmp_path):
    p = str(tmp_path / "port.npz")
    TC.save_checkpoint(p, hooke["ts"])
    with np.load(p) as port:
        jleaves = jax.tree_util.tree_leaves(hooke["js"])
        assert len(port.files) == len(jleaves)
        for i, leaf in enumerate(jleaves):  # JAX's layout, leaf by leaf
            assert port[f"leaf_{i}"].dtype == np.asarray(leaf).dtype
            assert port[f"leaf_{i}"].shape == np.asarray(leaf).shape
    js = JC.load_checkpoint(p, hooke["jh"].init_state())
    for _ in range(2):
        js, _ = hooke["step"](js)
    js5 = hooke["js5"]
    assert int(js.timestep) == 5
    for a, b in ((js.u, js5.u), (js.qp.new_stress, js5.qp.new_stress)):
        assert rel_err(np.asarray(a), np.asarray(b)) < 1e-12


def test_hooke_resume_bit_for_bit_and_step_keeps_its_input(hooke, tmp_path):
    th = hooke["th"]
    s = th.init_state()
    for _ in range(3):
        s, _ = th.step(s)
    p = str(tmp_path / "ck.npz")
    TC.save_checkpoint(p, s)
    before = [x.clone() if torch.is_tensor(x) else x for x in _leaves(s)]
    cont = s
    for _ in range(2):
        cont, _ = th.step(cont)
    # the step wrote nothing into its input: the CLI's rollback snapshot
    assert all(torch.equal(x, y) if torch.is_tensor(x) else x == y
               for x, y in zip(before, _leaves(s)))
    rest = TC.load_checkpoint(p, th.init_state())
    assert rest.timestep == 3
    for _ in range(2):
        rest, _ = th.step(rest)
    assert _equal_leaves(cont, rest)


def test_md_coupled_resume_bit_for_bit(tmp_path):
    cfg = _small(TCfg)
    cfg = cfg.replace(
        bridging=cfg.bridging.__class__(stress_method=0, approx_md_with_hookes_law=False),
        md=cfg.md.__class__(temperature=300.0, timestep_length=2.0, strain_rate=1.0e-3,
                            nsteps_sample=10, force_field="sw"),
        md_dtype="float64",
        dirs=dataclasses.replace(cfg.dirs, nanoscale_input=str(tmp_path / "none")))
    h = t_build_md_hmm(cfg, spec=TM.MaterialSpec(**SW), equil_steps=10,
                       minimize_steps=20, device="cpu")
    c = h.init_state()
    for _ in range(2):
        c, _ = h.step(c)
    p = str(tmp_path / "md.npz")
    TC.save_checkpoint(p, c)
    with np.load(p) as f:  # FEState's 21 leaves + MicroStates' 5
        assert len(f.files) == 26 and f["leaf_21"].shape == c[1][0].pos.shape
    before = [x.clone() for x in _leaves(c) if torch.is_tensor(x)]
    cont, out = h.step(c)
    assert int(out.n_jobs) > 0
    assert all(torch.equal(x, y) for x, y in zip(before, [x for x in _leaves(c)
                                                         if torch.is_tensor(x)]))
    rest = TC.load_checkpoint(p, h.init_state())
    rest, _ = h.step(rest)
    assert _equal_leaves(cont, rest)


def test_reference_restart_files_cross_packages(hooke, tmp_path):
    jh, th, js, ts = hooke["jh"], hooke["th"], hooke["js"], hooke["ts"]
    mesh_j, mesh_t = jh.problem.mesh, th.problem.mesh
    jd, td = tmp_path / "jax", tmp_path / "port"
    JR.save_reference_checkpoint(str(jd), js, mesh_j)
    TR.save_reference_checkpoint(str(td), ts, mesh_t)
    for name in ("lcts.solution.bin", "lcts.velocity.bin", "lcts.pr_0.lhistory.bin"):
        assert (jd / name).read_bytes() == (td / name).read_bytes(), name
    # each package reads the other's files into a fresh state
    t_from_j = TR.load_reference_restart(str(jd), th.init_state(), th.geom, mesh_t)
    j_from_t = JR.load_reference_restart(str(td), jh.init_state(), jh.geom, mesh_j)
    assert type(t_from_j.time) is float and t_from_j.time == float(j_from_t.time)
    for f in ("u", "v"):
        assert rel_err(np64(getattr(t_from_j, f)), np.asarray(getattr(j_from_t, f))) < 1e-12
    for f in ("new_strain", "upd_strain", "new_stress", "old_stress"):
        assert rel_err(np64(getattr(t_from_j.qp, f)),
                       np.asarray(getattr(j_from_t.qp, f))) < 1e-12


def test_reference_restart_refuses_multi_rank(hooke, tmp_path):
    th = hooke["th"]
    TR.save_reference_checkpoint(str(tmp_path), hooke["ts"], th.problem.mesh)
    (tmp_path / "lcts.pr_1.lhistory.bin").write_text("")
    with pytest.raises(ValueError, match="multi-rank"):
        TR.load_reference_restart(str(tmp_path), th.init_state(), th.geom, th.problem.mesh)


def test_reference_restart_continuation(tmp_path):
    """The port's mirror of tests/test_output_checkpoint.py's: 10 steps
    against 5, an lcts.* save, a restore into a fresh problem and 5 more."""
    h = t_build_hooke(_small(TCfg), device="cpu")
    s = h.init_state()
    for _ in range(10):
        s, _ = h.step(s)
    sig_full = np64(s.qp.new_stress)
    s = h.init_state()
    for _ in range(5):
        s, _ = h.step(s)
    TR.save_reference_checkpoint(str(tmp_path), s, h.problem.mesh)
    h2 = t_build_hooke(_small(TCfg), device="cpu")
    s2 = TR.load_reference_restart(str(tmp_path), h2.init_state(), h2.geom, h2.problem.mesh)
    s2 = s2.replace(timestep=5)
    for _ in range(5):
        s2, _ = h2.step(s2)
    assert np.abs(np64(s2.qp.new_stress) - sig_full).max() / np.abs(sig_full).max() < 1e-9


def _write_all(mod, outdir, mesh, fe, out, resume=False, resume_ts=None):
    w = mod.OutputWriter(str(outdir), mesh.nodes, mesh.cells, resume=resume,
                         resume_timestep=resume_ts)
    w.write_mesh_eps()
    for ts in (3, 4):
        w.write_visualisation(fe, ts, ts * 5e-7)
        w.write_visualisation_history(fe, ts, ts * 5e-7)
        w.write_lbc_force(ts, ts * 5e-7, float(out.reaction_force) * ts)
        w.write_lhistory(fe, ts)
        n = fe.qp.new_strain.shape[0]
        strain = np.arange(n * 6, dtype=np.float64).reshape(n, 6) * 1e-4
        stress = np.arange(n * 12, dtype=np.float64).reshape(n, 2, 6) * 1e5
        w.write_mddata(ts, [0, 5], np.zeros(n, int), strain, stress, 300.0, 1e-3, "sw")
    return w


def test_output_files_equal_jax(hooke, tmp_path):
    jh, js, ts, jo = hooke["jh"], hooke["js"], hooke["ts"], hooke["jo"]
    mesh = jh.problem.mesh
    jd, td = tmp_path / "jax", tmp_path / "port"
    _write_all(JO, jd, mesh, js, jo)
    _write_all(TO, td, hooke["th"].problem.mesh, ts, jo)
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td))
    assert {"solution-000004.vtu", "history-000004.pvtu", "history.pvd", "3D_mesh.eps",
            "loaded_boundary_force.csv", "lhistory-000003.csv",
            "mddata_qpid5_repl2.csv"} <= set(names)
    for name in names:
        assert (jd / name).read_bytes() == (td / name).read_bytes(), name
    # parsed back: the point data are the state's own values
    root = ET.parse(td / "solution-000003.vtu").getroot()
    disp = next(d for d in root.iter("DataArray") if d.get("Name") == "displacement")
    vals = np.array(disp.text.split(), dtype=float).reshape(-1, 3)
    assert np.abs(vals - np64(ts.u).reshape(-1, 3)).max() <= 1e-9 * np.abs(vals).max()
    # a resumed writer keeps the pre-restart collection and drops CSV rows
    # after the restored step, as JAX's does
    _write_all(JO, jd, mesh, js, jo, resume=True, resume_ts=3)
    _write_all(TO, td, hooke["th"].problem.mesh, ts, jo, resume=True, resume_ts=3)
    for name in ("loaded_boundary_force.csv", "mddata_qpid0_repl1.csv", "solution.pvd"):
        assert (jd / name).read_bytes() == (td / name).read_bytes(), name
    lbc = (td / "loaded_boundary_force.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in lbc[1:]] == ["3", "3", "4"]


def test_history_projection_exact_on_linear_field(hooke):
    th = hooke["th"]
    nodes, cells = th.problem.mesh.nodes, th.problem.mesh.cells
    shp = np64(th.geom.shapes)
    xq = np.einsum("qi,cik->cqk", shp, nodes[cells])

    def lin(p):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        return np.stack([1.0 + 2 * x, 3 * y - z, x + y + z, 0.5 - x + 4 * z, 2 * z, -y],
                        axis=-1)

    nodal = TO.project_history_to_nodes(lin(xq).reshape(-1, 6), len(cells))
    np.testing.assert_allclose(nodal, lin(nodes[cells].reshape(-1, 3)), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(TO.qp_to_dg_projection_matrix(2),
                                  JO.qp_to_dg_projection_matrix(2))


def _read_appended_vtu(path):
    """{array name: float64/int32/uint8 array} of a binary-appended VTU."""
    raw = open(path, "rb").read()
    head, blob = raw.split(b'<AppendedData encoding="raw">\n_', 1)
    kinds = {"Float64": "<f8", "Int32": "<i4", "UInt8": "u1"}
    out = {}
    for m in re.finditer(rb'<DataArray type="(\w+)"(?: Name="(\w+)")? NumberOfComponents='
                         rb'"(\d+)" format="appended" offset="(\d+)"/>', head):
        off = int(m.group(4))
        nbytes = int(np.frombuffer(blob[off:off + 8], "<u8")[0])
        arr = np.frombuffer(blob[off + 8:off + 8 + nbytes], kinds[m.group(1).decode()])
        out[(m.group(2) or b"points").decode()] = arr.reshape(-1, int(m.group(3)))
    return out


def test_writer_takes_the_native_binary_path_at_4096_cells(tmp_path):
    """At >= 4096 cells the writers go through the native library, built
    by the port from native/scema_native.cpp into build/scema_tpu_torch/
    (never the JAX package's native/libscema_native.so); its arrays parse
    back equal to the ASCII writer's inputs."""
    mesh = build_cuboid(1.0, 1.0, 2.0, 16, 16, 16)
    assert native.build().parent == native.BUILD_DIR
    assert "scema_tpu_torch" in str(native.BUILD_DIR)
    n_qp = mesh.n_cells * 8
    rng = np.random.default_rng(4)
    qp = dataclasses.make_dataclass("QP", ["new_strain", "new_stress", "material"])(
        torch.as_tensor(rng.standard_normal((n_qp, 6))),
        torch.as_tensor(rng.standard_normal((n_qp, 6))), torch.zeros(n_qp, dtype=torch.int64))
    fe = dataclasses.make_dataclass("FE", ["u", "v", "qp"])(
        torch.as_tensor(rng.standard_normal(mesh.n_nodes * 3)),
        torch.as_tensor(rng.standard_normal(mesh.n_nodes * 3)), qp)
    w = TO.OutputWriter(str(tmp_path), mesh.nodes, mesh.cells)
    got = _read_appended_vtu(tmp_path / w.write_visualisation(fe, 1, 5e-7))
    np.testing.assert_array_equal(got["points"], mesh.nodes)
    np.testing.assert_array_equal(got["displacement"], np64(fe.u).reshape(-1, 3))
    np.testing.assert_array_equal(got["connectivity"].reshape(-1, 8),
                                  mesh.cells[:, list(TO._BIT_TO_VTK)])
    stress = np64(qp.new_stress).reshape(-1, 8, 6).mean(axis=1)
    np.testing.assert_array_equal(got["stress"], stress)
    hist = _read_appended_vtu(tmp_path / w.write_visualisation_history(fe, 1, 5e-7))
    np.testing.assert_array_equal(
        hist["strain_xx"][:, 0],
        TO.project_history_to_nodes(np64(qp.new_strain), mesh.n_cells)[:, 0])


def test_write_init_files_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    c = rng.standard_normal((6, 6)) * 1e9
    data = dict(length=rng.uniform(10, 20, 3), stress=rng.standard_normal(6) * 1e7,
                stiff=c + c.T, density=1234.5)
    JM.write_init_files(str(tmp_path / "jax"), "g0", 2, JM.InitData(**data))
    TM.write_init_files(str(tmp_path / "port"), "g0", 2, TM.InitData(**data))
    for suffix in (".length", ".stress", ".stiff"):
        name = f"init.g0_2{suffix}"
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name


def test_thermal_measure_matches_jax(monkeypatch):
    """``measure(..., thermal_stiffness=True)``: one sampling run of the box,
    then the thermal probe's twelve boxes in one batched sampling call."""
    params = JH.MDParams(temperature=300.0, dt=2.0, strain_rate=1e-3, nsteps_sample=10)
    jsys, jst = JM.build_system(JM.MaterialSpec(**SW, use_fused=False))
    jst = jst._replace(vel=JM.E.maxwell_velocities(jsys, jax.random.PRNGKey(3), 300.0))
    jd = JM.measure(jsys, jst, params, thermal_stiffness=True)
    tsys, _ = TM.build_system(TM.MaterialSpec(**SW), device="cpu")
    tparams = TH.MDParams(temperature=300.0, dt=2.0, strain_rate=1e-3, nsteps_sample=10)
    sampled = []
    real = TH.E.sample_stress

    def spy(sys_, st, *a, **k):
        sampled.append(tuple(st.pos.shape))
        return real(sys_, st, *a, **k)

    monkeypatch.setattr(TH.E, "sample_stress", spy)
    td = TM.measure(tsys, interop.md_state(jst), tparams, thermal_stiffness=True)
    assert sampled == [(64, 3), (12, 64, 3)]  # the box, then the 12 probes at once
    assert rel_err(td.stiff, jd.stiff) < 1e-8
    assert np.abs(jd.stiff).max() > 1e9  # a stiffness, not noise
    assert rel_err(td.stress, jd.stress) < 1e-8
    assert rel_err(td.length, jd.length) < 1e-12 and abs(td.density / jd.density - 1) < 1e-12
