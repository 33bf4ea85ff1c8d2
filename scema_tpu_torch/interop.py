"""Bring state made by the JAX package (``scema_tpu``) into the port.

Every function takes the JAX package's object — or anything with the same
fields — reads its arrays through ``numpy.asarray`` and returns the port's
counterpart as torch tensors.  This module never imports ``jax``; it is how
tests hand the port what JAX drew at random (``assign_materials``,
``maxwell_velocities``) or prepared (equilibrated microstates, measured
replica ensembles), since torch cannot reproduce ``jax.random`` bits, and
how they hand it a charged system's JAX-made pieces (k-space objects,
Coulomb plane, pattern and SHAKE rows, constraint lists) or an SW brick
structure to hold the port's own against.
"""
from __future__ import annotations

import numpy as np
import torch

from .bridging.bridge import ReplicaEnsemble
from .fem.state import FEState, HistoryState, QPState
from .hmm.md_coupling import MicroStates
from .md.constraints import Constraints
from .md.engine import MDState
from .md.forcefields.coulomb import Ewald
from .md.forcefields.lj import LJ
from .md.forcefields.pme import PME
from .md.forcefields.sw import SW
from .md.material import InitData
from .md.neighbor import NeighborList
from .ops.sw_bricks import SWBricksFF


def _t(x, dtype=None, device=None) -> torch.Tensor:
    a = np.asarray(x)
    if dtype is None:
        return torch.as_tensor(a.copy(), device=device)
    return torch.as_tensor(a.astype(np.float64), dtype=dtype, device=device)


def _i(x, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)


def md_state(st, dtype=torch.float64, device=None) -> MDState:
    """JAX ``engine.MDState`` (pos, vel, h, vxi) -> port MDState."""
    return MDState(pos=_t(st.pos, dtype, device), vel=_t(st.vel, dtype, device),
                   h=_t(st.h, dtype, device), vxi=_t(st.vxi, dtype, device))


def micro_states(m, dtype=torch.float64, device=None) -> MicroStates:
    """JAX ``md_coupling.MicroStates`` -> port MicroStates."""
    return MicroStates(pos=_t(m.pos, dtype, device), vel=_t(m.vel, dtype, device),
                       h=_t(m.h, dtype, device), vxi=_t(m.vxi, dtype, device),
                       has_run=torch.as_tensor(np.asarray(m.has_run).astype(bool),
                                               device=device))


def lj(ff, dtype=torch.float64, device=None) -> LJ:
    """JAX ``forcefields.lj.LJ`` -> the port's, with the same type tables,
    cutoff and atom types (the special-bond weight hook is not carried)."""
    if getattr(ff, "special_weight_fn", None) is not None:
        raise ValueError("interop.lj: an LJ with special_weight_fn has no port counterpart")
    return LJ(epsilon=_t(ff.epsilon, dtype, device), sigma=_t(ff.sigma, dtype, device),
              cutoff=float(ff.cutoff), types=_i(ff.types, device))


def sw(ff) -> SW:
    """JAX ``forcefields.sw.SW`` -> the port's, with the same ten constants."""
    return SW(**{f: float(getattr(ff, f)) for f in SW.__dataclass_fields__})


def sw_bricks(ff, n_atoms: int, device=None) -> SWBricksFF:
    """JAX ``sw_pallas.SWBricksFF`` -> the port's, on the same brick
    structure (slot_ids, nbr, valid) and ``SW`` constants."""
    return SWBricksFF.from_structure(sw(ff.sw), ff.slot_ids, ff.nbr, ff.valid, n_atoms,
                                     device=device)


def replica_ensemble(ens, dtype=torch.float64, device=None) -> ReplicaEnsemble:
    """JAX ``bridge.ReplicaEnsemble`` -> port ReplicaEnsemble."""
    return ReplicaEnsemble(*(_t(getattr(ens, f), dtype, device)
                             for f in ReplicaEnsemble._fields))


def init_data(d) -> InitData:
    """JAX ``material.InitData`` -> port InitData."""
    return InitData(length=np.asarray(d.length, np.float64),
                    stress=np.asarray(d.stress, np.float64),
                    stiff=np.asarray(d.stiff, np.float64), density=float(d.density))


def materials(mat, device=None) -> torch.Tensor:
    """Per-qp material indices (``problem.assign_materials``)."""
    return _i(mat, device)


def qp_state(qp, dtype=torch.float64, device=None) -> QPState:
    f = {k: _t(getattr(qp, k), dtype, device)
         for k in ("new_strain", "old_strain", "upd_strain", "newton_strain",
                   "new_stress", "old_stress", "stiff", "rho", "rotam")}
    return QPState(**f, material=_i(qp.material, device),
                   to_be_updated=torch.as_tensor(np.asarray(qp.to_be_updated).astype(bool),
                                                 device=device))


def history(hist, dtype=torch.float64, device=None) -> HistoryState:
    return HistoryState(buffer=_t(hist.buffer, dtype, device), count=int(hist.count),
                        id_to_get_results_from=_i(hist.id_to_get_results_from, device),
                        most_recent_id=_i(hist.most_recent_id, device))


def fe_state(fe, dtype=torch.float64, device=None) -> FEState:
    """JAX ``fem.state.FEState`` -> port FEState."""
    return FEState(u=_t(fe.u, dtype, device), v=_t(fe.v, dtype, device),
                   inc_u=_t(fe.inc_u, dtype, device), inc_v=_t(fe.inc_v, dtype, device),
                   qp=qp_state(fe.qp, dtype, device), hist=history(fe.hist, dtype, device),
                   timestep=int(fe.timestep), time=float(fe.time))


def dense_planes(jax_runner, n_atoms: int, dtype=torch.float64, device=None):
    """The JAX FusedRunner's dense (NPAD, NPAD) lj1/lj2 planes cropped to
    the port's unpadded (N, N) layout."""
    return tuple(_t(np.asarray(p)[:n_atoms, :n_atoms], dtype, device)
                 for p in (jax_runner.dense_lj1, jax_runner.dense_lj2))


def lane_rows(jax_rows, n_atoms: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """JAX per-atom channel rows (R, NT, 128) — ``pack_topo``,
    ``pack_patterns``, ``pack_shake`` — -> the port's unpadded (R, N)."""
    a = np.asarray(jax_rows)
    return _t(a.reshape(a.shape[0], -1)[:, :n_atoms], dtype, device)


def neighbor_list(nbr, device=None) -> NeighborList:
    """JAX ``neighbor.NeighborList`` (idx, mask; any leading job axes) ->
    the port's (int64 indices)."""
    return NeighborList(idx=_i(nbr.idx, device),
                        mask=torch.as_tensor(np.asarray(nbr.mask).astype(bool), device=device))


def list_channels(ch, n_atoms: int, dtype=torch.float64, device=None) -> dict:
    """JAX gather-list channels (``FusedRunner.channels``: idx, w4e, sig2,
    imx/imy/imz [, qq], each (K, NT, 128)) -> K4's (1, K, N) channels:
    idx as int32, and the LJ pair in LAMMPS's force-coefficient form,
    lj1 = 48 eps sig^12 w = 12 w4e sig2^6 and lj2 = 24 eps sig^6 w =
    6 w4e sig2^3, so both kernels see the same slots."""
    def rows(name):
        a = np.asarray(ch[name])
        return a.reshape(a.shape[0], -1)[:, :n_atoms]

    w4e, sig2 = rows("w4e").astype(np.float64), rows("sig2").astype(np.float64)
    out = {"idx": torch.as_tensor(rows("idx").astype(np.int32), device=device)[None],
           "lj1": _t(12.0 * w4e * sig2 ** 6, dtype, device)[None],
           "lj2": _t(6.0 * w4e * sig2 ** 3, dtype, device)[None]}
    for name in ("imx", "imy", "imz") + (("qq",) if "qq" in ch else ()):
        out[name] = _t(rows(name), dtype, device)[None]
    return out


def dense_qq(jax_runner, n_atoms: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """The JAX FusedRunner's dense (NPAD, NPAD) Coulomb plane cropped to (N, N)."""
    return _t(np.asarray(jax_runner.dense_qq)[:n_atoms, :n_atoms], dtype, device)


def constraints(cons) -> Constraints:
    """JAX ``constraints.Constraints`` -> the port's."""
    return Constraints(idx=np.asarray(cons.idx).astype(np.int64),
                       d0=np.asarray(cons.d0, np.float64),
                       mask=np.asarray(cons.mask).astype(bool))


def kspace(ew, dtype=torch.float64, device=None):
    """JAX ``coulomb.Ewald`` or ``pme.PME`` -> the port's, with the same
    charges, splitting parameter and k-vector set or mesh."""
    if hasattr(ew, "mesh"):
        return PME(charges=_t(ew.charges, dtype, device), cutoff=float(ew.cutoff),
                   alpha=float(ew.alpha), mesh=tuple(int(k) for k in ew.mesh),
                   b2x=_t(ew.b2x, dtype, device), b2y=_t(ew.b2y, dtype, device),
                   b2z=_t(ew.b2z, dtype, device), order=int(ew.order),
                   qqr2e=float(ew.qqr2e))
    return Ewald(charges=_t(ew.charges, dtype, device), cutoff=float(ew.cutoff),
                 alpha=float(ew.alpha), kvecs=_t(ew.kvecs, dtype, device),
                 qqr2e=float(ew.qqr2e))


def slim_inputs_from_jax(state, w4e, sig2, iscal, fscal, dtype=torch.float64, device=None):
    """The kernel lab's ``run_slim`` operands (scripts/probe_allpairs.py:
    state (8, J NT, 128), the (N, N) w4e and sig2 planes, iscal (2,),
    fscal (20,)) -> the port's ``md_slim`` operands for one program:
    state (1, 8, J NT, 128), the planes, iscal (1, 2) int32, fscal (1, 20)."""
    return (_t(state, dtype, device)[None], _t(w4e, dtype, device), _t(sig2, dtype, device),
            torch.as_tensor(np.asarray(iscal).astype(np.int32), device=device)[None],
            _t(fscal, dtype, device)[None])
