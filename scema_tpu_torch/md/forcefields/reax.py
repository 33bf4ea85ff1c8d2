"""ReaxFF reactive force field (``pair_style reax/c`` + ``fix qeq/reax``).

Torch twin of ``scema_tpu/md/forcefields/reax.py``: the capability the
reference gets from LAMMPS's USER-REAXC package
(lammps_scripts_reax/in.set.lammps:13-15: ``pair_style reax/c`` with
ffield.reax.2 over H/C/N/O and ``fix qeq/reax 1 0.0 10.0 1e-6``).  The same
three departures from the C implementation as the JAX version:

* **Bond-order fields.**  :class:`ReaxFFDense` keeps every pair quantity in
  dense (N, N) matrices; :class:`ReaxFFList` keeps them on the engine's
  fixed-width neighbor list (N, K).  Valence, torsion and hydrogen-bond
  terms enumerate a top-``top_k`` bonded sub-list gathered from the field
  each call (reactivity = the gather changes).
* **Autograd forces.**  Forces and the virial are autograd of the energy.
* **Variational QEq.**  Charges minimise the taper-shielded EEM energy
  under neutrality: a batched Cholesky solve on the dense field, a
  Jacobi-preconditioned CG of fixed trip count on the list (warm-started
  from a previous solve's vectors by the engine's chunk loops).  Charges
  are detached, so the position gradient stays the exact force
  (Hellmann-Feynman).

Both fields are batched: positions (B, N, 3) in boxes (B, 3, 3) give
energies (B,), as ``SW.energy`` and ``OPLS.energy`` do; every sum over
atoms (energies, the neutrality shift, CG's inner products) stays within
its job.  Any leading batch shape is accepted and folded into one job
axis.  The zero-safe forms of the JAX version are kept exactly
(``_spow``'s max-then-log, the eye trick before ``sqrt``, ``arccos`` of a
shrunk cosine, the 1e-12 torsion sqrt guards and the MIN_SINE gates on the
true sines): a ``torch.where`` around an unguarded log, pow, sqrt or acos
turns the untaken branch's inf into NaN gradients.  The top-K gathers take
a stable descending sort, so that ties fall in ``lax.top_k``'s order
(lower index first).

There is no kernel here: the JAX package computes ReaxFF as XLA array code
with ``jax.grad``, and the port as plain torch with autograd.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import neighbor as NB
from .reax_ffield import ReaxParams, parse_ffield

__all__ = ["ReaxFFDense", "ReaxFFList", "ReaxParams", "build_reax", "parse_ffield"]

C_ELE = 332.06371  # Coulomb constant, kcal/mol * A / e^2 (reax/c value)
EV2KCAL = 23.02  # eV -> kcal/mol (reax/c's KCALpMOL_to_EV inverse)
THB_CUT = 0.001  # three/four-body bond-order gate (reax/c control default)
HB_CUT = 7.5  # hydrogen-bond distance cutoff (reax/c control default)
MIN_SINE = 1e-10
KC_EV = C_ELE / EV2KCAL  # 14.42... eV A / e^2

# the energy terms, in the order of their sum
TERMS = ("e_bond", "e_lp", "e_ov", "e_un", "e_ang", "e_pen", "e_coa", "e_tor", "e_con",
         "e_hb", "e_vdw", "e_coul", "e_pol")


def _spow(x, p):
    """x**p for x >= 0 with a zero-safe gradient (0**p := 0)."""
    xs = torch.clamp(x, min=1e-12)
    return torch.where(x > 1e-12, torch.exp(p * torch.log(xs)), 0.0)


def _taper(r, swb: float):
    """Tap7 polynomial: 1 at r=0 -> 0 at swb with three zero derivatives
    (reax/c Init_Taper with swa=0)."""
    x = torch.clamp(r / swb, 0.0, 1.0)
    x4 = x * x * x * x
    return 1.0 + x4 * (-35.0 + x * (84.0 + x * (-70.0 + x * 20.0)))


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-job row gather: x (B, N, ...) at atom indices idx (B, ...) ->
    (B, ...idx, ...x) — ``x[idx]`` of the JAX version, job by job."""
    Bn, n = x.shape[:2]
    rest = x.shape[2:]
    flat = idx.reshape(Bn, -1)
    if rest:
        xf = x.reshape(Bn, n, -1)
        g = torch.gather(xf, 1, flat[..., None].expand(-1, -1, xf.shape[-1]))
    else:
        g = torch.gather(x, 1, flat)
    return g.reshape(tuple(idx.shape) + tuple(rest))


def _jsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over everything but the job axis -> (B,)."""
    return x.reshape(x.shape[0], -1).sum(-1)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: the k largest, descending, ties
    in index order (a stable descending sort, sliced)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _flat(pos: torch.Tensor, h: torch.Tensor):
    """pos (..., N, 3), h (..., 3, 3) -> (B, N, 3), (B, 3, 3), the leading
    shape."""
    lead = pos.shape[:-2]
    n = pos.shape[-2]
    pf = pos.reshape(-1, n, 3)
    hf = h.expand(tuple(lead) + (3, 3)).reshape(-1, 3, 3)
    return pf, hf, lead


def _unflat(terms: dict, lead) -> dict:
    return {k: v.reshape(tuple(lead) + tuple(v.shape[1:])) for k, v in terms.items()}


class _Common:
    """What both fields share: the lone-pair count, the bond-order
    corrections over a pair axis, and the energy terms of a bonded
    sub-list (valence, penalty, conjugation, torsion, four-body)."""

    tables: dict
    types: torch.Tensor

    def _corrected(self, bo_p, bopi_p, bopp_p, listed, gather, tl):
        """Corrected bond orders + coordination deltas (reax/c BO()) from
        the uncorrected ones on a pair axis: ``gather(v)`` brings per-atom
        v (B, N) to the partner of each pair entry, ``tl`` indexes a
        per-pair-type table; axis -1 sums give the per-atom totals (each
        pair appears in both rows)."""
        T = self.tables
        t = self.types
        bo_cut = T["bo_cut"]
        val = T["valency"][t]
        deltap = torch.sum(bo_p, -1) - val
        deltap_boc = torch.sum(bo_p, -1) - T["valency_boc"][t]

        # f1 (overcoordination, per-bond ovc switch)
        p1, p2 = T["p_boc1"], T["p_boc2"]
        e1 = torch.exp(-p1 * deltap)
        e2 = torch.exp(-p2 * deltap)
        f2 = e1[..., None] + gather(e1)
        f3 = -torch.log(0.5 * (e2[..., None] + gather(e2))) / p2
        vi, vj = val[:, None], gather(val)
        f1 = 0.5 * ((vi + f2) / (vi + f2 + f3) + (vj + f2) / (vj + f2 + f3))
        f1 = torch.where(tl(T["ovc"]) >= 0.001, f1, 1.0)

        # f4/f5 (1-3 correction, per-bond v13cor switch)
        def pair_mean(name):
            a = T[name][t]
            return torch.sqrt(a[:, None] * gather(a))

        boc3, boc4, boc5 = pair_mean("p_boc3"), pair_mean("p_boc4"), pair_mean("p_boc5")
        bo_p2 = bo_p * bo_p

        def f45(dpb):
            return 1.0 / (1.0 + torch.exp(-boc3 * (boc4 * bo_p2 - dpb) + boc5))

        f45v = torch.where(tl(T["v13cor"]) >= 0.001,
                           f45(deltap_boc[..., None]) * f45(gather(deltap_boc)), 1.0)

        A0 = f1 * f45v
        bo = torch.clamp(bo_p * A0 - bo_cut, min=0.0)
        bo = torch.where(listed, bo, 0.0)
        bopi = bopi_p * f1 * A0
        bopp = bopp_p * f1 * A0
        bos = torch.clamp(bo - bopi - bopp, min=0.0)

        total = torch.sum(bo, -1)
        return dict(bo=bo, bos=bos, bopi=bopi, bopp=bopp, listed=listed, total=total,
                    delta=total - val, delta_e=total - T["valency_e"][t],
                    delta_val=total - T["valency_val"][t],
                    delta_boc=total - T["valency_boc"][t])

    def _uncorrected(self, r, ok_mask, tl):
        """The uncorrected sigma/pi/pi-pi bond orders of a pair axis."""
        T = self.tables
        bo_cut = T["bo_cut"]
        r_safe = torch.where(ok_mask, r, 1.0)

        def bo_prime(r0_tab, pbo_a, pbo_b):
            r0 = tl(r0_tab)
            ok = ok_mask & (r0 > 0)
            ratio = r_safe / torch.where(r0 > 0, r0, 1.0)
            return torch.where(ok, torch.exp(tl(pbo_a) * _spow(ratio, tl(pbo_b))), 0.0)

        bos_p = (1.0 + bo_cut) * bo_prime(T["r_s_ij"], T["p_bo1"], T["p_bo2"])
        bopi_p = bo_prime(T["r_pi_ij"], T["p_bo3"], T["p_bo4"])
        bopp_p = bo_prime(T["r_pipi_ij"], T["p_bo5"], T["p_bo6"])
        bo_p = bos_p + bopi_p + bopp_p
        listed = ok_mask & (bo_p >= bo_cut)
        return (torch.where(listed, bo_p, 0.0), torch.where(listed, bopi_p, 0.0),
                torch.where(listed, bopp_p, 0.0), listed)

    def _lone_pair(self, B):
        """nlp / Delta_lp per atom (reax/c Atom_Energy lone-pair part)."""
        T = self.tables
        t = self.types
        vlpex = B["delta_e"]
        half_trunc = torch.trunc(vlpex / 2.0)
        explp1 = torch.exp(-T["p_lp1"] * torch.square(2.0 + vlpex - 2.0 * half_trunc))
        nlp = explp1 - half_trunc
        nlp_opt = 0.5 * (T["valency_e"][t] - T["valency"][t])
        delta_lp = nlp_opt - nlp
        # heavy atoms (mass > 21) do not use the lone-pair correction in
        # over/under-coordination (reax/c dfvl switch)
        light = T["mass"][t] <= 21.0
        delta_lp_temp = torch.where(light, delta_lp, nlp_opt - nlp_opt)
        e_lp = torch.sum(T["p_lp2"][t] * delta_lp / (1.0 + torch.exp(-75.0 * delta_lp)), -1)
        return nlp, delta_lp, delta_lp_temp, vlpex, e_lp

    def _bond_and_coordination(self, B, tl, gather):
        """Bond energy, lone pair, over/under-coordination (reax/c Bonds,
        Atom_Energy) -> dict of (B,) energies."""
        T = self.tables
        t = self.types
        ebond_ij = (-tl(T["De_s"]) * B["bos"]
                    * torch.exp(tl(T["p_be1"]) * (1.0 - _spow(B["bos"], tl(T["p_be2"]))))
                    - tl(T["De_pi"]) * B["bopi"] - tl(T["De_pipi"]) * B["bopp"])
        e_bond = 0.5 * _jsum(torch.where(B["listed"], ebond_ij, 0.0))

        nlp, delta_lp, delta_lp_temp, vlpex, e_lp = self._lone_pair(B)
        sum_ovun1 = torch.sum(tl(T["p_ovun1"]) * tl(T["De_s"]) * B["bo"], -1)
        sum_ovun2 = torch.sum(gather(B["delta"] - delta_lp_temp) * (B["bopi"] + B["bopp"]), -1)
        exp_ov1 = T["p_ovun3"] * torch.exp(T["p_ovun4"] * sum_ovun2)
        delta_lpcorr = B["delta"] - delta_lp_temp / (1.0 + exp_ov1)
        p_ovun2 = T["p_ovun2"][t]
        e_ov = torch.sum(sum_ovun1 * delta_lpcorr / (delta_lpcorr + T["valency"][t] + 1e-8)
                         / (1.0 + torch.exp(p_ovun2 * delta_lpcorr)), -1)
        e_un = torch.sum(-T["p_ovun5"][t] * (1.0 - torch.exp(T["p_ovun6"] * delta_lpcorr))
                         / (1.0 + torch.exp(-p_ovun2 * delta_lpcorr))
                         / (1.0 + T["p_ovun7"] * torch.exp(T["p_ovun8"] * sum_ovun2)), -1)
        return dict(e_bond=e_bond, e_lp=e_lp, e_ov=e_ov, e_un=e_un), nlp, vlpex

    def _many_body(self, B, nlp, vlpex, bo_k, nb_mask, idx_b, Gk, rk, bopi_jk):
        """Valence angles, penalty, three-body conjugation, torsions and
        four-body conjugation over the bonded sub-list (reax/c
        Valence_Angles, Torsion_Angles): bo_k, nb_mask, idx_b (B, N, K)
        the sub-list's bond orders, gate and global atom ids, Gk (B, N, K,
        3) and rk (B, N, K) its min-image vectors r_k - r_j and lengths,
        bopi_jk (B, N, K) its pi bond orders."""
        T = self.tables
        t = self.types
        n = t.shape[0]
        dev = t.device
        tk = t[idx_b]
        totk = _rows(B["total"], idx_b)

        # --- valence angles i-j-k, j central; SBO from all bonds ---
        bo_m = torch.where(B["listed"], B["bo"], 0.0)
        sbo_p = torch.sum(B["bopi"] + B["bopp"], -1)
        prod_sbo = torch.exp(-torch.sum(_spow(bo_m, 8.0), -1))
        vlpadj = torch.where(vlpex >= 0.0, 0.0, nlp)
        sbo = sbo_p + (1.0 - prod_sbo) * (-B["delta_val"] - T["p_val8"] * vlpadj)
        pv9 = T["p_val9"]
        sbo2 = torch.where(
            sbo <= 0.0, 0.0,
            torch.where(sbo <= 1.0, _spow(sbo, pv9),
                        torch.where(sbo < 2.0,
                                    2.0 - _spow(torch.clamp(2.0 - sbo, min=0.0), pv9),
                                    2.0)))

        ta = tk[..., :, None]  # i type  (B, N, K, 1)
        tb = tk[..., None, :]  # k type  (B, N, 1, K)
        tj3 = t[:, None, None]
        ang_ok = (T["ang_mask"][ta, tj3, tb]
                  & nb_mask[..., :, None] & nb_mask[..., None, :]
                  & (idx_b[..., :, None] != idx_b[..., None, :]))
        e1 = Gk[..., :, None, :]  # r_i - r_j
        e2 = Gk[..., None, :, :]  # r_k - r_j
        r1 = rk[..., :, None]
        r2 = rk[..., None, :]
        cos_t = torch.sum(e1 * e2, -1) / torch.clamp(r1 * r2, min=1e-12)
        cos_t = torch.clamp(cos_t, -1.0, 1.0)
        theta = torch.arccos(cos_t * (1.0 - 1e-7))  # grad-safe at +-1
        th00 = T["theta00"][ta, tj3, tb] * (math.pi / 180.0)
        theta0 = math.pi - th00 * (1.0 - torch.exp(-T["p_val10"]
                                                   * (2.0 - sbo2[..., None, None])))
        bo_ij = bo_k[..., :, None]
        bo_jk = bo_k[..., None, :]
        p_val4 = T["p_val4"][ta, tj3, tb]
        p_val3j = T["p_val3"][t][:, None, None]
        f7_ij = 1.0 - torch.exp(-p_val3j * _spow(bo_ij, p_val4))
        f7_jk = 1.0 - torch.exp(-p_val3j * _spow(bo_jk, p_val4))
        dvj = B["delta_val"][..., None, None]
        exp6 = torch.exp(T["p_val6"] * dvj)
        exp7 = torch.exp(-T["p_val7"][ta, tj3, tb] * dvj)
        p_val5j = T["p_val5"][t][:, None, None]
        f8 = p_val5j - (p_val5j - 1.0) * (2.0 + exp6) / (1.0 + exp6 + exp7)
        pv1 = T["p_val1"][ta, tj3, tb]
        expv2 = torch.exp(-T["p_val2"][ta, tj3, tb] * torch.square(theta0 - theta))
        ev12 = torch.where(pv1 >= 0.0, pv1 * (1.0 - expv2), -pv1 * expv2)
        e_ang = 0.5 * _jsum(torch.where(ang_ok, f7_ij * f7_jk * f8 * ev12, 0.0))

        # penalty (reax/c: allene-type centres)
        dj = B["delta"][..., None, None]
        f9 = ((2.0 + torch.exp(-T["p_pen3"] * dj))
              / (1.0 + torch.exp(-T["p_pen3"] * dj) + torch.exp(T["p_pen4"] * dj)))
        e_pen_t = (T["p_pen1"][ta, tj3, tb] * f9
                   * torch.exp(-T["p_pen2"] * torch.square(bo_ij - 2.0))
                   * torch.exp(-T["p_pen2"] * torch.square(bo_jk - 2.0)))
        e_pen = 0.5 * _jsum(torch.where(ang_ok, e_pen_t, 0.0))

        # three-body conjugation
        tot_i = totk[..., :, None]
        tot_k = totk[..., None, :]
        e_coa_t = (T["p_coa1"][ta, tj3, tb]
                   / (1.0 + torch.exp(T["p_coa2"] * dvj))
                   * torch.exp(-T["p_coa3"] * torch.square(tot_i - bo_ij))
                   * torch.exp(-T["p_coa3"] * torch.square(tot_k - bo_jk))
                   * torch.exp(-T["p_coa4"] * torch.square(bo_ij - 1.5))
                   * torch.exp(-T["p_coa4"] * torch.square(bo_jk - 1.5)))
        e_coa = 0.5 * _jsum(torch.where(ang_ok, e_coa_t, 0.0))

        # --- torsions i-j-k-l over central bonds j-k, k > j; axes (B, j,
        # a = central partner k, c = i of j, d = l of k) ---
        idx_k = _rows(idx_b, idx_b)  # (B, N, K, K): neighbors of neighbor a
        kk = idx_b[..., :, None, None]
        ii = idx_b[..., None, :, None]
        ll = idx_k[..., :, None, :]
        ti4 = t[ii]
        tj4 = t[:, None, None, None]
        tk4 = t[kk]
        tl4 = t[ll]
        ar = torch.arange(n, device=dev)
        central_ok = nb_mask & (idx_b > ar[:, None])
        bo_c = bo_k[..., :, None, None]
        bo_i = bo_k[..., None, :, None]  # BO(j, i)
        bo_l = _rows(bo_k, idx_b)[..., :, None, :]  # BO(k, l)
        tor_ok = (T["tor_mask"][ti4, tj4, tk4, tl4]
                  & central_ok[..., None, None]
                  & nb_mask[..., None, :, None]
                  & (bo_l > THB_CUT)
                  & (ii != kk) & (ll != ar[:, None, None, None])
                  & (ll != ii)
                  & (bo_c * bo_i * bo_l > THB_CUT))
        b1 = -Gk[..., None, :, None, :]  # r_j - r_i
        b2 = Gk[..., :, None, None, :]  # r_k - r_j
        # r_l - r_k: the min-image vector from k to its c-th neighbor l
        b3 = _rows(Gk, idx_b)[..., :, None, :, :]
        n1 = torch.linalg.cross(b1, b2, dim=-1)
        n2 = torch.linalg.cross(b2, b3, dim=-1)
        s1 = torch.sum(n1 * n1, -1)
        s2 = torch.sum(n2 * n2, -1)
        # the 1e-12 sqrt guards (not 1e-20) keep every denominator square
        # of a degenerate quadruple in normal float32 range: the where-mask
        # does not protect the backward pass (reax.py:367-375)
        n1n = torch.sqrt(s1 + 1e-12)
        n2n = torch.sqrt(s2 + 1e-12)
        cos_w = torch.clamp(torch.sum(n1 * n2, -1) / (n1n * n2n), -1.0, 1.0)
        b1n = torch.sqrt(torch.sum(b1 * b1, -1) + 1e-12)
        b2n = torch.sqrt(torch.sum(b2 * b2, -1) + 1e-12)
        b3n = torch.sqrt(torch.sum(b3 * b3, -1) + 1e-12)
        sin_ijk = n1n / (b1n * b2n)
        sin_jkl = n2n / (b2n * b3n)
        # MIN_SINE on the true (unguarded) sines
        tor_ok = (tor_ok
                  & (s1 > torch.square(MIN_SINE * b1n * b2n))
                  & (s2 > torch.square(MIN_SINE * b2n * b3n)))

        def exp_t2(bo_):
            return 1.0 - torch.exp(-T["p_tor2"] * bo_)

        f10 = exp_t2(bo_i) * exp_t2(bo_c) * exp_t2(bo_l)
        # f11 uses the angle-valency delta (reax/c's Delta_boc)
        d_jk = (B["delta_val"][..., None] + _rows(B["delta_val"], idx_b))[..., None, None]
        et3 = torch.exp(-T["p_tor3"] * d_jk)
        et4 = torch.exp(T["p_tor4"] * d_jk)
        f11 = (2.0 + et3) / (1.0 + et3 + et4)
        exp_tor1 = torch.exp(T["p_tor1"][ti4, tj4, tk4, tl4]
                             * torch.square(2.0 - bopi_jk[..., None, None] - f11))
        cos2w = 2.0 * cos_w * cos_w - 1.0
        cos3w = cos_w * (2.0 * cos2w - 1.0)
        V1 = T["V1"][ti4, tj4, tk4, tl4]
        V2 = T["V2"][ti4, tj4, tk4, tl4]
        V3 = T["V3"][ti4, tj4, tk4, tl4]
        e_tor_t = 0.5 * f10 * sin_ijk * sin_jkl * (
            V1 * (1.0 + cos_w) + V2 * exp_tor1 * (1.0 - cos2w) + V3 * (1.0 + cos3w))
        e_tor = _jsum(torch.where(tor_ok, e_tor_t, 0.0))

        # four-body conjugation
        f12 = (torch.exp(-T["p_cot2"] * torch.square(bo_i - 1.5))
               * torch.exp(-T["p_cot2"] * torch.square(bo_c - 1.5))
               * torch.exp(-T["p_cot2"] * torch.square(bo_l - 1.5)))
        e_con_t = (T["p_cot1"][ti4, tj4, tk4, tl4] * f12
                   * (1.0 + (cos_w * cos_w - 1.0) * sin_ijk * sin_jkl))
        e_con = _jsum(torch.where(tor_ok, e_con_t, 0.0))
        return dict(e_ang=e_ang, e_pen=e_pen, e_coa=e_coa, e_tor=e_tor, e_con=e_con)

    def _hbond(self, tk, bo_k, nb_mask, Gk, rk, rz, ez, tz, acc_ok):
        """Hydrogen bonds donor(i)-H(j)...acceptor(z) over (B, N, K, Z):
        H j, donor i in its bonded sub-list slot a, acceptor z on the
        pair axis; rz, ez, tz (B, N, 1, Z) the acceptor distances, vectors
        r_z - r_j and types, acc_ok (B, N, K, Z) the per-atom acceptor
        flag, geometry and distinctness gates."""
        T = self.tables
        t = self.types
        tj3 = t[:, None, None]
        # donor i = any bonded neighbor of the H atom j; which donor/H/
        # acceptor type triples exist is hb_mask's job
        don_ok = (T["p_hbond"][t] == 1.0)[:, None] & nb_mask
        ti = tk[..., :, None]
        hb_par = T["hb_mask"][ti, tj3, tz] & don_ok[..., None] & acc_ok
        # angle i-j-z at the hydrogen
        cos_x = torch.sum(Gk[..., :, None, :] * ez, -1) / torch.clamp(rk[..., None] * rz,
                                                                      min=1e-12)
        # sin^4(theta/2) = ((1 - cos)/2)^2: sqrt-free, NaN-safe grads
        sin_x4 = torch.square(0.5 * (1.0 - torch.clamp(cos_x, -1.0, 1.0)))
        r0 = T["r0_hb"][ti, tj3, tz]
        r0 = torch.where(r0 > 0, r0, 1.0)
        ehb_t = (T["p_hb1"][ti, tj3, tz]
                 * (1.0 - torch.exp(-T["p_hb2"][ti, tj3, tz] * bo_k[..., None]))
                 * torch.exp(-T["p_hb3"][ti, tj3, tz]
                             * (r0 / torch.clamp(rz, min=1e-6) + rz / r0 - 2.0))
                 * sin_x4)
        return _jsum(torch.where(hb_par, ehb_t, 0.0))

    def _nonbonded(self, r, within, tl):
        """Taper + shielded Morse vdW -> (e_vdw (B,), the Coulomb shielding
        of each pair entry)."""
        T = self.tables
        swb = self.cutoff
        tap = torch.where(within, _taper(r, swb), 0.0)
        pv = T["p_vdw1"]
        gw = tl(T["gamma_w_ij"])
        fn13 = _spow(_spow(r, pv) + _spow(1.0 / gw, pv), 1.0 / pv)
        rvdw = tl(T["r_vdw_ij"])
        al = tl(T["alpha_ij"])
        ex1 = torch.exp(al * (1.0 - fn13 / rvdw))
        ex2 = torch.exp(0.5 * al * (1.0 - fn13 / rvdw))
        e_vdw = 0.5 * _jsum(tap * tl(T["D_ij"]) * (ex1 - 2.0 * ex2))
        gam3 = _spow(tl(T["gamma_ij"]), -3.0)
        r3g = _spow(r * r * r + gam3, 1.0 / 3.0)
        return e_vdw, torch.where(within, tap / r3g, 0.0)

    def _polarization(self, q):
        T = self.tables
        t = self.types
        return EV2KCAL * torch.sum(T["chi"][t] * q + T["eta"][t] * q * q, -1)


@dataclasses.dataclass(frozen=True, eq=False)
class ReaxFFDense(_Common):
    """Dense-field ReaxFF energy for one fixed composition.

    ``tables`` is a dict of tensors and floats derived from
    :class:`ReaxParams` (per-type, per-pair, per-angle, per-torsion);
    ``types`` the (N,) simulation type ids.  ``energy(pos, h, nbr)``
    ignores ``nbr``: the interaction structure is recomputed from the
    dense field each call."""

    tables: dict
    types: torch.Tensor  # (N,) int64
    cutoff: float  # nonbonded taper radius (swb)
    qeq: bool = True
    # does this composition admit hydrogen bonds at all?
    with_hbond: bool = False

    # engine.MDSystem.build_neighbors: no neighbor structure needed
    slot_ids = ()

    # FIRE minimization step for material.equilibrate: ReaxFF bond-order
    # forces are far stiffer than LJ/SW — the generic 0.5 fs dt0 diverges
    # to NaN on an unrelaxed melt (reax.py:88-91); 0.05 fs is stable
    fire_dt0 = 0.05

    def _pair_geometry(self, pos, h):
        """Min-image displacement G[b, i, j] = r_j - r_i (B, N, N, 3), the
        distance (0 on the diagonal) and the off-diagonal mask (N, N)."""
        n = pos.shape[-2]
        s = pos @ torch.linalg.inv(h)
        ds = s[:, None, :, :] - s[:, :, None, :]
        ds = ds - torch.round(ds)
        G = ds @ h[:, None]
        r2 = torch.sum(G * G, -1)
        eye = torch.eye(n, dtype=torch.bool, device=pos.device)
        r = torch.sqrt(torch.where(eye, 1.0, r2))
        return G, torch.where(eye, 0.0, r), ~eye

    def _tl(self):
        t = self.types
        ti, tj = t[:, None], t[None, :]
        return lambda tab: tab[ti, tj]

    @staticmethod
    def _gather(v):
        """Per-atom v (B, N) at every column partner j: (B, 1, N)."""
        return v[..., None, :]

    def _bond_orders(self, r, offdiag):
        """Corrected bond orders + coordination deltas (reax/c BO())."""
        tl = self._tl()
        bo_p, bopi_p, bopp_p, listed = self._uncorrected(r, offdiag, tl)
        return self._corrected(bo_p, bopi_p, bopp_p, listed, self._gather, tl)

    def bond_orders(self, pos, h):
        """The corrected bond-order matrices (..., N, N) plus per-atom
        totals — what ``fix reax/c/bonds`` prints in LAMMPS."""
        pf, hf, lead = _flat(pos, h)
        _, r, offdiag = self._pair_geometry(pf, hf)
        B = self._bond_orders(r, offdiag)
        return _unflat({"bo": B["bo"], "sigma": B["bos"], "pi": B["bopi"], "pipi": B["bopp"],
                        "total": B["total"]}, lead)

    def energy(self, pos, h, nbr=None):
        return self.energy_terms(pos, h)["total"]

    def energy_terms(self, pos, h, nbr=None):
        """All ReaxFF energy contributions (kcal/mol, per job), keyed like
        the reference's ``compute reax`` columns (in.strain.lammps:16-21),
        and the charges ``q`` (..., N).  ``nbr`` is ignored (the engine
        hands None: the dense field has no list)."""
        pf, hf, lead = _flat(pos, h)
        T = self.tables
        t = self.types
        n = pf.shape[1]
        G, r, offdiag = self._pair_geometry(pf, hf)
        B = self._bond_orders(r, offdiag)
        tl = self._tl()
        out, nlp, vlpex = self._bond_and_coordination(B, tl, self._gather)

        # --- bonded-neighbor gather (top-K by corrected BO) ---
        K = min(int(T["top_k"]), n)
        bo_k, idx = _top_k(torch.where(B["listed"], B["bo"], -1.0), K)  # (B, N, K)
        nb_mask = bo_k > THB_CUT
        Gk = torch.gather(G, 2, idx[..., None].expand(-1, -1, -1, 3))
        rk = torch.gather(r, 2, idx)
        bopi_jk = torch.gather(B["bopi"], 2, idx)
        out.update(self._many_body(B, nlp, vlpex, bo_k, nb_mask, idx, Gk, rk, bopi_jk))

        # --- hydrogen bonds: acceptors z over the dense axis ---
        if self.with_hbond:
            is_acc = T["p_hbond"][t] == 2.0
            rz = r[:, :, None, :]  # r(j, z)
            acc_ok = ((rz < HB_CUT) & offdiag[:, None, :]
                      & is_acc[None, None, :]
                      & (torch.arange(n, device=pf.device)[None, None, :] != idx[..., None]))
            out["e_hb"] = self._hbond(t[idx], bo_k, nb_mask, Gk, rk, rz, G[:, :, None, :, :],
                                      t[None, None, :], acc_ok)
        else:
            out["e_hb"] = torch.zeros(pf.shape[0], dtype=pf.dtype, device=pf.device)

        # --- nonbonded: taper + shielded Morse vdW, shielded Coulomb ---
        within = offdiag & (r < self.cutoff)
        out["e_vdw"], shield = self._nonbonded(r, within, tl)
        q = self._solve_qeq(shield) if self.qeq else torch.zeros_like(pf[..., 0])
        out["e_coul"] = 0.5 * C_ELE * _jsum(shield * q[:, :, None] * q[:, None, :])
        out["e_pol"] = self._polarization(q)
        out["total"] = sum(out[k] for k in TERMS)
        out["q"] = q
        return _unflat(out, lead)

    def _solve_qeq(self, shield):
        """Neutrality-constrained EEM charges (fix qeq/reax 1 0.0 10.0),
        per job: minimise E(q) = sum chi q + eta q^2 (eV) + 14.40 sum_ij K
        q q under sum q = 0 by two Cholesky solves of the SPD matrix A =
        diag(2 eta) + 14.40 K: q = s - (sum s / sum t) t with A s = -chi,
        A t = 1 (reax.py:496-517).  Detached: the charges are stationary
        (Hellmann-Feynman)."""
        T = self.tables
        t = self.types
        with torch.no_grad():
            A = KC_EV * shield.detach() + torch.diag(2.0 * T["eta"][t])
            rhs = torch.stack([-T["chi"][t], torch.ones_like(T["chi"][t])], 1)
            L = torch.linalg.cholesky(A)
            st = torch.cholesky_solve(rhs.expand(A.shape[0], -1, -1), L)
            s, tv = st[..., 0], st[..., 1]
            return s - (torch.sum(s, -1) / torch.sum(tv, -1))[:, None] * tv


@dataclasses.dataclass(frozen=True, eq=False)
class ReaxFFList(_Common):
    """Neighbor-list ReaxFF: the production variant of
    :class:`ReaxFFDense` (reax.py:519-1007).

    Same functional forms and tables, but every pair quantity lives on the
    engine's fixed-width neighbor list (idx, mask (B, N, K), each pair in
    both rows) and QEq is a Jacobi-preconditioned CG with the list matvec,
    O(N K) throughout.  Valence, torsion and hydrogen-bond terms enumerate
    a top-``top_k`` bonded sub-list gathered from the slot field."""

    tables: dict
    types: torch.Tensor  # (N,) int64
    cutoff: float  # nonbonded taper radius (swb)
    qeq: bool = True
    with_hbond: bool = False
    qeq_iters: int = 48  # CG trip count of a cold solve (f32 floors ~1e-6 rel)
    # fix qeq/reax warm-starts its CG from the previous step's charges; the
    # engine's chunk loops do the same when qeq_warm is on
    # (engine.run_strain / sample_stress): one cold qeq_iters solve per
    # neighbor-rebuild chunk, then qeq_iters_warm-trip solves seeded by the
    # previous step's CG vectors
    qeq_warm: bool = True
    qeq_iters_warm: int = 12

    fire_dt0 = 0.05  # see ReaxFFDense.fire_dt0

    def _pair_geometry(self, pos, h, idx, mask):
        """Per-slot min-image displacement G[b, i, k] = r_idx[i,k] - r_i."""
        s = pos @ torch.linalg.inv(h)
        ds = _rows(s, idx) - s[:, :, None, :]
        ds = ds - torch.round(ds)
        G = ds @ h[:, None]
        r2 = torch.sum(G * G, -1)
        r = torch.sqrt(torch.where(mask, r2, 1.0))
        return G, torch.where(mask, r, 0.0)

    def _tl(self, idx):
        t = self.types
        ti, tj = t[:, None], t[idx]
        return lambda tab: tab[ti, tj]

    def _bond_orders(self, r, idx, mask):
        """Corrected bond orders on the slot field (axis -1 sums are the
        per-atom totals: each pair appears in both rows)."""
        tl = self._tl(idx)
        bo_p, bopi_p, bopp_p, listed = self._uncorrected(r, mask, tl)
        return self._corrected(bo_p, bopi_p, bopp_p, listed, lambda v: _gather_slots(v, idx),
                               tl)

    def _default_nbr(self, n: int) -> NB.NeighborList:
        """All-pairs (N, N-1) list for direct calls without an engine list:
        every j != i, all slots valid — the slot field then covers exactly
        the dense twin's pair set."""
        dev = self.types.device
        ids = torch.arange(n, device=dev)
        idx = (ids[:, None] + 1 + torch.arange(n - 1, device=dev)[None, :]) % n
        return NB.NeighborList(idx=idx, mask=torch.ones_like(idx, dtype=torch.bool))

    def _list(self, nbr, Bn: int, n: int):
        """The list as (B, N, K) idx and mask (the all-pairs list when
        ``nbr`` is None)."""
        if nbr is None:
            nbr = self._default_nbr(n)
        k = nbr.idx.shape[-1]
        idx = nbr.idx.reshape(-1, n, k).expand(Bn, n, k)
        mask = nbr.mask.reshape(-1, n, k).expand(Bn, n, k)
        return idx, mask

    def bond_orders(self, pos, h, nbr=None):
        """Diagnostic twin of :meth:`ReaxFFDense.bond_orders`, scattered
        back to (..., N, N) atom-pair matrices."""
        pf, hf, lead = _flat(pos, h)
        n = pf.shape[1]
        idx, mask = self._list(nbr, pf.shape[0], n)
        _, r = self._pair_geometry(pf, hf, idx, mask)
        B = self._bond_orders(r, idx, mask)

        def dense(v):
            z = torch.zeros(v.shape[:2] + (n,), dtype=v.dtype, device=v.device)
            return z.scatter_reduce(2, idx, torch.where(mask, v, 0.0), reduce="amax")

        return _unflat({"bo": dense(B["bo"]), "sigma": dense(B["bos"]),
                        "pi": dense(B["bopi"]), "pipi": dense(B["bopp"]),
                        "total": B["total"]}, lead)

    def energy(self, pos, h, nbr=None):
        return self.energy_terms(pos, h, nbr)["total"]

    def energy_qeq(self, pos, h, nbr=None, qeq_guess=None):
        """(total energy, qeq_aux): the warm-start entry point.  ``qeq_guess``
        is the (..., 2, N) (s, tv) CG-vector pair a previous call returned
        as ``qeq_aux``; it seeds both CG solves and drops the trip count to
        ``qeq_iters_warm``."""
        terms = self.energy_terms(pos, h, nbr, qeq_guess=qeq_guess)
        return terms["total"], terms["qeq_aux"]

    def energy_terms(self, pos, h, nbr=None, qeq_guess=None):
        """The energy contributions per job (see
        :meth:`ReaxFFDense.energy_terms`), the charges ``q`` (..., N) and
        ``qeq_aux`` (..., 2, N).  ``nbr`` None takes the all-pairs list."""
        pf, hf, lead = _flat(pos, h)
        T = self.tables
        t = self.types
        Bn, n = pf.shape[:2]
        idx, mask = self._list(nbr, Bn, n)
        G, r = self._pair_geometry(pf, hf, idx, mask)
        B = self._bond_orders(r, idx, mask)
        tl = self._tl(idx)
        out, nlp, vlpex = self._bond_and_coordination(B, tl, lambda v: _gather_slots(v, idx))

        # --- bonded sub-list: top-K slots by corrected BO ---
        K = min(int(T["top_k"]), idx.shape[-1])
        bo_k, sel = _top_k(torch.where(B["listed"], B["bo"], -1.0), K)  # slot positions
        nb_mask = bo_k > THB_CUT
        idx_b = torch.gather(idx, 2, sel)  # global neighbor ids
        Gk = torch.gather(G, 2, sel[..., None].expand(-1, -1, -1, 3))
        rk = torch.gather(r, 2, sel)
        bopi_jk = torch.gather(B["bopi"], 2, sel)
        out.update(self._many_body(B, nlp, vlpex, bo_k, nb_mask, idx_b, Gk, rk, bopi_jk))

        # --- hydrogen bonds: acceptors from the nonbonded slot list ---
        if self.with_hbond:
            is_acc = T["p_hbond"][t] == 2.0
            rz = r[:, :, None, :]  # (B, N, 1, K_nb): r(j, z) per slot
            acc_ok = ((rz < HB_CUT) & (rz > 0.0) & mask[:, :, None, :]
                      & is_acc[idx][:, :, None, :]
                      & (idx[:, :, None, :] != idx_b[..., None]))
            out["e_hb"] = self._hbond(t[idx_b], bo_k, nb_mask, Gk, rk, rz,
                                      G[:, :, None, :, :], t[idx][:, :, None, :], acc_ok)
        else:
            out["e_hb"] = torch.zeros(Bn, dtype=pf.dtype, device=pf.device)

        # --- nonbonded on the slot list ---
        within = mask & (r < self.cutoff) & (r > 0.0)
        out["e_vdw"], shield = self._nonbonded(r, within, tl)
        if self.qeq:
            guess = None if qeq_guess is None else qeq_guess.reshape(Bn, 2, n)
            q, qeq_aux = self._solve_qeq(shield, idx, guess=guess)
        else:
            q = torch.zeros_like(pf[..., 0])
            qeq_aux = torch.stack([q, q], 1)
        out["e_coul"] = 0.5 * C_ELE * _jsum(shield * q[:, :, None] * _rows(q, idx))
        out["e_pol"] = self._polarization(q)
        out["total"] = sum(out[k] for k in TERMS)
        out["q"] = q
        out["qeq_aux"] = qeq_aux
        return _unflat(out, lead)

    def _solve_qeq(self, shield, idx, guess=None):
        """Neutrality-constrained EEM charges by Jacobi-preconditioned CG
        with the list matvec A v = 2 eta v + 14.4 sum_k shield[i,k]
        v[idx[i,k]] (reax.py:948-1007): ``qeq_iters`` trips from the
        Jacobi start, or ``qeq_iters_warm`` from ``guess``, the (B, 2, N)
        (s, tv) pair of a previous solve.  The two right-hand sides -chi
        and 1 run side by side, each with its own step lengths, and every
        inner product sums over one job's atoms.  Charges and the returned
        aux (B, 2, N) are detached.  Returns ``(q, aux)``."""
        T = self.tables
        t = self.types
        with torch.no_grad():
            shield = shield.detach()
            diag = (2.0 * T["eta"][t])[:, None]  # (N, 1)
            minv = 1.0 / diag
            iters = self.qeq_iters if guess is None else self.qeq_iters_warm

            def matvec(v):  # v (B, N, 2)
                return diag * v + KC_EV * torch.sum(shield[..., None] * _rows(v, idx), 2)

            b = torch.stack([-T["chi"][t], torch.ones_like(T["chi"][t])], -1)  # (N, 2)
            x = (minv * b).expand(shield.shape[0], -1, -1) if guess is None \
                else guess.detach().transpose(1, 2)
            res = b - matvec(x)
            z = minv * res
            p = z
            rz = torch.sum(res * z, 1, keepdim=True)  # (B, 1, 2)
            for _ in range(iters):
                ap = matvec(p)
                alpha = rz / torch.clamp(torch.sum(p * ap, 1, keepdim=True), min=1e-30)
                x = x + alpha * p
                res = res - alpha * ap
                z = minv * res
                rz_new = torch.sum(res * z, 1, keepdim=True)
                beta = rz_new / torch.clamp(rz, min=1e-30)
                p = z + beta * p
                rz = rz_new
            s, tv = x[..., 0], x[..., 1]
            q = s - (torch.sum(s, -1) / torch.sum(tv, -1))[:, None] * tv
            return q, torch.stack([s, tv], 1)


def _gather_slots(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """A per-atom quantity at each slot's partner: v (B, N) or per-type
    (N,) -> (B, N, K)."""
    return v[idx] if v.dim() == 1 else _rows(v, idx)


def build_reax(ffield_path: str, elements, masses, dtype=torch.float64, device=None,
               top_k: int = 8, qeq: bool = True, impl: str = "list"):
    """Build a ReaxFF force field for atoms given by ``masses``
    (reax.py:1010-1078).

    ``elements`` is the pair_coeff element order (["H","C","N","O"] for the
    reference scripts); atom types are inferred from ``masses`` by nearest
    force-field atomic mass.  ``impl`` picks the production neighbor-list
    field (:class:`ReaxFFList`) or the dense twin (:class:`ReaxFFDense`,
    the parity anchor the list field is tested against).  The tables are
    tensors of ``dtype`` on ``device`` (masks bool), the scalars floats."""
    P = parse_ffield(ffield_path, list(elements))
    m = np.asarray(masses, dtype=np.float64)
    type_idx = np.argmin(np.abs(m[:, None] - P.mass[None, :]), axis=1)
    gp = P.gp

    def j(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

    def b(a):
        return torch.as_tensor(np.asarray(a, dtype=bool), device=device)

    arrays = ("mass", "valency", "valency_e", "valency_boc", "valency_val", "chi", "eta",
              "gamma", "p_hbond", "p_lp2", "p_boc3", "p_boc4", "p_boc5", "p_ovun2", "p_ovun5",
              "p_val3", "p_val5", "De_s", "De_pi", "De_pipi", "p_be1", "p_be2", "p_bo1",
              "p_bo2", "p_bo3", "p_bo4", "p_bo5", "p_bo6", "p_ovun1", "v13cor", "ovc",
              "r_s_ij", "r_pi_ij", "r_pipi_ij", "D_ij", "r_vdw_ij", "alpha_ij", "gamma_w_ij",
              "gamma_ij", "theta00", "p_val1", "p_val2", "p_coa1", "p_val7", "p_pen1",
              "p_val4", "V1", "V2", "V3", "p_tor1", "p_cot1", "r0_hb", "p_hb1", "p_hb2",
              "p_hb3")
    # general parameters by their slot in the file (reax.py:1031-1041)
    general = dict(p_boc1=0, p_boc2=1, p_coa2=2, p_ovun6=6, p_ovun7=8, p_ovun8=9, p_val6=14,
                   p_lp1=15, p_val9=16, p_val10=17, p_pen2=19, p_pen3=20, p_pen4=21,
                   p_tor2=23, p_tor3=24, p_tor4=25, p_cot2=27, p_vdw1=28, p_coa4=30,
                   p_ovun4=31, p_ovun3=32, p_val8=33, p_coa3=38)
    tables = dict(bo_cut=float(P.bo_cut), top_k=int(top_k),
                  **{k: float(gp[i]) for k, i in general.items()},
                  **{k: j(getattr(P, k)) for k in arrays},
                  **{k: b(getattr(P, k)) for k in ("ang_mask", "tor_mask", "hb_mask")})
    present = set(int(x) for x in np.unique(type_idx))
    has_h = any(P.p_hbond[i] == 1 for i in present)
    has_acc = any(P.p_hbond[i] == 2 for i in present)
    cls = {"list": ReaxFFList, "dense": ReaxFFDense}[impl]
    return cls(tables=tables, types=torch.as_tensor(type_idx, dtype=torch.int64, device=device),
               cutoff=float(P.swb), qeq=qeq, with_hbond=bool(has_h and has_acc))
