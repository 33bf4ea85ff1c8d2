"""ReaxFF force-field file parser (``ffield.reax`` format).

Parses the standard ReaxFF parameter file the reference feeds to
``pair_style reax/c`` (``pair_coeff * * ffield.reax.2 H C N O``,
lammps_scripts_reax/in.set.lammps) into dense per-type parameter
tables, with the LAMMPS type order (the ``pair_coeff`` element list)
mapped onto the file's own element order.

Layout of the file (fixed sections, counts on the header lines):

* 39 general parameters (one per line)
* per-element blocks of 4 x 8 values
* bond blocks of 2 x 8 values keyed by (type_i, type_j)
* off-diagonal vdW/bond-radius overrides keyed by (i, j)
* valence-angle rows keyed by (i, j, k) — j central
* torsion rows keyed by (i, j, k, l); 0 means wildcard
* hydrogen-bond rows keyed by (donor, H, acceptor)

Slot meanings follow the published ReaxFF supporting-information
conventions (Chenoweth, van Duin, Goddard, J. Phys. Chem. A 112, 1040
(2008)); the comment headers inside the file itself are partially
mislabelled (e.g. the off-diagonal "gamma" column is the Morse alpha)
and are not trusted.

All tables are dense numpy arrays indexed by the *simulation* type ids
(0-based, in pair_coeff order) so the energy code can gather from them
with plain advanced indexing under jit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ReaxParams", "parse_ffield"]


@dataclasses.dataclass(frozen=True)
class ReaxParams:
    """Dense ReaxFF parameter tables for one simulated type set.

    ``nt`` below is the number of simulation types (pair_coeff order).
    Per-pair tables are symmetrised; angle/torsion/hbond tables are
    dense over type triples/quadruples with a companion mask of which
    entries exist in the file (absent combinations contribute nothing,
    matching reax/c, which skips missing parameter rows).
    """

    symbols: tuple  # (nt,) element symbols in simulation-type order
    gp: np.ndarray  # (39,) general parameters, 0-based indexing

    # per-type (nt,)
    r_s: np.ndarray
    r_pi: np.ndarray
    r_pipi: np.ndarray
    valency: np.ndarray
    valency_e: np.ndarray  # nr of valence electrons (lone-pair ref)
    valency_boc: np.ndarray
    valency_val: np.ndarray  # valency used in angle SBO
    mass: np.ndarray
    r_vdw: np.ndarray
    epsilon: np.ndarray
    gamma: np.ndarray  # EEM / Coulomb shielding
    alpha: np.ndarray
    gamma_w: np.ndarray  # vdW shielding
    p_ovun5: np.ndarray
    chi: np.ndarray  # EEM electronegativity (eV)
    eta: np.ndarray  # EEM hardness (eV)
    p_hbond: np.ndarray  # 1 = H (donor), 2 = acceptor, 0 = neither
    p_lp2: np.ndarray
    p_boc3: np.ndarray
    p_boc4: np.ndarray
    p_boc5: np.ndarray
    p_ovun2: np.ndarray
    p_val3: np.ndarray
    p_val5: np.ndarray

    # per-pair (nt, nt), symmetric
    bond_mask: np.ndarray  # bool: bond row present
    De_s: np.ndarray
    De_pi: np.ndarray
    De_pipi: np.ndarray
    p_be1: np.ndarray
    p_be2: np.ndarray
    p_bo1: np.ndarray
    p_bo2: np.ndarray
    p_bo3: np.ndarray
    p_bo4: np.ndarray
    p_bo5: np.ndarray
    p_bo6: np.ndarray
    p_ovun1: np.ndarray
    v13cor: np.ndarray  # f4/f5 switch (>=0.001 -> apply)
    ovc: np.ndarray  # f1 switch (>=0.001 -> apply)
    # pair radii (combining rule, overridden by off-diagonal rows)
    r_s_ij: np.ndarray
    r_pi_ij: np.ndarray
    r_pipi_ij: np.ndarray
    # pair vdW (geometric means, overridden by off-diagonal rows)
    D_ij: np.ndarray
    r_vdw_ij: np.ndarray
    alpha_ij: np.ndarray
    gamma_w_ij: np.ndarray
    gamma_ij: np.ndarray

    # angles, dense (nt, nt, nt): [i, j, k] with j the apex
    ang_mask: np.ndarray
    theta00: np.ndarray  # degrees (equilibrium 180 - theta offset)
    p_val1: np.ndarray
    p_val2: np.ndarray
    p_coa1: np.ndarray
    p_val7: np.ndarray
    p_pen1: np.ndarray
    p_val4: np.ndarray

    # torsions, dense (nt, nt, nt, nt): [i, j, k, l], j-k central bond
    tor_mask: np.ndarray
    V1: np.ndarray
    V2: np.ndarray
    V3: np.ndarray
    p_tor1: np.ndarray
    p_cot1: np.ndarray

    # hydrogen bonds, dense (nt, nt, nt): [donor, H, acceptor]
    hb_mask: np.ndarray
    r0_hb: np.ndarray
    p_hb1: np.ndarray
    p_hb2: np.ndarray
    p_hb3: np.ndarray

    @property
    def n_types(self) -> int:
        return len(self.symbols)

    @property
    def bo_cut(self) -> float:
        """Bond-order list cutoff: general parameter 30 is 100x it."""
        return float(self.gp[29]) * 0.01

    @property
    def swb(self) -> float:
        """Upper taper radius (nonbonded cutoff), general parameter 13."""
        return float(self.gp[12])

    @property
    def swa(self) -> float:
        """Lower taper radius, general parameter 12."""
        return float(self.gp[11])


def _read_floats(tokens):
    return [float(t) for t in tokens]


def parse_ffield(path: str, elements: list[str]) -> ReaxParams:
    """Parse ``ffield.reax``-format ``path`` for the given element order.

    ``elements`` is the pair_coeff element list (e.g. ``["H","C","N","O"]``
    from in.set.lammps); simulation type ``t`` maps to the file entry
    whose symbol matches ``elements[t]`` (case-insensitive).
    """
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    pos = 1  # skip title line

    def take():
        nonlocal pos
        ln = lines[pos]
        pos += 1
        return ln

    # --- general parameters ---
    n_gen = int(take().split()[0])
    gp = np.array([float(take().split()[0]) for _ in range(n_gen)])

    # --- atoms ---
    n_atoms_ff = int(take().split("!")[0])
    take(), take(), take()  # 3 continuation header lines
    file_syms = []
    atom_rows = []
    for _ in range(n_atoms_ff):
        l1 = take().split()
        sym = l1[0]
        vals = _read_floats(l1[1:])
        for _ in range(3):
            vals += _read_floats(take().split())
        if len(vals) != 32:
            raise ValueError(f"atom block for {sym}: {len(vals)} values")
        file_syms.append(sym.capitalize())
        atom_rows.append(vals)
    atom_rows = np.array(atom_rows)

    sym_to_file = {s: i for i, s in enumerate(file_syms)}
    try:
        fidx = np.array([sym_to_file[e.capitalize()] for e in elements])
    except KeyError as e:  # pragma: no cover - config error
        raise ValueError(
            f"element {e} not in force field (has {file_syms})") from None
    nt = len(elements)
    A = atom_rows[fidx]  # (nt, 32) in file slot order

    # file->simulation-type inverse map for keyed sections (-1: unused)
    inv = -np.ones(n_atoms_ff + 1, dtype=int)  # +1: file types are 1-based
    for t, fi in enumerate(fidx):
        inv[fi + 1] = t

    per = dict(
        r_s=A[:, 0], valency=A[:, 1], mass=A[:, 2], r_vdw=A[:, 3],
        epsilon=A[:, 4], gamma=A[:, 5], r_pi=A[:, 6], valency_e=A[:, 7],
        alpha=A[:, 8], gamma_w=A[:, 9], valency_boc=A[:, 10],
        p_ovun5=A[:, 11], chi=A[:, 13], eta=A[:, 14], p_hbond=A[:, 15],
        r_pipi=A[:, 16], p_lp2=A[:, 17],
        p_boc4=A[:, 19], p_boc3=A[:, 20], p_boc5=A[:, 21],
        p_ovun2=A[:, 24], p_val3=A[:, 25], valency_val=A[:, 27],
        p_val5=A[:, 28],
    )

    # --- bonds ---
    n_bonds = int(take().split()[0])
    take()  # continuation header
    bond_keys = ["De_s", "De_pi", "De_pipi", "p_be1", "p_bo5", "v13cor",
                 "p_bo6", "p_ovun1",
                 "p_be2", "p_bo3", "p_bo4", "_nu", "p_bo1", "p_bo2",
                 "ovc", "_nu2"]
    bond = {k: np.zeros((nt, nt)) for k in bond_keys}
    bond_mask = np.zeros((nt, nt), dtype=bool)
    for _ in range(n_bonds):
        l1 = take().split()
        i, j = inv[int(l1[0])], inv[int(l1[1])]
        vals = _read_floats(l1[2:]) + _read_floats(take().split())
        if i < 0 or j < 0:
            continue
        for k, v in zip(bond_keys, vals):
            bond[k][i, j] = bond[k][j, i] = v
        bond_mask[i, j] = bond_mask[j, i] = True

    # --- off-diagonal ---
    n_off = int(take().split()[0])
    off = {}
    for _ in range(n_off):
        ln = take().split()
        i, j = inv[int(ln[0])], inv[int(ln[1])]
        if i < 0 or j < 0:
            continue
        off[(i, j)] = _read_floats(ln[2:8])

    # pair combining rules + overrides.  Radii: arithmetic mean; only
    # valid (>0) when both ends define the radius.  vdW D/alpha/r:
    # geometric means of the per-atom values; gamma_w/gamma likewise.
    def pair_mean(v):
        return 0.5 * (v[:, None] + v[None, :])

    def pair_geo(v):
        return np.sqrt(np.maximum(v[:, None] * v[None, :], 0.0))

    def radius_pair(v):
        m = pair_mean(v)
        both = (v[:, None] > 0) & (v[None, :] > 0)
        return np.where(both, m, -1.0)

    # The file's Rvdw column is a RADIUS: the Morse well position in the
    # energy expression is the pair diameter 2*sqrt(r_i r_j), and
    # off-diagonal Ro overrides are likewise doubled (reax/c
    # Init_Force_Field conventions).  Getting this wrong halves the vdW
    # inner-wall distance and every covalent bond collapses.
    pair = dict(
        r_s_ij=radius_pair(per["r_s"]),
        r_pi_ij=radius_pair(per["r_pi"]),
        r_pipi_ij=radius_pair(per["r_pipi"]),
        D_ij=pair_geo(per["epsilon"]),
        r_vdw_ij=2.0 * pair_geo(per["r_vdw"]),
        alpha_ij=pair_geo(per["alpha"]),
        gamma_w_ij=pair_geo(per["gamma_w"]),
        gamma_ij=pair_geo(per["gamma"]),
    )
    for (i, j), vals in off.items():
        D, ro, al, rs, rp, rpp = vals
        if D > 0:
            pair["D_ij"][i, j] = pair["D_ij"][j, i] = D
        if ro > 0:
            pair["r_vdw_ij"][i, j] = pair["r_vdw_ij"][j, i] = 2.0 * ro
        if al > 0:
            pair["alpha_ij"][i, j] = pair["alpha_ij"][j, i] = al
        if rs > 0:
            pair["r_s_ij"][i, j] = pair["r_s_ij"][j, i] = rs
        if rp > 0:
            pair["r_pi_ij"][i, j] = pair["r_pi_ij"][j, i] = rp
        if rpp > 0:
            pair["r_pipi_ij"][i, j] = pair["r_pipi_ij"][j, i] = rpp

    # --- angles ---
    n_ang = int(take().split()[0])
    ang_keys = ["theta00", "p_val1", "p_val2", "p_coa1", "p_val7",
                "p_pen1", "p_val4"]
    ang = {k: np.zeros((nt, nt, nt)) for k in ang_keys}
    ang_mask = np.zeros((nt, nt, nt), dtype=bool)
    for _ in range(n_ang):
        ln = take().split()
        i, j, k = inv[int(ln[0])], inv[int(ln[1])], inv[int(ln[2])]
        vals = _read_floats(ln[3:10])
        if i < 0 or j < 0 or k < 0:
            continue
        for key, v in zip(ang_keys, vals):
            ang[key][i, j, k] = ang[key][k, j, i] = v
        # rows with all-zero force constants are explicit "no term" rows;
        # keep them masked in (reax/c does evaluate them -> zero energy)
        ang_mask[i, j, k] = ang_mask[k, j, i] = True

    # --- torsions (0 = wildcard on outer types) ---
    n_tor = int(take().split()[0])
    tor_keys = ["V1", "V2", "V3", "p_tor1", "p_cot1"]
    tor = {k: np.zeros((nt, nt, nt, nt)) for k in tor_keys}
    tor_mask = np.zeros((nt, nt, nt, nt), dtype=bool)
    tor_wild = {k: np.zeros((nt, nt)) for k in tor_keys}  # [j, k] wildcards
    tor_wild_mask = np.zeros((nt, nt), dtype=bool)
    explicit = []
    for _ in range(n_tor):
        ln = take().split()
        ti, tj, tk, tl = (int(ln[0]), int(ln[1]), int(ln[2]), int(ln[3]))
        vals = _read_floats(ln[4:9])
        j, k = inv[tj], inv[tk]
        if j < 0 or k < 0:
            continue
        if ti == 0 or tl == 0:  # wildcard row X-j-k-X
            for key, v in zip(tor_keys, vals):
                tor_wild[key][j, k] = tor_wild[key][k, j] = v
            tor_wild_mask[j, k] = tor_wild_mask[k, j] = True
        else:
            i, l = inv[ti], inv[tl]
            if i < 0 or l < 0:
                continue
            explicit.append((i, j, k, l, vals))
    # broadcast wildcards first, then overwrite with explicit rows
    for j in range(nt):
        for k in range(nt):
            if tor_wild_mask[j, k]:
                for key in tor_keys:
                    tor[key][:, j, k, :] = tor_wild[key][j, k]
                    tor[key][:, k, j, :] = tor_wild[key][j, k]
                tor_mask[:, j, k, :] = tor_mask[:, k, j, :] = True
    for i, j, k, l, vals in explicit:
        for key, v in zip(tor_keys, vals):
            tor[key][i, j, k, l] = tor[key][l, k, j, i] = v
        tor_mask[i, j, k, l] = tor_mask[l, k, j, i] = True

    # --- hydrogen bonds ---
    hb_keys = ["r0_hb", "p_hb1", "p_hb2", "p_hb3"]
    hb = {k: np.zeros((nt, nt, nt)) for k in hb_keys}
    hb_mask = np.zeros((nt, nt, nt), dtype=bool)
    if pos < len(lines) and lines[pos].strip():
        n_hb = int(take().split()[0])
        for _ in range(n_hb):
            ln = take().split()
            i, j, k = inv[int(ln[0])], inv[int(ln[1])], inv[int(ln[2])]
            vals = _read_floats(ln[3:7])
            if i < 0 or j < 0 or k < 0:
                continue
            for key, v in zip(hb_keys, vals):
                hb[key][i, j, k] = v
            hb_mask[i, j, k] = True

    return ReaxParams(
        symbols=tuple(e.capitalize() for e in elements), gp=gp,
        **per,
        bond_mask=bond_mask,
        **{k: v for k, v in bond.items() if not k.startswith("_")},
        **pair,
        ang_mask=ang_mask, **ang,
        tor_mask=tor_mask, **tor,
        hb_mask=hb_mask, **hb,
    )
