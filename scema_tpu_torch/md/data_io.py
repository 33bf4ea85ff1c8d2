"""LAMMPS text data-file IO ('atom_style full') and simple molecule builders.

The reference's molecular systems arrive as opaque LAMMPS binary restarts
(nanoscale_input/init.<mat>_<n>.bin); the portable interchange format is
the text data file (read_data), which this module reads and writes so
users can move systems between LAMMPS and this framework.  Sections
handled: Masses, Pair Coeffs, Bond Coeffs, Angle Coeffs, Dihedral Coeffs,
Improper Coeffs, Atoms (full), Velocities, Bonds, Angles, Dihedrals,
Impropers.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class MolecularData:
    masses: np.ndarray  # (ntypes,)
    pos: np.ndarray  # (N, 3)
    vel: np.ndarray | None
    types: np.ndarray  # (N,) 0-based
    charges: np.ndarray  # (N,)
    box: np.ndarray  # (3, 3) h-matrix
    pair_coeffs: np.ndarray  # (ntypes, 2) epsilon sigma
    bonds: np.ndarray  # (nb, 2) 0-based
    bond_types: np.ndarray
    bond_coeffs: np.ndarray  # (nbt, 2) K r0
    angles: np.ndarray
    angle_types: np.ndarray
    angle_coeffs: np.ndarray  # (nat, 2) K theta0(deg)
    dihedrals: np.ndarray
    dihedral_types: np.ndarray
    dihedral_coeffs: np.ndarray  # (ndt, 4) K1..K4
    impropers: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.int32))
    improper_types: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int32))
    improper_coeffs: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))


def read_data(path: str) -> MolecularData:
    """Parse a LAMMPS data file (read_data format).

    Atom styles ``full`` (OPLS scripts), ``charge`` (reax scripts:
    lammps_scripts_reax/in.set.lammps ``atom_style charge``), and
    ``atomic`` are auto-detected from the Atoms row width; optional
    image-flag columns are accepted and ignored (positions are used
    min-image).  ``molecular`` style (6 columns, no charge) is NOT
    distinguishable from ``charge`` by width and is not supported.
    """
    with open(path) as f:
        lines = f.read().splitlines()

    counts = {}
    tilts = np.zeros(3)
    lo = np.zeros(3)
    hi = np.zeros(3)
    sections: dict[str, list[list[str]]] = {}
    i = 1  # skip title line
    section = None
    known = {
        "Masses", "Pair Coeffs", "Bond Coeffs", "Angle Coeffs",
        "Dihedral Coeffs", "Improper Coeffs", "Atoms", "Velocities",
        "Bonds", "Angles", "Dihedrals", "Impropers",
    }
    while i < len(lines):
        raw = lines[i].split("#")[0].strip()
        i += 1
        if not raw:
            continue
        head = raw
        for k in known:
            if head.startswith(k):
                section = k
                sections[k] = []
                break
        else:
            if section is not None and raw[0].isdigit() or (section and raw[0] == "-"):
                sections[section].append(raw.split())
                continue
            parts = raw.split()
            if raw.endswith(("atoms", "bonds", "angles", "dihedrals", "impropers")):
                counts[parts[-1]] = int(parts[0])
            elif "types" in raw:
                counts[" ".join(parts[-2:])] = int(parts[0])
            elif raw.endswith("xhi"):
                lo[0], hi[0] = float(parts[0]), float(parts[1])
            elif raw.endswith("yhi"):
                lo[1], hi[1] = float(parts[0]), float(parts[1])
            elif raw.endswith("zhi"):
                lo[2], hi[2] = float(parts[0]), float(parts[1])
            elif raw.endswith("yz"):
                tilts[:] = [float(parts[0]), float(parts[1]), float(parts[2])]
            continue

    n = counts.get("atoms", 0)
    ntypes = counts.get("atom types", 0)
    L = hi - lo
    box = np.array(
        [[L[0], tilts[0], tilts[1]], [0, L[1], tilts[2]], [0, 0, L[2]]]
    )

    masses = np.zeros(ntypes)
    for row in sections.get("Masses", []):
        masses[int(row[0]) - 1] = float(row[1])

    pair = np.zeros((ntypes, 2))
    for row in sections.get("Pair Coeffs", []):
        pair[int(row[0]) - 1] = [float(row[1]), float(row[2])]

    pos = np.zeros((n, 3))
    types = np.zeros(n, dtype=np.int32)
    charges = np.zeros(n)
    atom_rows = sections.get("Atoms", [])
    # atom_style detection by column count (the style comment on the
    # section header is stripped with all other comments above):
    #   atomic: id type x y z            -> 5 (+3 image ints -> 8)
    #   charge: id type q x y z          -> 6 (+3 -> 9)   [reax files]
    #   full:   id mol type q x y z      -> 7 (+3 -> 10)
    # the six counts are disjoint, so the width identifies the style.
    if atom_rows:
        ncol = len(atom_rows[0])
        style = {5: "atomic", 8: "atomic", 6: "charge", 9: "charge",
                 7: "full", 10: "full"}.get(ncol)
        if style is None:
            raise ValueError(
                f"unrecognized Atoms row width {ncol} in {path!r} "
                "(supported atom styles: atomic, charge, full)")
        t_col = 1 if style in ("atomic", "charge") else 2
        q_col = None if style == "atomic" else t_col + 1
        x_col = t_col + 1 if q_col is None else q_col + 1
    for row in atom_rows:
        aid = int(row[0]) - 1
        types[aid] = int(row[t_col]) - 1
        if q_col is not None:
            charges[aid] = float(row[q_col])
        pos[aid] = [float(row[x_col]), float(row[x_col + 1]),
                    float(row[x_col + 2])]
    if atom_rows and (types.min() < 0 or types.max() >= ntypes):
        # the molecular style (id mol type x y z [+images]) collides with
        # charge's column widths; its mol-id lands in our type column and
        # usually exceeds the declared type count — fail loudly instead
        # of silently producing garbage types/charges
        raise ValueError(
            f"{path!r}: atom type {types.max() + 1} out of range "
            f"(1..{ntypes}) — if this is an atom_style 'molecular' file "
            "it is indistinguishable from 'charge' by column count and "
            "is not supported")
    pos -= lo[None, :]

    vel = None
    if "Velocities" in sections:
        vel = np.zeros((n, 3))
        for row in sections["Velocities"]:
            vel[int(row[0]) - 1] = [float(row[1]), float(row[2]), float(row[3])]

    def conn(name, width):
        rows = sections.get(name, [])
        arr = np.zeros((len(rows), width), dtype=np.int32)
        tps = np.zeros(len(rows), dtype=np.int32)
        for k, row in enumerate(rows):
            tps[k] = int(row[1]) - 1
            arr[k] = [int(x) - 1 for x in row[2 : 2 + width]]
        return arr, tps

    def coeffs(name, width):
        rows = sections.get(name, [])
        out = np.zeros((len(rows), width))
        for row in rows:
            out[int(row[0]) - 1] = [float(x) for x in row[1 : 1 + width]]
        return out

    bonds, bond_types = conn("Bonds", 2)
    angles, angle_types = conn("Angles", 3)
    dihedrals, dihedral_types = conn("Dihedrals", 4)
    impropers, improper_types = conn("Impropers", 4)

    return MolecularData(
        masses=masses,
        pos=pos,
        vel=vel,
        types=types,
        charges=charges,
        box=box,
        pair_coeffs=pair,
        bonds=bonds,
        bond_types=bond_types,
        bond_coeffs=coeffs("Bond Coeffs", 2),
        angles=angles,
        angle_types=angle_types,
        angle_coeffs=coeffs("Angle Coeffs", 2),
        dihedrals=dihedrals,
        dihedral_types=dihedral_types,
        dihedral_coeffs=coeffs("Dihedral Coeffs", 4),
        impropers=impropers,
        improper_types=improper_types,
        improper_coeffs=coeffs("Improper Coeffs", 2),
    )


def build_alkane_chain(
    n_carbons: int = 8,
    box_length: float = 30.0,
    bond_r0: float = 1.54,
    angle_deg: float = 112.0,
) -> MolecularData:
    """United-atom alkane chain (CH2 beads) in a cubic box — a small
    polyethylene-like test system with bonds/angles/dihedrals and OPLS-UA
    style parameters (eps=0.118 kcal/mol, sig=3.905 A, TraPPE-ish)."""
    n = n_carbons
    theta = np.deg2rad(angle_deg)
    pos = np.zeros((n, 3))
    # zig-zag backbone along x
    dx = bond_r0 * np.sin(theta / 2.0)
    dz = bond_r0 * np.cos(theta / 2.0)
    for i in range(n):
        pos[i] = [i * dx, 0.0, (i % 2) * dz]
    pos += box_length / 2.0 - pos.mean(axis=0)

    bonds = np.array([[i, i + 1] for i in range(n - 1)], dtype=np.int32)
    angles = np.array([[i, i + 1, i + 2] for i in range(n - 2)], dtype=np.int32)
    dihedrals = np.array([[i, i + 1, i + 2, i + 3] for i in range(n - 3)], dtype=np.int32)

    return MolecularData(
        masses=np.array([14.027]),
        pos=pos,
        vel=None,
        types=np.zeros(n, dtype=np.int32),
        charges=np.zeros(n),
        box=np.eye(3) * box_length,
        pair_coeffs=np.array([[0.118, 3.905]]),
        bonds=bonds,
        bond_types=np.zeros(len(bonds), dtype=np.int32),
        bond_coeffs=np.array([[260.0, bond_r0]]),
        angles=angles,
        angle_types=np.zeros(len(angles), dtype=np.int32),
        angle_coeffs=np.array([[63.0, angle_deg]]),
        dihedrals=dihedrals,
        dihedral_types=np.zeros(len(dihedrals), dtype=np.int32),
        dihedral_coeffs=np.array([[1.411, -0.271, 3.145, 0.0]]),
    )


def build_alkane_melt(
    n_chains: int = 27,
    n_carbons: int = 8,
    density_scale: float = 1.0,
) -> MolecularData:
    """A melt of united-atom alkane chains on a lattice — the test/demo
    polymer material standing in for the reference's polyethylene boxes
    (whose LAMMPS binary restarts are opaque).  Chains are placed on a
    cubic lattice sized for ~0.7 g/cm^3 and need equilibration
    (material.equilibrate_staged) before production use."""
    single = build_alkane_chain(n_carbons, box_length=1.0)
    n_side = int(round(n_chains ** (1.0 / 3.0)))
    n_chains = n_side**3
    n_per = n_carbons
    # melt density ~0.70 g/cm^3 => volume per CH2 bead ~ 33 A^3
    vol = n_chains * n_per * 33.3 / density_scale
    L = vol ** (1.0 / 3.0)
    pitch = L / n_side

    chain = single.pos - single.pos.mean(axis=0)
    span = np.abs(chain).max()
    scale = min(1.0, 0.45 * pitch / max(span, 1e-9))
    # compress the chain slightly if the lattice pitch is tight; bonds are
    # restored by minimization
    chain_local = chain * max(scale, 0.6)

    pos = []
    bonds, angles, dihedrals = [], [], []
    for cz in range(n_side):
        for cy in range(n_side):
            for cx in range(n_side):
                base = len(pos)
                off = (np.array([cx, cy, cz]) + 0.5) * pitch
                rot = np.eye(3)
                if (cx + cy + cz) % 2:
                    rot = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0.0]])
                pos.extend((chain_local @ rot.T) + off)
                bonds.extend(single.bonds + base)
                angles.extend(single.angles + base)
                dihedrals.extend(single.dihedrals + base)

    n = len(pos)
    return MolecularData(
        masses=single.masses,
        pos=np.asarray(pos),
        vel=None,
        types=np.zeros(n, dtype=np.int32),
        charges=np.zeros(n),
        box=np.eye(3) * L,
        pair_coeffs=single.pair_coeffs,
        bonds=np.asarray(bonds, dtype=np.int32),
        bond_types=np.zeros(len(bonds), dtype=np.int32),
        bond_coeffs=single.bond_coeffs,
        angles=np.asarray(angles, dtype=np.int32),
        angle_types=np.zeros(len(angles), dtype=np.int32),
        angle_coeffs=single.angle_coeffs,
        dihedrals=np.asarray(dihedrals, dtype=np.int32),
        dihedral_types=np.zeros(len(dihedrals), dtype=np.int32),
        dihedral_coeffs=single.dihedral_coeffs,
    )


def build_pe_chain_allatom(n_carbons: int = 10,
                           backbone_scale: float = 1.0) -> MolecularData:
    """One all-atom polyethylene chain (the reference's OPLS material:
    'polyethane ... type 1, 2 = C, 3 = H', lammps_scripts_opls/
    in.set.lammps + in.strain.lammps dump_modify comment) with OPLS-AA
    alkane parameters (Jorgensen et al. 1996).

    Atom order is [C H H (H)] per heavy group — every hydrogen sits at
    offset +1..+3 of its parent carbon, which the fused kernel's
    roll-based SHAKE exploits (constraint partners at small static
    offsets).  Types: 0 = CH3 carbon, 1 = CH2 carbon, 2 = H, mirroring
    the reference's type numbering.
    """
    nC = n_carbons
    rCC, rCH = 1.529, 1.09
    thCCC = np.deg2rad(112.7)
    thHCH = np.deg2rad(107.8)
    # zig-zag backbone in the xz plane; ``backbone_scale`` compacts the
    # carbon skeleton for tight melt lattices WITHOUT touching the C-H
    # geometry (hydrogens are rebuilt at exact bond length below, so
    # SHAKE starts from satisfied constraints)
    dx = rCC * np.sin(thCCC / 2.0) * backbone_scale
    dz = rCC * np.cos(thCCC / 2.0) * backbone_scale
    cpos = np.array([[i * dx, 0.0, (i % 2) * dz] for i in range(nC)])

    pos, types, charges = [], [], []
    cidx = []  # atom index of carbon k
    for i in range(nC):
        end = i == 0 or i == nC - 1
        cidx.append(len(pos))
        pos.append(cpos[i])
        types.append(0 if end else 1)
        charges.append(-0.18 if end else -0.12)
        # unit directions: bisector of the backbone angle (pointing away)
        # and the out-of-plane normal
        if i == 0:
            axis = cpos[1] - cpos[0]
        elif i == nC - 1:
            axis = cpos[nC - 2] - cpos[nC - 1]
        else:
            axis = None
        if end:
            # 3 H staggered around the C-C axis at tetrahedral angle
            a = axis / np.linalg.norm(axis)
            perp1 = np.cross(a, [0.0, 1.0, 0.0])
            perp1 /= np.linalg.norm(perp1)
            perp2 = np.cross(a, perp1)
            th = np.deg2rad(180.0 - 109.47)
            for k in range(3):
                phi = 2.0 * np.pi * k / 3.0
                d = (np.cos(th) * (-a)
                     + np.sin(th) * (np.cos(phi) * perp1 + np.sin(phi) * perp2))
                pos.append(cpos[i] + rCH * d)
                types.append(2)
                charges.append(0.06)
        else:
            b1 = cpos[i - 1] - cpos[i]
            b2 = cpos[i + 1] - cpos[i]
            bis = -(b1 / np.linalg.norm(b1) + b2 / np.linalg.norm(b2))
            bis /= np.linalg.norm(bis)
            nrm = np.cross(b1, b2)
            nrm /= np.linalg.norm(nrm)
            for s in (+1.0, -1.0):
                d = np.cos(thHCH / 2.0) * bis + s * np.sin(thHCH / 2.0) * nrm
                pos.append(cpos[i] + rCH * d)
                types.append(2)
                charges.append(0.06)
    pos = np.asarray(pos)
    n = len(pos)

    # topology: bond types 0 = C-C, 1 = C-H; angle types 0 = CCC,
    # 1 = CCH, 2 = HCH; dihedral types 0 = CCCC, 1 = XCCH/HCCH
    bonds, btyp = [], []
    angles, atyp = [], []
    dihedrals, dtyp = [], []
    hyd = [[] for _ in range(nC)]
    for i in range(nC):
        nh = 3 if (i == 0 or i == nC - 1) else 2
        hyd[i] = [cidx[i] + 1 + k for k in range(nh)]
        for hj in hyd[i]:
            bonds.append([cidx[i], hj])
            btyp.append(1)
        if i + 1 < nC:
            bonds.append([cidx[i], cidx[i + 1]])
            btyp.append(0)
    for i in range(nC):
        neigh = []
        if i > 0:
            neigh.append(cidx[i - 1])
        if i + 1 < nC:
            neigh.append(cidx[i + 1])
        part = neigh + hyd[i]
        for a in range(len(part)):
            for b in range(a + 1, len(part)):
                angles.append([part[a], cidx[i], part[b]])
                ca = part[a] in neigh
                cb = part[b] in neigh
                atyp.append(0 if (ca and cb) else (1 if (ca or cb) else 2))
    for i in range(nC - 1):
        # dihedrals around bond C_i - C_{i+1}
        left = ([cidx[i - 1]] if i > 0 else []) + hyd[i]
        right = ([cidx[i + 2]] if i + 2 < nC else []) + hyd[i + 1]
        for a in left:
            for b in right:
                dihedrals.append([a, cidx[i], cidx[i + 1], b])
                dtyp.append(0 if (a in cidx and b in cidx) else 1)

    return MolecularData(
        masses=np.array([12.011, 12.011, 1.008]),
        pos=pos,
        vel=None,
        types=np.asarray(types, dtype=np.int32),
        charges=np.asarray(charges),
        box=np.eye(3) * 100.0,  # placeholder; the melt builder sets it
        pair_coeffs=np.array([[0.066, 3.50], [0.066, 3.50], [0.030, 2.50]]),
        bonds=np.asarray(bonds, dtype=np.int32),
        bond_types=np.asarray(btyp, dtype=np.int32),
        bond_coeffs=np.array([[268.0, 1.529], [340.0, 1.09]]),
        angles=np.asarray(angles, dtype=np.int32),
        angle_types=np.asarray(atyp, dtype=np.int32),
        angle_coeffs=np.array([[58.35, 112.7], [37.5, 110.7], [33.0, 107.8]]),
        dihedrals=np.asarray(dihedrals, dtype=np.int32),
        dihedral_types=np.asarray(dtyp, dtype=np.int32),
        dihedral_coeffs=np.array([[1.3, -0.05, 0.2, 0.0],
                                  [0.0, 0.0, 0.3, 0.0]]),
    )


def build_pe_melt_allatom(
    n_chains: int = 72,
    n_carbons: int = 10,
    density: float = 0.70,
) -> MolecularData:
    """An all-atom PE melt (charged, H-bearing) — the reference's actual
    OPLS-material class (lj/cut/coul/long + pppm + SHAKE on H).  The
    default 72 x C10H22 = 2304 atoms starts in a ~27.1 A box; even after
    NPT densification to ~0.85 g/cm^3 the box stays above 2x the 12 A LJ
    cutoff (the all-pairs kernel's min-image requirement — and
    LAMMPS's own)."""
    mass_chain = 12.011 * n_carbons + 1.008 * (2 * n_carbons + 2)
    vol = n_chains * mass_chain / (density * 0.6022140857)
    L = vol ** (1.0 / 3.0)

    # grid: pick the x-axis chain count so one chain spans one cell, then
    # factor the cross-section as square as possible
    span_x = (n_carbons - 1) * 1.529 * np.sin(np.deg2rad(112.7) / 2.0) + 2.6
    nx = max(1, int(round(L / (span_x + 0.4))))
    while n_chains % nx:
        nx -= 1
    rem = n_chains // nx
    ny = int(round(rem**0.5))
    while rem % ny:
        ny -= 1
    nz = rem // ny
    pitch = np.array([L / nx, L / ny, L / nz])

    # the backbone is compacted to fit the x pitch while the hydrogens
    # keep exact C-H geometry (the staged heatup/cooldown equilibration
    # decorrelates the initial alignment)
    scale = min(1.0, 0.88 * pitch[0] / span_x)
    single = build_pe_chain_allatom(n_carbons, backbone_scale=scale)
    chain_local = single.pos - single.pos.mean(axis=0)

    pos, types, charges = [], [], []
    bonds, btyp, angles, atyp, dihedrals, dtyp = [], [], [], [], [], []
    for cz in range(nz):
        for cy in range(ny):
            for cx in range(nx):
                base = len(pos)
                off = (np.array([cx, cy, cz]) + 0.5) * pitch
                pos.extend(chain_local + off)
                types.extend(single.types)
                charges.extend(single.charges)
                bonds.extend(single.bonds + base)
                btyp.extend(single.bond_types)
                angles.extend(single.angles + base)
                atyp.extend(single.angle_types)
                dihedrals.extend(single.dihedrals + base)
                dtyp.extend(single.dihedral_types)

    return MolecularData(
        masses=single.masses,
        pos=np.asarray(pos),
        vel=None,
        types=np.asarray(types, dtype=np.int32),
        charges=np.asarray(charges),
        box=np.eye(3) * L,
        pair_coeffs=single.pair_coeffs,
        bonds=np.asarray(bonds, dtype=np.int32),
        bond_types=np.asarray(btyp, dtype=np.int32),
        bond_coeffs=single.bond_coeffs,
        angles=np.asarray(angles, dtype=np.int32),
        angle_types=np.asarray(atyp, dtype=np.int32),
        angle_coeffs=single.angle_coeffs,
        dihedrals=np.asarray(dihedrals, dtype=np.int32),
        dihedral_types=np.asarray(dtyp, dtype=np.int32),
        dihedral_coeffs=single.dihedral_coeffs,
    )


def write_lammpstrj(path: str, pos, h, types=None, timestep: int = 0,
                    append: bool = False, vel=None,
                    style: str = "atom") -> None:
    """LAMMPS trajectory frame (the reference's optional homogenization
    dumps, stmd_problem.h:313-317) — readable by OVITO/VMD.

    ``style="custom_scaled"`` writes the reference's microstate-dump
    column set instead: ``id type xs ys zs vx vy vz ix iy iz``
    (stmd_problem.h:262 ``write_dump all custom ...``) with coordinates
    scaled to the box; image flags are zero because positions here are
    already unwrapped."""
    pos = np.asarray(pos)
    h = np.asarray(h)
    n = len(pos)
    if types is None:
        # zero-based internal types; the writer prints type+1 (LAMMPS
        # 1-based), so the single-type default must be 0, not 1
        types = np.zeros(n, dtype=int)
    mode = "a" if append else "w"
    with open(path, mode) as f:
        f.write("ITEM: TIMESTEP\n%d\n" % timestep)
        f.write("ITEM: NUMBER OF ATOMS\n%d\n" % n)
        f.write("ITEM: BOX BOUNDS xy xz yz pp pp pp\n")
        xy, xz, yz = h[0, 1], h[0, 2], h[1, 2]
        xlo = min(0.0, xy, xz, xy + xz)
        xhi = h[0, 0] + max(0.0, xy, xz, xy + xz)
        f.write(f"{xlo:.8g} {xhi:.8g} {xy:.8g}\n")
        f.write(f"{min(0.0, yz):.8g} {h[1, 1] + max(0.0, yz):.8g} {xz:.8g}\n")
        f.write(f"0.0 {h[2, 2]:.8g} {yz:.8g}\n")
        if style == "custom_scaled":
            vel = np.zeros_like(pos) if vel is None else np.asarray(vel)
            # fractional coordinates: pos = s @ h^T (row-vector upper-
            # triangular box convention used throughout md/box.py)
            s = pos @ np.linalg.inv(h.T)
            f.write("ITEM: ATOMS id type xs ys zs vx vy vz ix iy iz\n")
            for i in range(n):
                f.write(f"{i + 1} {int(types[i]) + 1} "
                        f"{s[i, 0]:.10g} {s[i, 1]:.10g} {s[i, 2]:.10g} "
                        f"{vel[i, 0]:.10g} {vel[i, 1]:.10g} {vel[i, 2]:.10g} "
                        f"0 0 0\n")
            return
        f.write("ITEM: ATOMS id type x y z\n")
        for i in range(n):
            f.write(f"{i + 1} {int(types[i]) + 1} "
                    f"{pos[i, 0]:.8g} {pos[i, 1]:.8g} {pos[i, 2]:.8g}\n")


def read_lammps_dump(path: str):
    """Parse a LAMMPS text dump frame (the reference's
    ``last.<qpid>.<mat>_<r>.dump`` microstate dumps, written by
    stmd_problem.h:262 as ``id type xs ys zs vx vy vz ix iy iz`` and
    re-read by anmd_problem.h:100-179 via ``rerun``).

    Handles both scaled (xs ys zs) and unscaled (x y z) coordinate
    columns, optional velocities, and image flags (unwrapped as
    pos += image @ h^T).  Returns a dict with keys
    ``pos`` (n,3) A, ``vel`` (n,3), ``h`` (3,3) upper-triangular box,
    ``types`` (n,) zero-based, ``timestep`` int — the last frame if the
    file holds several."""
    frames = []
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        if not lines[i].startswith("ITEM: TIMESTEP"):
            i += 1
            continue
        timestep = int(lines[i + 1].split()[0])
        assert lines[i + 2].startswith("ITEM: NUMBER OF ATOMS")
        n = int(lines[i + 3].split()[0])
        assert lines[i + 4].startswith("ITEM: BOX BOUNDS")
        triclinic = "xy" in lines[i + 4]
        rows = [
            [float(v) for v in lines[i + 5 + k].split()] for k in range(3)
        ]
        if triclinic:
            (xlo_b, xhi_b, xy), (ylo_b, yhi_b, xz), (zlo, zhi, yz) = rows
            # invert LAMMPS's bounding-box convention (the writer above /
            # the LAMMPS docs): recover the true cell edges
            xlo = xlo_b - min(0.0, xy, xz, xy + xz)
            xhi = xhi_b - max(0.0, xy, xz, xy + xz)
            ylo = ylo_b - min(0.0, yz)
            yhi = yhi_b - max(0.0, yz)
        else:
            (xlo, xhi), (ylo, yhi), (zlo, zhi) = [r[:2] for r in rows]
            xy = xz = yz = 0.0
        h = np.array([[xhi - xlo, xy, xz],
                      [0.0, yhi - ylo, yz],
                      [0.0, 0.0, zhi - zlo]])
        hdr = lines[i + 8].split()
        assert hdr[:2] == ["ITEM:", "ATOMS"], hdr
        cols = hdr[2:]
        col = {c: k for k, c in enumerate(cols)}
        scaled = "xs" in col
        data = np.array(
            [[float(v) for v in lines[i + 9 + k].split()] for k in range(n)]
        )
        # dumps are not id-sorted in general: restore atom order
        order = np.argsort(data[:, col["id"]].astype(int)) if "id" in col \
            else np.arange(n)
        data = data[order]
        if scaled:
            s = data[:, [col["xs"], col["ys"], col["zs"]]]
            pos = s @ h.T
        else:
            pos = data[:, [col["x"], col["y"], col["z"]]]
            pos = pos - np.array([xlo, ylo, zlo])
        if {"ix", "iy", "iz"} <= set(col):
            img = data[:, [col["ix"], col["iy"], col["iz"]]]
            pos = pos + img @ h.T
        vel = (data[:, [col["vx"], col["vy"], col["vz"]]]
               if "vx" in col else np.zeros_like(pos))
        types = (data[:, col["type"]].astype(int) - 1
                 if "type" in col else np.zeros(n, dtype=int))
        frames.append(dict(pos=pos, vel=vel, h=h, types=types,
                           timestep=timestep))
        i = i + 9 + n
    if not frames:
        raise ValueError(f"no dump frames found in {path}")
    return frames[-1]


def to_opls(data: MolecularData, lj_cutoff: float = 12.0, coul_cutoff: float = 9.0,
            use_ewald: bool = True, dtype=None, device=None, kspace: str = "auto"):
    """OPLS parameter tables (``forcefields.opls.OPLS``) from MolecularData:
    geometric-mixed LJ epsilon/sigma, bonded coefficients, the
    special-bonds exclusion lists (``special_lj`` = (0, 0, 0)) and, for a
    charged system with ``use_ewald``, the k-space object: ``kspace`` =
    'ewald' (dense reciprocal sum), 'pme' (FFT mesh, the reference's
    ``kspace_style pppm``) or 'auto' (dense below 2048 atoms, PME above).
    Without it the Coulomb term is plain cutoff (coul/cut)."""
    import torch

    from .forcefields import opls as O
    from .forcefields.coulomb import Ewald
    from .forcefields.pme import PME

    dtype = dtype or torch.float64
    ewald = None
    if use_ewald and np.abs(data.charges).max() > 0:
        use_pme = kspace == "pme" or (kspace == "auto" and len(data.pos) >= 2048)
        maker = PME if use_pme else Ewald
        ewald = maker.create(data.charges, coul_cutoff, data.box, dtype=dtype, device=device)

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                               device=device)

    def col(coeffs, k, fallback):
        return coeffs[:, k] if len(coeffs) else np.asarray(fallback)

    eps, sig = O.mix_geometric(t(data.pair_coeffs[:, 0]), t(data.pair_coeffs[:, 1]))
    return O.OPLS(
        types=torch.as_tensor(data.types, dtype=torch.int64, device=device),
        charges=t(data.charges),
        lj_epsilon=eps, lj_sigma=sig,
        lj_cutoff=lj_cutoff, coul_cutoff=coul_cutoff,
        bonds=np.asarray(data.bonds), bond_type=np.asarray(data.bond_types),
        angles=np.asarray(data.angles), angle_type=np.asarray(data.angle_types),
        dihedrals=np.asarray(data.dihedrals),
        dihedral_type=np.asarray(data.dihedral_types),
        impropers=np.asarray(data.impropers),
        bond_k=t(col(data.bond_coeffs, 0, [0.0])),
        bond_r0=t(col(data.bond_coeffs, 1, [0.0])),
        angle_k=t(col(data.angle_coeffs, 0, [0.0])),
        angle_theta0=t(np.deg2rad(col(data.angle_coeffs, 1, [0.0]))),
        dihedral_k=t(data.dihedral_coeffs if len(data.dihedral_coeffs)
                     else np.zeros((1, 4))),
        excl=O.build_exclusions(len(data.pos), data.bonds),
        ewald=ewald,
        improper_type=np.asarray(data.improper_types),
        improper_k=t(col(data.improper_coeffs, 0, [0.0])),
        improper_chi0=t(np.deg2rad(col(data.improper_coeffs, 1, [0.0]))),
    )
