"""Writers of the input files the port reads, for tests and chip_smoke.py
(the repository ships no such file):

* :func:`write_data` — a ``read_data`` text file (atom_style full) of a
  ``data_io.MolecularData``, every float as its shortest exact repr, so
  that ``read_data`` gives back the same arrays bit for bit
  (:func:`with_impropers` adds impropers to a melt of chains,
  :func:`with_types` spreads its atoms over many atom types);
* :func:`write_restart` — a native binary restart in the layout
  ``md/lammps_restart.read_restart`` decodes (the "17 Nov 2016" format of
  the reference's ``init.<mat>_<n>.bin``): the magic, the endian and
  version words, the header fields the reader needs (version, units
  ``metal``, timestep, atom_style ``atomic``, natoms, ntypes, triclinic,
  box bounds, tilts), a masses section, then one block of per-atom
  ``atomic`` records [11, x, y, z, tag, type, mask, image, vx, vy, vz]
  with the four integers as int64 bit patterns and the image counts
  packed in 10-bit fields around 512;
* :func:`write_keras_surrogate` — the reference's Keras surrogate and
  its MinMaxScaler pickle (``surrogate_model/``), from given weights;
* :func:`write_ct_msh` — a GMSH v2 ASCII hex mesh of a compact-tension
  half specimen (the geometry ``problem_types.make_compact_tension``
  loads: W = 2 calculi_B, a pin hole of diameter 0.25 W about (W, 0.275 W),
  y >= 0) with nodes on the hole's upper half ring, on y = 0 and on z = 0;
* :func:`write_ffield` — a synthetic H/C/N/O ReaxFF parameter file in the
  published CHO layout (not ffield.reax.2, whose parameters the repository
  does not hold): both packages' ``parse_ffield`` read it, and its
  numbers give finite, stable dynamics of the all-atom PE melt, not
  chemistry.

Neither package has these writers; they exist only to make test inputs.
"""
import struct

import numpy as np

MAGIC = b"LammpS RestartT\x00"


def _f(x) -> str:
    return repr(float(x))


def write_data(path, data, title: str = "written by tests/torch_file_util.py") -> None:
    """``data`` (a MolecularData of either package) as a LAMMPS data file."""
    n = len(data.pos)
    h = np.asarray(data.box, dtype=np.float64)
    terms = [("bonds", "Bonds", data.bonds, data.bond_types, data.bond_coeffs, "bond"),
             ("angles", "Angles", data.angles, data.angle_types, data.angle_coeffs, "angle"),
             ("dihedrals", "Dihedrals", data.dihedrals, data.dihedral_types,
              data.dihedral_coeffs, "dihedral"),
             ("impropers", "Impropers", data.impropers, data.improper_types,
              data.improper_coeffs, "improper")]
    out = [title, "", f"{n} atoms"]
    out += [f"{len(idx)} {word}" for word, _, idx, _, _, _ in terms if len(idx)]
    out.append(f"{len(data.masses)} atom types")
    out += [f"{len(c)} {kind} types" for _, _, idx, _, c, kind in terms if len(idx)]
    out += [f"0.0 {_f(h[0, 0])} xlo xhi", f"0.0 {_f(h[1, 1])} ylo yhi",
            f"0.0 {_f(h[2, 2])} zlo zhi"]
    if h[0, 1] or h[0, 2] or h[1, 2]:
        out.append(f"{_f(h[0, 1])} {_f(h[0, 2])} {_f(h[1, 2])} xy xz yz")
    out += ["", "Masses", ""] + [f"{t + 1} {_f(m)}" for t, m in enumerate(data.masses)]
    out += ["", "Pair Coeffs", ""] + [f"{t + 1} " + " ".join(map(_f, c))
                                      for t, c in enumerate(data.pair_coeffs)]
    for _, _, idx, _, coeffs, kind in terms:
        if len(idx):
            out += ["", f"{kind.capitalize()} Coeffs", ""]
            out += [f"{t + 1} " + " ".join(map(_f, c)) for t, c in enumerate(coeffs)]
    out += ["", "Atoms # full", ""]
    out += [f"{i + 1} 1 {int(data.types[i]) + 1} {_f(data.charges[i])} "
            + " ".join(map(_f, data.pos[i])) for i in range(n)]
    if data.vel is not None:
        out += ["", "Velocities", ""] + [f"{i + 1} " + " ".join(map(_f, data.vel[i]))
                                         for i in range(n)]
    for _, section, idx, types, _, _ in terms:
        if len(idx):
            out += ["", section, ""]
            out += [f"{k + 1} {int(t) + 1} " + " ".join(str(int(a) + 1) for a in row)
                    for k, (row, t) in enumerate(zip(idx, types))]
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def with_impropers(data, chain_length: int, k: float = 2.0, chi0: float = 10.0):
    """``data`` (chains of ``chain_length`` consecutive beads) with one
    harmonic improper (K kcal/mol/rad^2, chi0 degrees) per interior bead
    triple of each chain: beads j+1, j, j+2, j+3, an angle near 0 on the
    built zigzag, far from the +-180 degree cut."""
    import dataclasses

    quads = np.array([[b + j + 1, b + j, b + j + 2, b + j + 3]
                      for b in range(0, len(data.pos), chain_length)
                      for j in range(chain_length - 3)], np.int32)
    return dataclasses.replace(data, impropers=quads,
                               improper_types=np.zeros(len(quads), np.int32),
                               improper_coeffs=np.array([[k, chi0]]))


def with_types(data, n_types: int):
    """``data`` with its atoms spread over ``n_types`` atom types (atom i
    takes type i mod n_types), each with its own mass and LJ pair
    coefficients a little apart from the first type's: a box of many types
    for the kernels' type tables, the same melt otherwise."""
    import dataclasses

    t = np.arange(n_types)
    m0, (eps0, sig0) = float(data.masses[0]), data.pair_coeffs[0]
    return dataclasses.replace(
        data, types=(np.arange(len(data.pos)) % n_types).astype(np.int32),
        masses=m0 + 1e-3 * t,
        pair_coeffs=np.stack([eps0 * (1.0 + 1e-3 * t), sig0 * (1.0 + 1e-4 * t)], axis=1))


def write_keras_surrogate(directory, kernels, biases, scale=None, min_=None) -> None:
    """The reference's surrogate files in ``directory``:
    ``model_small_uniaxial.bin``, a Keras-2 HDF5 save of a Sequential
    Dense stack (``model_weights`` with the ``layer_names`` and each
    layer's ``weight_names`` attributes, kernels (in, out)), and, with
    ``scale``, ``scaler.pkl``, a pickled sklearn MinMaxScaler (its
    ``scale_`` and ``min_``) written without sklearn: the pickle names
    sklearn's class for a stand-in's."""
    import os
    import pickle

    import h5py

    with h5py.File(os.path.join(directory, "model_small_uniaxial.bin"), "w") as f:
        g = f.create_group("model_weights")
        names = ["dense"] + [f"dense_{i}" for i in range(1, len(kernels))]
        g.attrs["layer_names"] = [n.encode() for n in names]
        for name, k, b in zip(names, kernels, biases):
            lg = g.create_group(name)
            lg.attrs["weight_names"] = [f"{name}/kernel:0".encode(), f"{name}/bias:0".encode()]
            lg[f"{name}/kernel:0"] = np.asarray(k, np.float32)
            lg[f"{name}/bias:0"] = np.asarray(b, np.float32)
    if scale is None:
        return
    cls = type("MinMaxScaler", (), {})
    obj = cls()
    obj.__dict__.update(feature_range=(0, 1), copy=True, n_features_in_=len(scale),
                        scale_=np.asarray(scale, np.float64),
                        min_=np.asarray(min_, np.float64))

    class Pickler(pickle._Pickler):
        def save_global(self, o, name=None):
            if o is not cls:
                return super().save_global(o, name)
            self.write(pickle.GLOBAL + b"sklearn.preprocessing._data\nMinMaxScaler\n")
            self.memoize(o)

    with open(os.path.join(directory, "scaler.pkl"), "wb") as f:
        Pickler(f, protocol=3).dump(obj)


def _i(v: int) -> bytes:
    return struct.pack("<i", v)


def _string(flag: int, s: str) -> bytes:
    b = s.encode() + b"\x00"
    return _i(flag) + _i(len(b)) + b


def _doubles(flag: int, v) -> bytes:
    return _i(flag) + _i(len(v)) + struct.pack(f"<{len(v)}d", *map(float, v))


def write_restart(path, pos, vel, boxlo, boxhi, types=None, image=None, tilt=(0.0, 0.0, 0.0),
                  timestep: int = 0, masses=(28.0855,), order=None) -> None:
    """A binary restart of N atoms: ``pos`` (N, 3) the wrapped positions
    LAMMPS stores (the reader adds ``image`` times the box lengths),
    ``vel`` (N, 3), ``types`` (N,) 0-based (all 0 by default), ``image``
    (N, 3) int counts (0 by default), written in the record order
    ``order`` (a permutation of the tags 1..N; tag order by default)."""
    pos, vel = np.asarray(pos, np.float64), np.asarray(vel, np.float64)
    n = len(pos)
    types = np.zeros(n, np.int64) if types is None else np.asarray(types, np.int64)
    image = np.zeros((n, 3), np.int64) if image is None else np.asarray(image, np.int64)
    order = np.arange(n) if order is None else np.asarray(order)
    head = MAGIC + _i(1) + _i(0)
    head += _string(0, "17 Nov 2016")
    head += _string(4, "metal")
    head += _i(5) + struct.pack("<q", timestep)
    head += _string(15, "atomic") + _i(0)  # the style's trailing settings word
    head += _i(16) + struct.pack("<q", n)
    head += _i(17) + _i(len(masses))
    head += _i(30) + _i(int(any(tilt)))
    head += _doubles(31, boxlo) + _doubles(32, boxhi)
    for flag, t in zip((33, 34, 35), tilt):
        head += _i(flag) + struct.pack("<d", float(t))
    head += _i(-1)
    head += _i(1) + _i(len(masses)) + struct.pack(f"<{len(masses)}d", *masses)  # masses
    rec = np.zeros((n, 11), np.float64)
    rec[:, 0] = 11.0
    rec[:, 1:4] = pos
    rec[:, 8:11] = vel
    ints = np.zeros((n, 4), np.int64)
    ints[:, 0] = np.arange(1, n + 1)
    ints[:, 1] = types + 1
    ints[:, 2] = 1
    ints[:, 3] = ((image[:, 0] + 512) | ((image[:, 1] + 512) << 10)
                  | ((image[:, 2] + 512) << 20))
    rec[:, 4:8] = ints.view(np.float64)
    rec = rec[order]
    with open(path, "wb") as f:
        f.write(head + _i(n * 11) + rec.astype("<f8").tobytes())


def write_ct_msh(path, calculi_b: float, n_layers: int = 2, thickness: float | None = None,
                 n_radial: int = 2, n_left: int = 4) -> int:
    """A compact-tension hex mesh of (24 + 3 ``n_left``) x ``n_layers``
    cells: an O-grid of 4 sides x 3 segments x ``n_radial`` layers between
    the pin hole (radius 0.125 W about (W, 0.275 W)) and the square
    [0.725 W, 1.275 W] x [0, 0.55 W], and a block of ``n_left`` x 3 cells
    over x in [0, 0.725 W] beside it, extruded over z in [0, ``thickness``]
    (0.5 calculi_B by default).  The file also holds quads of the z = 0 face
    (GMSH type 3, which the readers skip) and one node no hex uses (which
    they drop), and numbers its nodes from 11 in steps of 2.  Returns the
    number of hexes."""
    ww = 2.0 * calculi_b
    cx, cy = ww, 0.275 * ww
    rad, a = 0.125 * ww, cy
    t = 0.5 * calculi_b if thickness is None else thickness
    nodes, key_of = [], {}

    def nid(x, y):
        k = (round(x / ww * 1e9), round(y / ww * 1e9))
        if k not in key_of:
            key_of[k] = len(nodes)
            nodes.append((x, y))
        return key_of[k]

    # the square's boundary, counterclockwise from its lower right corner
    ts = [1.0, 1.0 / 3.0, -1.0 / 3.0]
    square = ([(cx + a, cy - a * s) for s in ts] + [(cx + a * s, cy + a) for s in ts]
              + [(cx - a, cy + a * s) for s in ts] + [(cx - a * s, cy - a) for s in ts])
    rings = []
    for px, py in square:
        d = np.hypot(px - cx, py - cy)
        rx, ry = cx + rad * (px - cx) / d, cy + rad * (py - cy) / d
        rings.append([nid(rx + (px - rx) * k / n_radial, ry + (py - ry) * k / n_radial)
                      if k < n_radial else nid(px, py) for k in range(n_radial + 1)])
    quads = []
    for s in range(len(square)):
        r0, r1 = rings[s], rings[(s + 1) % len(square)]
        quads += [(r0[k], r0[k + 1], r1[k + 1], r1[k]) for k in range(n_radial)]
    xs = np.linspace(0.0, cx - a, n_left + 1)
    ys = [cy - a, cy - a / 3.0, cy + a / 3.0, cy + a]  # the square's left side
    for j in range(3):
        for i in range(n_left):
            quads.append((nid(xs[i], ys[j]), nid(xs[i + 1], ys[j]),
                          nid(xs[i + 1], ys[j + 1]), nid(xs[i], ys[j + 1])))
    xy = np.asarray(nodes)

    def ccw(q):
        p = xy[list(q)]
        area = np.sum(p[:, 0] * np.roll(p[:, 1], -1) - np.roll(p[:, 0], -1) * p[:, 1])
        return q if area > 0 else q[::-1]

    quads = [ccw(q) for q in quads]
    n2 = len(nodes)
    zs = np.linspace(0.0, t, n_layers + 1)
    gid = lambda i: 11 + 2 * i  # noqa: E731
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes",
             str(n2 * (n_layers + 1) + 1)]
    for l, z in enumerate(zs):
        lines += [f"{gid(l * n2 + i)} {_f(x)} {_f(y)} {_f(z)}" for i, (x, y) in enumerate(nodes)]
    lines.append(f"{gid(n2 * (n_layers + 1))} {_f(cx)} {_f(cy)} 0.0")  # inside the hole: unused
    elems = ["3 2 1 1 " + " ".join(str(gid(v)) for v in q) for q in quads]
    for l in range(n_layers):
        elems += ["5 2 1 2 " + " ".join(str(gid(l * n2 + v)) for v in q) + " "
                  + " ".join(str(gid((l + 1) * n2 + v)) for v in q) for q in quads]
    lines += ["$EndNodes", "$Elements", str(len(elems))]
    lines += [f"{k + 1} {e}" for k, e in enumerate(elems)]
    lines.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(quads) * n_layers


# the synthetic parameter file of write_ffield: 39 general parameters, C, H,
# O and N atom blocks, six bonds (none with N), one off-diagonal row, six
# angles, four torsions, one hydrogen bond
SYNTHETIC_FFIELD = """\
Synthetic C/H/O/N ReaxFF parameters (published CHO form; not ffield.reax.2)
 39       ! Number of general parameters
   50.0000 !Overcoordination parameter
    9.5469 !Overcoordination parameter
   26.5405 !Valency angle conjugation parameter
    1.7224 !Triple bond stabilisation parameter
    6.8702 !Triple bond stabilisation parameter
    0.0000 !C2-correction
    1.0588 !Undercoordination parameter
    4.6000 !Triple bond stabilisation parameter
   12.1176 !Undercoordination parameter
   13.3056 !Undercoordination parameter
    0.0000 !Triple bond stabilization energy
    0.0000 !Lower Taper-radius
   10.0000 !Upper Taper-radius
    2.8793 !Not used
   33.8667 !Valency undercoordination
    6.0891 !Valency angle/lone pair parameter
    1.0563 !Valency angle
    2.0384 !Valency angle parameter
    6.1431 !Not used
    6.9290 !Double bond/angle parameter
    0.3989 !Double bond/angle parameter: overcoord
    3.9954 !Double bond/angle parameter: overcoord
   -2.4837 !Not used
    5.7796 !Torsion/BO parameter
   10.0000 !Torsion overcoordination
    1.9487 !Torsion overcoordination
   -1.2327 !Conjugation 0 (not used)
    2.1645 !Conjugation
    1.5591 !vdWaals shielding
    0.1000 !Cutoff for bond order (*100)
    2.1365 !Valency angle conjugation parameter
    0.6991 !Overcoordination parameter
   50.0000 !Overcoordination parameter
    1.8512 !Valency/lone pair parameter
    0.5000 !Not used
   20.0000 !Not used
    5.0000 !Molecular energy (not used)
    0.0000 !Molecular energy (not used)
    2.6962 !Valency angle conjugation parameter
  4    ! Nr of atoms; cov.r; valency;a.m;Rvdw;Evdw;gammaEEM;cov.r2;#
            alfa;gammavdW;valency;Eunder;Eover;chiEEM;etaEEM;n.u.
            cov r3;Elp;Heat inc.;n.u.;n.u.;n.u.;n.u.
            ov/un;val1;n.u.;val3,vval4
 C    1.3817   4.0000  12.0000   1.8903   0.1838   0.9000   1.1341   4.0000
      9.7559   2.1346   4.0000  34.9350  79.5548   5.9666   7.0000   0.0000
      1.2114   0.0000 202.5551   8.9539  34.9289  13.5366   0.8563   0.0000
     -2.8983   2.5000   1.0564   4.0000   2.9663   0.0000   0.0000   0.0000
 H    0.8930   1.0000   1.0080   1.3550   0.0930   0.8203  -0.1000   1.0000
      8.2230  33.2894   1.0000   0.0000 121.1250   3.7248   9.6093   1.0000
     -0.1000   0.0000  61.6606   3.0408   2.4197   0.0003   1.0698   0.0000
    -19.4571   4.2733   1.0338   1.0000   2.8793   0.0000   0.0000   0.0000
 O    1.2450   2.0000  15.9990   2.3890   0.1000   1.0898   1.0548   6.0000
      9.7300  13.8449   4.0000  37.5000 116.0768   8.5000   8.3122   2.0000
      0.9049   0.4056  59.0626   3.5027   0.7640   0.0021   0.9745   0.0000
     -3.5500   2.9000   1.0493   4.0000   2.9225   0.0000   0.0000   0.0000
 N    1.2333   3.0000  14.0000   1.9324   0.1376   0.8596   1.1748   5.0000
     10.0667   7.8431   4.0000  32.2482 100.0000   6.7529   6.4292   2.0000
      1.0433  13.7673 119.9837   2.1961   3.0696   2.7683   0.9745   0.0000
     -4.3875   2.6192   1.0183   4.0000   2.8793   0.0000   0.0000   0.0000
  6      ! Nr of bonds; Edis1;LPpen;n.u.;pbe1;pbo5;13corr;pbo6
                         pbe2;pbo3;pbo4;n.u.;pbo1;pbo2;ovcorr
  1  1 158.2004  99.1897  78.0000  -0.7738  -0.4550   1.0000  37.6117   0.4147
         0.4590  -0.1000   9.1628   1.0000  -0.0777   6.7268   1.0000   0.0000
  1  2 169.4760   0.0000   0.0000  -0.6083   0.0000   1.0000   6.0000   0.7652
         5.2290   1.0000   0.0000   1.0000  -0.0500   6.9136   0.0000   0.0000
  2  2 153.3934   0.0000   0.0000  -0.4600   0.0000   1.0000   6.0000   0.7300
         6.2500   1.0000   0.0000   1.0000  -0.0790   6.0552   0.0000   0.0000
  3  3 142.2858 145.0000  50.8293   0.2506  -0.1000   1.0000  29.7503   0.6051
         0.3451  -0.1055   9.0000   1.0000  -0.1225   5.5000   1.0000   0.0000
  2  3 160.0000   0.0000   0.0000  -0.5725   0.0000   1.0000   6.0000   0.5626
         1.1150   1.0000   0.0000   0.0000  -0.0920   4.2790   0.0000   0.0000
  1  3 164.4303  82.6772  60.8077  -0.3739  -0.2351   1.0000  10.5036   1.0000
         0.4475  -0.2288   7.0250   1.0000  -0.1363   4.8734   0.0000   0.0000
  1      ! Nr of off-diagonal terms; Ediss;Ro;gamma;rsigma;rpi;rpi2
  1  2   0.1239   1.4004   9.8467   1.1210  -1.0000  -1.0000
  6      ! Nr of angles;at1;at2;at3;Thetao,o;ka;kb;pv1;pv2
  1  1  1  59.0573  30.7029   0.7606   0.0000   0.7180   6.2933   1.1244
  1  1  2  65.7758  14.5234   6.2481   0.0000   0.5665   0.0000   1.6255
  2  1  2  70.2607  25.2202   3.7312   0.0000   0.0050   0.0000   2.7500
  1  2  2   0.0000   0.0000   6.0000   0.0000   0.0000   0.0000   1.0400
  2  3  2  85.8000   9.8453   2.2720   0.0000   2.8635   0.0000   1.5800
  2  2  2   0.0000  27.9213   5.8635   0.0000   0.0000   0.0000   1.0400
  4      ! Nr of torsions;at1;at2;at3;at4;;V1;V2;V3;V2(BO);vconj;n.u;n
  1  1  1  1  -0.2500  34.7453   0.0288  -6.3507  -1.6000   0.0000   0.0000
  1  1  1  2  -0.2500  29.2131   0.2945  -4.9581  -2.1802   0.0000   0.0000
  2  1  1  2  -0.2500  31.2081   0.4539  -4.8923  -2.2677   0.0000   0.0000
  0  1  2  0   0.0000   0.0000   0.0000   0.0000   0.0000   0.0000   0.0000
  1      ! Nr of hydrogen bonds;at1;at2;at3;Rhb;Dehb;vhb1
  3  2  3   2.1200  -3.5800   1.4500  19.5000
"""


def write_ffield(path) -> None:
    """Write the synthetic H/C/N/O ReaxFF parameter file to ``path`` (a
    ``ffield.reax*`` name lets ``config.reax_ffield_path`` find it in a
    ``lammps_scripts_reax`` directory)."""
    with open(path, "w") as f:
        f.write(SYNTHETIC_FFIELD)
