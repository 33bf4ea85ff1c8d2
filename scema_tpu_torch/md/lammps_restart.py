"""Reader for LAMMPS native binary restart files (``init.<mat>_<n>.bin``).

A copy of ``scema_tpu/md/lammps_restart.py``: the same code (it imports
only ``struct``, ``dataclasses`` and numpy), with this paragraph added.

The reference loads per-replica equilibrated microstates from LAMMPS
binary restarts (stmd_sync.h:361-453 passes them to ``read_restart``;
init_material writes them via ``write_restart``, stmd_problem.h:185-207).
The shipped example's ``init.sic_1.bin`` is the "17 Nov 2016"-era format:

    magic "LammpS RestartT\\0" | endian int | version-numeric int
    header fields: (flag int, payload) pairs, -1 terminated
      - strings as (flag, nbytes, bytes)
      - vectors as (flag, count, values)
      - the enum is the PRE-imageint layout (TAGINT=2, BIGINT=3,
        UNITS=4, ... BOUNDARY=14, ATOM_STYLE=15, NATOMS=16, ...),
        with IMAGEINT APPENDED at the end (flag 48) for compatibility
    then type-array / force-field sections (flag-keyed, skipped here)
    then per-proc atom blocks: (int ndoubles, ndoubles float64) with
      atom_style ``atomic`` records [m, x, y, z, tag, type, mask,
      image, vx, vy, vz] (m = 11 = record length)

Only the state needed to seed a microstate is decoded: box, positions,
velocities, types, images.  Everything force-field related comes from
the framework's own MaterialSpec (the reference equally re-issues
pair_style commands after read_restart, in.strain.lammps).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

MAGIC = b"LammpS RestartT\x00"

# pre-imageint header enum (see module docstring)
_VERSION = 0
_SMALLINT = 1
_TAGINT = 2
_BIGINT = 3
_UNITS = 4
_NTIMESTEP = 5
_DIMENSION = 6
_NPROCS = 7
_PROCGRID = 8
_NEWTON_PAIR = 9
_NEWTON_BOND = 10
_XPERIODIC = 11
_YPERIODIC = 12
_ZPERIODIC = 13
_BOUNDARY = 14
_ATOM_STYLE = 15
_NATOMS = 16
_NTYPES = 17
_NBONDS = 18
_NBONDTYPES = 19
_BOND_PER_ATOM = 20
_NANGLES = 21
_NANGLETYPES = 22
_ANGLE_PER_ATOM = 23
_NDIHEDRALS = 24
_NDIHEDRALTYPES = 25
_DIHEDRAL_PER_ATOM = 26
_NIMPROPERS = 27
_NIMPROPERTYPES = 28
_IMPROPER_PER_ATOM = 29
_TRICLINIC = 30
_BOXLO = 31
_BOXHI = 32
_XY = 33
_XZ = 34
_YZ = 35
_SPECIAL_LJ = 36
_SPECIAL_COUL = 37
_IMAGEINT = 48
_BOUNDMIN = 49
_TIMESTEP = 50  # dt (double)
# appended run/neighbor settings 51..58: ints except 55/57 (doubles);
# widths established byte-exactly from the shipped init.sic_1.bin
_APPENDED_DOUBLE = (55, 57)

_BIGINT_FLAGS = {_NTIMESTEP, _NATOMS, _NBONDS, _NANGLES, _NDIHEDRALS,
                 _NIMPROPERS}
_STRING_FLAGS = {_VERSION, _UNITS, _ATOM_STYLE}
_VECTOR_INT_FLAGS = {_PROCGRID, _BOUNDARY}
_DOUBLE_FLAGS = {_XY, _XZ, _YZ, _TIMESTEP, *_APPENDED_DOUBLE}
_VECTOR_DOUBLE_FLAGS = {_BOXLO, _BOXHI, _SPECIAL_LJ, _SPECIAL_COUL,
                        _BOUNDMIN}


@dataclass
class LammpsRestart:
    """Decoded microstate payload of one binary restart."""

    version: str
    units: str
    atom_style: str
    timestep: int
    natoms: int
    ntypes: int
    boxlo: np.ndarray  # (3,)
    boxhi: np.ndarray  # (3,)
    tilt: np.ndarray  # (xy, xz, yz)
    triclinic: bool
    pos: np.ndarray  # (N, 3) tag-ordered, UNWRAPPED (image-folded)
    vel: np.ndarray  # (N, 3) tag-ordered
    types: np.ndarray  # (N,) int32, 0-based, tag-ordered
    image: np.ndarray  # (N, 3) int32 periodic image counts

    @property
    def h(self) -> np.ndarray:
        """Upper-triangular cell matrix (the framework's box convention)."""
        L = self.boxhi - self.boxlo
        h = np.diag(L)
        h[0, 1], h[0, 2], h[1, 2] = self.tilt
        return h


class _Cursor:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def int(self) -> int:
        v = struct.unpack_from("<i", self.data, self.off)[0]
        self.off += 4
        return v

    def bigint(self) -> int:
        v = struct.unpack_from("<q", self.data, self.off)[0]
        self.off += 8
        return v

    def double(self) -> float:
        v = struct.unpack_from("<d", self.data, self.off)[0]
        self.off += 8
        return v

    def doubles(self, n: int) -> np.ndarray:
        v = np.frombuffer(self.data, dtype="<f8", count=n, offset=self.off)
        self.off += 8 * n
        return v

    def string(self) -> str:
        n = self.int()
        s = self.data[self.off:self.off + n]
        self.off += n
        return s.rstrip(b"\x00").decode()


def read_restart(path: str) -> LammpsRestart:
    data = open(path, "rb").read()
    if not data.startswith(MAGIC):
        raise ValueError(f"{path}: not a LAMMPS binary restart "
                         f"(magic {data[:16]!r})")
    c = _Cursor(data)
    c.off = len(MAGIC)
    endian = c.int()
    if endian != 1:
        raise ValueError(f"{path}: big-endian restarts not supported")
    c.int()  # version-numeric (0 in this era)

    hdr: dict = {"triclinic": 0, "tilt": [0.0, 0.0, 0.0]}
    while True:
        flag = c.int()
        if flag < 0:
            break
        if flag in _STRING_FLAGS:
            hdr[flag] = c.string()
            if flag == _ATOM_STYLE:
                c.int()  # trailing avec settings word
        elif flag in _BIGINT_FLAGS:
            hdr[flag] = c.bigint()
        elif flag in _VECTOR_INT_FLAGS:
            n = c.int()
            hdr[flag] = [c.int() for _ in range(n)]
        elif flag in _VECTOR_DOUBLE_FLAGS:
            n = c.int()
            hdr[flag] = [c.double() for _ in range(n)]
        elif flag in _DOUBLE_FLAGS:
            hdr[flag] = c.double()
        else:  # plain int field (includes _SMALLINT.._TRICLINIC, IMAGEINT)
            hdr[flag] = c.int()

    natoms = int(hdr[_NATOMS])
    ntypes = int(hdr[_NTYPES])
    style = hdr.get(_ATOM_STYLE, "atomic")
    # ATOM_STYLE is followed by one avec settings int in this format
    # (already consumed by the generic int fallback only if keyed; the
    # style string itself was keyed, so consume the trailing int here)

    # ---- force-field / type sections: flag-keyed, each either a string
    # (style name + coeff doubles) or arrays.  The 2016 writer emits:
    # MASS (ntypes doubles), PAIR (style string + per-style data), ...
    # We scan forward for the per-proc atom payload instead of decoding
    # styles: the payload is the LAST structure, introduced by an int
    # equal to the total double count == natoms * per_atom (atomic: 11),
    # followed by exactly that many float64s ending at EOF.
    per_atom = {"atomic": 11}.get(style)
    if per_atom is None:
        raise ValueError(f"{path}: atom_style {style!r} not supported "
                         "(the reference's init_material writes 'atomic')")
    want = natoms * per_atom
    payload_off = None
    probe = c.off
    while probe + 4 <= len(data):
        n = struct.unpack_from("<i", data, probe)[0]
        if n == want and probe + 4 + 8 * want == len(data):
            payload_off = probe + 4
            break
        probe += 1
    if payload_off is None:
        raise ValueError(
            f"{path}: could not locate the per-proc atom payload "
            f"({natoms} atoms x {per_atom} doubles)")
    buf = np.frombuffer(data, dtype="<f8", count=want, offset=payload_off)
    rec = buf.reshape(natoms, per_atom)
    if not np.allclose(rec[:, 0], per_atom):
        raise ValueError(f"{path}: atom records are not atom_style "
                         f"{style!r} (lead {rec[0, 0]})")

    # record: [m, x, y, z, tag, type, mask, image, vx, vy, vz] where
    # tag/type/mask/image are raw integer BIT PATTERNS in the double
    # slots (LAMMPS's ubuf union cast), not value-converted doubles
    ints = np.ascontiguousarray(rec[:, 4:8]).view(np.int64)
    tags = ints[:, 0]
    order = np.argsort(tags, kind="stable")
    rec = rec[order]
    ints = ints[order]
    pos = rec[:, 1:4].copy()
    types = ints[:, 1].astype(np.int32) - 1
    vel = rec[:, 8:11].copy()
    # image int: packed 10-bit fields around 512 (IMGMASK/IMGMAX)
    imgpack = ints[:, 3]
    ix = (imgpack & 1023) - 512
    iy = ((imgpack >> 10) & 1023) - 512
    iz = ((imgpack >> 20) & 1023) - 512
    image = np.stack([ix, iy, iz], axis=1).astype(np.int32)

    boxlo = np.asarray(hdr.get(_BOXLO, [0.0, 0.0, 0.0]))
    boxhi = np.asarray(hdr.get(_BOXHI, [1.0, 1.0, 1.0]))
    tilt = np.asarray([hdr.get(_XY, 0.0), hdr.get(_XZ, 0.0),
                       hdr.get(_YZ, 0.0)], dtype=float)
    out = LammpsRestart(
        version=hdr.get(_VERSION, ""),
        units=hdr.get(_UNITS, ""),
        atom_style=style,
        timestep=int(hdr.get(_NTIMESTEP, 0)),
        natoms=natoms,
        ntypes=ntypes,
        boxlo=boxlo,
        boxhi=boxhi,
        tilt=tilt,
        triclinic=bool(hdr.get(_TRICLINIC, 0)),
        pos=pos,
        vel=vel,
        types=types,
        image=image,
    )
    # fold periodic images into unwrapped coordinates relative to boxlo
    # (the framework keeps positions continuous; LAMMPS stores wrapped
    # x + image counts)
    L = boxhi - boxlo
    out.pos = out.pos + out.image * L[None, :]
    return out
