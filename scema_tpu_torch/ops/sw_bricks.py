"""K6: Stillinger-Weber over 128-slot tiles of atoms, and the brick force
field of the unfused engine.

The port of ``scema_tpu/ops/sw_pallas.py``.  Two hand-written CUDA kernels
(``csrc/sw_bricks.cu``) and their plain PyTorch versions:

* the moments kernel — per-atom channels over a tile-pair list: half the
  two-body energy, s = sum g, sum g^2, m = sum g u and Q = sum g u (x) u
  (``NMOM`` = 12 channels).  Four wrappers launch it, each counting its own
  launches: :func:`sw_moments_bricks` (K6d) and :func:`sw_energy_bricks`
  (K6e, which reduces the channels to the energy) on the brick structure's
  27-stencil, :func:`sw_moments_adj` (K6b) on a bounding-sphere tile
  adjacency, and :func:`sw_moments` (K6a) over all tile pairs with the
  general (sig/r)^q term.  Inside the force call it also writes the live
  list: each slot's live neighbour slots in sweep order, up to
  ``LIST_CAP``, and their count (plain model :func:`live_list_plain`; the
  checks hold the kernel's list to it with :func:`live_list_errors`).  It
  skips 32-slot chunk pairs that a bounding-sphere test rules out
  (:func:`chunk_spheres_plain`, :func:`pruned_chunks_plain`);
* the forces kernel (K6c, :func:`sw_forces_bricks`) — each slot's adjoint
  pair forces in both roles and role 1's w (x) d virial channels over its
  live list (a slot past the cap sweeps the stencil), from the per-atom
  adjoints that torch computes between the two launches, as JAX does in
  jnp (sw_pallas.py:550-561); plain version :func:`sw_forces_plain`, and
  over a given list :func:`sw_forces_list_plain`, the model the checks
  time and hold the list's design to.

The first design of both kernels (a stencil sweep per kernel) stays built
for the checks, reached only through :func:`_moments_first` and
:func:`_forces_first`; its plain versions are :func:`sw_moments_plain` and
:func:`sw_forces_plain`, the same functions as the path's.

On CUDA tensors a wrapper launches its kernel (float32) or raises; on CPU
tensors it computes the same function with the plain version, in any
dtype.  Unlike the TPU kernels, whose minimum image rounds each axis by the
diagonal of h, both take the triclinic minimum image of ``box.min_image_disp``
from each job's h and its inverse: the same on an orthorhombic box, and on
a tilted one the same function as ``SW.energy`` over a list (ROADMAP
section 3).

Layouts (leading job axes on every state argument): tiles (..., C, 4, 128)
rows [x y z occ]; moments (..., C, 12, 128) [e2/2, s, gsq, mx my mz, Qxx
Qyy Qzz Qxy Qxz Qyz]; adjoints (..., C, 11, 128) [A_s, A_gsq, A_m (3), A_Q
(6)]; forces (..., C, 9, 128) [F (3), w (x) d (xx yy zz xy xz yz)]; the
live list's count (B, C, 128) and slots (B, C, cap, 128), int32.  The
tile-pair lists nbr, valid (C, K) are int32 and shared by every job.
"""
from __future__ import annotations

import ctypes
import dataclasses
import itertools

import numpy as np
import torch

from . import _build

TILE = 128
NMOM = 12
NADJ = 11
NFRC = 9
CHUNK = 32  # slots of one warp, and of one bounding sphere
# live-list entries per slot: at 300 K a slot of the prepared diamond box
# has ~9 live pairs at rc = 3.77 A (at most 15 on the 4096-atom box); a
# slot past the cap sweeps the stencil
LIST_CAP = 32
# the sphere test's margin (A), csrc/sw_bricks.cu's PRUNE_MARGIN
PRUNE_MARGIN = 1e-2
# (jobs x tiles x 128 x 128) pair-plane elements per slice of the plain versions
_PLAIN_PAIRS = 1 << 24


# --------------------------------------------------------------------------
# Host structures (numpy copies of sw_pallas.py's)


def tile_adjacency(pos: np.ndarray, h: np.ndarray, cutoff: float, skin: float = 1.0,
                   max_nb: int | None = None):
    """Neighbor-tile lists of consecutive-atom tiles from their bounding
    spheres (sw_pallas.py:180-212, verbatim): row entry 0 is the tile
    itself; unused entries repeat it with valid = 0.  Returns (nbr, valid),
    each (T, MAXNB) int32."""
    pos = np.asarray(pos)
    n = len(pos)
    n_pad = ((n + TILE - 1) // TILE) * TILE
    x = np.concatenate([pos, np.repeat(pos[-1:], n_pad - n, axis=0)], axis=0)
    tiles = x.reshape(-1, TILE, 3)
    centers = tiles.mean(axis=1)
    radii = np.linalg.norm(tiles - centers[:, None, :], axis=-1).max(axis=1)
    L = np.array([h[0, 0], h[1, 1], h[2, 2]])
    d = centers[:, None, :] - centers[None, :, :]
    d -= np.round(d / L) * L
    dist = np.linalg.norm(d, axis=-1)
    adj = dist < radii[:, None] + radii[None, :] + cutoff + skin
    T = len(centers)
    if max_nb is None:
        max_nb = int(adj.sum(axis=1).max())
    nbr = np.zeros((T, max_nb), dtype=np.int32)
    valid = np.zeros((T, max_nb), dtype=np.int32)
    for i in range(T):
        lst = ([i] + [j for j in np.where(adj[i])[0] if j != i])[:max_nb]
        nbr[i, :len(lst)] = lst
        nbr[i, len(lst):] = i
        valid[i, :len(lst)] = 1
    return nbr, valid


def all_tile_pairs(n_tiles: int):
    """K6a's list: every tile against every tile (the TPU kernel's (T, T)
    grid).  Returns (nbr, valid), each (T, T) int32."""
    nbr = np.tile(np.arange(n_tiles, dtype=np.int32), (n_tiles, 1))
    return nbr, np.ones_like(nbr)


def brick_structure(pos: np.ndarray, h: np.ndarray, cutoff: float, skin: float = 1.0,
                    target_occ: int = 96):
    """Brick grid + 27-stencil adjacency (sw_pallas.py:332-404, verbatim):
    atoms binned by fractional coordinates into bricks of edge >= cutoff +
    skin sized for ~``target_occ`` atoms, the grid refined along the
    longest edges while a brick overflows 128 slots.  Returns (slot_ids
    (C, 128) int32 atom ids, padded with N; nbr (C, 27) int32; valid (C, 27)
    int32, 0 on a duplicate wrap of a grid under 3 bricks per axis)."""
    pos = np.asarray(pos)
    n = len(pos)
    L = np.array([h[0, 0], h[1, 1], h[2, 2]])
    density = n / float(np.prod(L))
    edge = max(cutoff + skin, (target_occ / density) ** (1.0 / 3.0))
    nc = np.maximum(1, np.floor(L / edge).astype(int))
    while True:
        c1, c2, c3 = int(nc[0]), int(nc[1]), int(nc[2])
        C = c1 * c2 * c3
        s = pos @ np.linalg.inv(h).T
        s -= np.floor(s)
        bxyz = np.minimum((s * nc).astype(int), nc - 1)
        bid = (bxyz[:, 0] * c2 + bxyz[:, 1]) * c3 + bxyz[:, 2]
        slot_ids = np.full((C, TILE), n, dtype=np.int32)
        fill = np.zeros(C, dtype=int)
        overflow = False
        for a in np.argsort(bid, kind="stable"):
            b = bid[a]
            if fill[b] < TILE:
                slot_ids[b, fill[b]] = a
                fill[b] += 1
            else:
                overflow = True
                break
        if not overflow:
            break
        grew = False
        for d in np.argsort(-L / nc):
            if L[d] / (nc[d] + 1) >= cutoff + skin:
                nc[d] += 1
                grew = True
                break
        if not grew:
            raise ValueError("brick overflow: box too small for 128-lane bricks at this "
                             "cutoff — use the all-pairs kernel")
    idx = np.arange(C)
    iz, iy, ix = idx % c3, (idx // c3) % c2, idx // (c2 * c3)
    offsets = [(0, 0, 0)] + [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                             for k in (-1, 0, 1) if (i, j, k) != (0, 0, 0)]
    nbr = np.zeros((C, 27), dtype=np.int32)
    valid = np.zeros((C, 27), dtype=np.int32)
    seen = [set() for _ in range(C)]
    for o, (dx_, dy_, dz_) in enumerate(offsets):
        tgt = ((ix + dx_) % c1) * c2 * c3 + ((iy + dy_) % c2) * c3 + (iz + dz_) % c3
        for c in range(C):
            t = int(tgt[c])
            if t in seen[c]:
                nbr[c, o] = c
            else:
                seen[c].add(t)
                nbr[c, o] = t
                valid[c, o] = 1
    return slot_ids, nbr, valid


# --------------------------------------------------------------------------
# Packing and constants


def pack_tiles(pos: torch.Tensor, n_valid: int | None = None) -> torch.Tensor:
    """(..., N, 3) -> (..., T, 4, 128) consecutive-atom tiles with the
    occupancy row (pack_tiles, sw_pallas.py:34-42)."""
    n = pos.shape[-2]
    n_valid = n if n_valid is None else n_valid
    n_pad = -(-n // TILE) * TILE
    lead = pos.shape[:-2]
    x = torch.zeros(lead + (n_pad, 3), dtype=pos.dtype, device=pos.device)
    x[..., :n, :] = pos
    occ = (torch.arange(n_pad, device=pos.device) < n_valid).to(pos.dtype)
    rows = torch.cat([x.transpose(-1, -2), occ.expand(lead + (1, n_pad))], -2)
    return rows.reshape(lead + (4, n_pad // TILE, TILE)).transpose(-3, -2).contiguous()


def pack_bricks(pos: torch.Tensor, slot_ids: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) + slots (C, 128) -> (..., C, 4, 128) brick tiles with the
    occupancy row (pack_bricks, sw_pallas.py:407-417, with job axes)."""
    n = pos.shape[-2]
    lead = pos.shape[:-2]
    pos_pad = torch.cat([pos, pos.new_zeros(lead + (1, 3))], -2)
    g = pos_pad[..., slot_ids.long(), :]  # (..., C, 128, 3)
    occ = (slot_ids < n).to(pos.dtype).expand(lead + tuple(slot_ids.shape))
    return torch.cat([g.transpose(-1, -2), occ[..., None, :]], -2).contiguous()


def sw_consts(sw) -> dict:
    """K6's constants (K5's too, ``md_fused.sw_consts``), derived in double
    precision from the ``SW`` field with the TPU kernels' association, so
    that kernel and plain version see the same
    numbers: rc = a sig and the mask bound (rc - 1e-6)^2; gs = gam sig; the
    two-body factors A eps, B, -4 B and q; the adjoint factors lam eps c0^2
    (k_s), -2 lam eps c0 (k_m), lam eps, and the constant A_gsq =
    -(lam eps / 2)(1 - c0)^2."""
    rc = float(sw.a) * float(sw.sigma)
    lam_eps = float(sw.lam) * float(sw.epsilon)
    c0 = float(sw.costheta0)
    return dict(rc=rc, rc2=(rc - 1e-6) ** 2, sig=float(sw.sigma),
                gs=float(sw.gamma) * float(sw.sigma), aeps=float(sw.A) * float(sw.epsilon),
                b=float(sw.B), m4b=-4.0 * float(sw.B), q=float(sw.q), lam_eps=lam_eps,
                c0=c0, k_s=lam_eps * c0 * c0, k_m=-2.0 * lam_eps * c0,
                a_gsq=-(lam_eps / 2.0) * (1.0 - c0) ** 2)


def check_family(sw, general_q: bool = False) -> None:
    """The TPU kernels build p = 4 in, and all but K6a q = 0: refuse any
    other SW family rather than compute p = 4 silently."""
    if abs(float(sw.p) - 4.0) > 1e-12 or (not general_q and abs(float(sw.q)) > 1e-12):
        raise ValueError(
            f"the SW tile kernels compute p = 4{'' if general_q else ', q = 0'} only "
            f"(got p = {sw.p}, q = {sw.q})")


def boxes(h: torch.Tensor, lead, dtype, device):
    """(h, h^-1) as (B, 9) row-major for the B jobs of ``lead``."""
    hh = h.to(device=device, dtype=dtype).expand(tuple(lead) + (3, 3)).reshape(-1, 3, 3)
    return hh.contiguous(), torch.linalg.inv(hh).contiguous()


# --------------------------------------------------------------------------
# Plain versions (batched over jobs; the kernels' arithmetic)


def _min_image(d, hh, ih):
    """The kernels' minimum image of d = [dx, dy, dz], each (b, ...), in the
    boxes hh, ih (b, 3, 3)."""
    shape = (-1,) + (1,) * (d[0].dim() - 1)

    def mat(m, a, b):
        return m[:, a, b].reshape(shape)

    s = [mat(ih, a, 0) * d[0] + mat(ih, a, 1) * d[1] + mat(ih, a, 2) * d[2] for a in range(3)]
    s = [x - torch.round(x) for x in s]
    return [mat(hh, a, 0) * s[0] + mat(hh, a, 1) * s[1] + mat(hh, a, 2) * s[2] for a in range(3)]


def _geom(ci, nj, hh, ih, rc2, same):
    """Pair planes of centre slots ci (b, C, 4, T) (axis -2) against
    neighbour slots nj (b, C, 4, T) (axis -1): d = x_j - x_i by the
    minimum image of h, ih (b, 3, 3); the live mask (both occupied, r^2 <
    rc2, not the same slot of the same tile: ``same`` (C,) bool)."""
    dx, dy, dz = _min_image([nj[:, :, a, None, :] - ci[:, :, a, :, None] for a in range(3)],
                            hh, ih)
    r2 = dx * dx + dy * dy + dz * dz
    T = ci.shape[-1]
    eye = torch.eye(T, dtype=torch.bool, device=ci.device)
    mask = ((ci[:, :, 3, :, None] > 0.5) & (nj[:, :, 3, None, :] > 0.5) & (r2 < rc2)
            & ~(same[None, :, None, None] & eye))
    return dx, dy, dz, r2, mask


def _job_slices(B: int, C: int, width: int):
    step = max(1, _PLAIN_PAIRS // max(C * width * width, 1))
    return [slice(s, s + step) for s in range(0, B, step)]


def _width(tiles: torch.Tensor) -> int:
    """Lanes up to the last occupied one in any tile: the plain versions
    skip the empty tail (slots fill from lane 0), which holds no live pair."""
    occ = torch.nonzero((tiles[..., 3, :] > 0.5).flatten(0, -2).any(0))
    return int(occ.max()) + 1 if occ.numel() else 1


def sw_moments_plain(sw, tiles, nbr, valid, hh, ih) -> torch.Tensor:
    """Moments of tiles (B, C, 4, 128) over the list nbr/valid (C, K) in
    boxes hh, ih (B, 3, 3): (B, C, 12, 128)."""
    c = sw_consts(sw)
    B, C = tiles.shape[:2]
    nbr, valid = nbr.long(), valid.bool()
    cidx = torch.arange(C, device=tiles.device)
    out = torch.zeros((B, C, NMOM, TILE), dtype=tiles.dtype, device=tiles.device)
    w = _width(tiles)
    for js in _job_slices(B, C, w):
        ti, h_, ih_ = tiles[js, ..., :w], hh[js], ih[js]
        acc = [0.0] * NMOM
        for e in range(nbr.shape[1]):
            if not bool(valid[:, e].any()):
                continue
            b = nbr[:, e]
            dx, dy, dz, r2, mask = _geom(ti, ti[:, b], h_, ih_, c["rc2"], b == cidx)
            mask = mask & valid[:, e, None, None]
            one = torch.ones((), dtype=r2.dtype, device=r2.device)
            zero = torch.zeros_like(one)
            r = torch.sqrt(torch.where(mask, r2, one))
            sr = c["sig"] / r
            sr2 = sr * sr
            srp = sr2 * sr2
            srq = one if c["q"] == 0.0 else sr ** c["q"]
            denom = torch.where(mask, r - c["rc"], -one)
            e2 = torch.where(mask, c["aeps"] * (c["b"] * srp - srq) * torch.exp(c["sig"] / denom),
                             zero)
            g = torch.where(mask, torch.exp(c["gs"] / denom), zero)
            ux, uy, uz = dx / r, dy / r, dz / r
            gx, gy, gz = g * ux, g * uy, g * uz
            ch = [e2, g, g * g, gx, gy, gz, gx * ux, gy * uy, gz * uz, gx * uy, gx * uz, gy * uz]
            acc = [a + x.sum(-1) for a, x in zip(acc, ch)]
        acc[0] = 0.5 * acc[0]
        out[js, ..., :w] = torch.stack([a if torch.is_tensor(a) else ti[:, :, 0] * 0.0
                                        for a in acc], 2)
    return out


def _w(c, ux, uy, uz, inv_r, g, dg, radial0, a):
    """w = dT/dd of ordered pairs along u whose centres have the adjoints
    ``a`` (11 planes broadcastable against the pairs; ``pair_w``)."""
    a_s, a_gsq, amx, amy, amz, qxx, qyy, qzz, qxy, qxz, qyz = a
    am_u = amx * ux + amy * uy + amz * uz
    qx = qxx * ux + qxy * uy + qxz * uz
    qy = qxy * ux + qyy * uy + qyz * uz
    qz = qxz * ux + qyz * uy + qzz * uz
    uqu = ux * qx + uy * qy + uz * qz
    radial = radial0 + dg * (a_s + 2.0 * a_gsq * g + am_u + uqu)
    tang = g * inv_r
    t2 = am_u + 2.0 * uqu
    return (radial * ux + tang * (amx + 2.0 * qx - t2 * ux),
            radial * uy + tang * (amy + 2.0 * qy - t2 * uy),
            radial * uz + tang * (amz + 2.0 * qz - t2 * uz))


def _pair_forces(c, dx, dy, dz, r2, mask, a_i, a_j):
    """The 9 force channels of pairs d = x_j - x_i (masked by ``mask``)
    whose centres have the adjoints ``a_i`` and neighbours ``a_j`` (11
    planes each, broadcastable against the pairs): both roles' forces and
    role 1's w (x) d."""
    one = torch.ones((), dtype=r2.dtype, device=r2.device)
    zero = torch.zeros_like(one)
    r = torch.sqrt(torch.where(mask, r2, one))
    inv_r = 1.0 / r
    ux, uy, uz = dx * inv_r, dy * inv_r, dz * inv_r
    denom = torch.where(mask, r - c["rc"], -one)
    expo = torch.exp(c["sig"] / denom)
    sr = c["sig"] * inv_r
    sr2 = sr * sr
    srp = sr2 * sr2
    phi2 = c["aeps"] * (c["b"] * srp - 1.0) * expo
    id2 = denom * denom
    dphi2 = c["aeps"] * (c["m4b"] * srp * inv_r) * expo + phi2 * (-c["sig"] / id2)
    g = torch.exp(c["gs"] / denom)
    dg = g * (-c["gs"] / id2)
    radial0 = 0.5 * dphi2
    wa = [torch.where(mask, x, zero) for x in _w(c, ux, uy, uz, inv_r, g, dg, radial0, a_i)]
    wb = [torch.where(mask, x, zero) for x in _w(c, -ux, -uy, -uz, inv_r, g, dg, radial0, a_j)]
    return [wa[0] - wb[0], wa[1] - wb[1], wa[2] - wb[2],
            wa[0] * dx, wa[1] * dy, wa[2] * dz, 0.5 * (wa[0] * dy + wa[1] * dx),
            0.5 * (wa[0] * dz + wa[2] * dx), 0.5 * (wa[1] * dz + wa[2] * dy)]


def sw_forces_plain(sw, tiles, adj, nbr, valid, hh, ih) -> torch.Tensor:
    """Both roles' pair forces and role 1's w (x) d channels of tiles
    (B, C, 4, 128) with adjoints (B, C, 11, 128) over nbr/valid (C, K):
    (B, C, 9, 128).  The first design's plain version: the stencil sweep."""
    c = sw_consts(sw)
    B, C = tiles.shape[:2]
    nbr, valid = nbr.long(), valid.bool()
    cidx = torch.arange(C, device=tiles.device)
    out = torch.zeros((B, C, NFRC, TILE), dtype=tiles.dtype, device=tiles.device)
    w = _width(tiles)
    for js in _job_slices(B, C, w):
        ti, ad, h_, ih_ = tiles[js, ..., :w], adj[js, ..., :w], hh[js], ih[js]
        a_i = [ad[:, :, q, :, None] for q in range(NADJ)]
        acc = [0.0] * NFRC
        for e in range(nbr.shape[1]):
            if not bool(valid[:, e].any()):
                continue
            b = nbr[:, e]
            dx, dy, dz, r2, mask = _geom(ti, ti[:, b], h_, ih_, c["rc2"], b == cidx)
            mask = mask & valid[:, e, None, None]
            adb = ad[:, b]
            a_j = [adb[:, :, q, None, :] for q in range(NADJ)]
            ch = _pair_forces(c, dx, dy, dz, r2, mask, a_i, a_j)
            acc = [a + x.sum(-1) for a, x in zip(acc, ch)]
        out[js, ..., :w] = torch.stack([a if torch.is_tensor(a) else ti[:, :, 0] * 0.0
                                        for a in acc], 2)
    return out


def live_list_plain(sw, tiles, nbr, valid, hh, ih, cap: int = LIST_CAP):
    """The live list the moments kernel writes for tiles (B, C, 4, 128)
    over nbr/valid (C, K): each slot's count of live pairs (B, C, 128) and
    its first ``cap`` live neighbour slots (flat tile * 128 + lane) in
    sweep order — entries in list order, lanes ascending — with -1 past
    the count (B, C, cap, 128); int32."""
    c = sw_consts(sw)
    B, C = tiles.shape[:2]
    nbr_l, valid_b = nbr.long(), valid.bool()
    cidx = torch.arange(C, device=tiles.device)
    count = torch.zeros((B, C, TILE), dtype=torch.int64, device=tiles.device)
    lst = torch.full((B, C, cap, TILE), -1, dtype=torch.int64, device=tiles.device)
    w = _width(tiles)
    for js in _job_slices(B, C, w):
        ti, cnt, ls = tiles[js, ..., :w], count[js], lst[js]
        for e in range(nbr.shape[1]):
            if not bool(valid_b[:, e].any()):
                continue
            b = nbr_l[:, e]
            mask = _geom(ti, ti[:, b], hh[js], ih[js], c["rc2"], b == cidx)[-1]
            mask = mask & valid_b[:, e, None, None]
            at = cnt[..., :w, None] + mask.long().cumsum(-1) - 1
            jb, cc, ii, jj = torch.nonzero(mask & (at < cap), as_tuple=True)
            ls[jb, cc, at[jb, cc, ii, jj], ii] = b[cc] * TILE + jj
            cnt[..., :w] += mask.sum(-1)
    return count.to(torch.int32), lst.to(torch.int32)


def sw_forces_list_plain(sw, tiles, adj, count, lst, nbr, valid, hh, ih) -> torch.Tensor:
    """K6c's forces over the live list (``count``, ``lst`` of
    :func:`live_list_plain`): each slot's first min(count, cap) listed
    pairs with :func:`sw_forces_plain`'s arithmetic; a slot whose count
    passes cap takes the stencil sweep, as the kernel does.  (B, C, 9, 128)."""
    c = sw_consts(sw)
    B, C = tiles.shape[:2]
    cap = lst.shape[-2]
    out = torch.zeros((B, C, NFRC, TILE), dtype=tiles.dtype, device=tiles.device)
    kk = torch.arange(cap, device=tiles.device)[:, None]
    step = max(1, _PLAIN_PAIRS // max(C * cap * TILE, 1))
    for s0 in range(0, B, step):
        js = slice(s0, s0 + step)
        ti, ad = tiles[js], adj[js]
        b = ti.shape[0]
        listed = kk < count[js, :, None, :].long()  # entries past the count are not read
        idx = torch.where(listed, lst[js].long(), 0).reshape(b, -1)

        def gather(rows, q):  # row q of every listed neighbour: (b, C, cap, 128)
            x = rows[:, :, q, :].reshape(b, C * TILE)
            return torch.gather(x, 1, idx).reshape(b, C, cap, TILE)

        d = [gather(ti, a) - ti[:, :, None, a, :] for a in range(3)]
        dx, dy, dz = _min_image(d, hh[js], ih[js])
        r2 = dx * dx + dy * dy + dz * dz
        mask = listed & (r2 < c["rc2"]) & (ti[:, :, None, 3, :] > 0.5)
        a_i = [ad[:, :, None, q, :] for q in range(NADJ)]
        a_j = [gather(ad, q) for q in range(NADJ)]
        ch = _pair_forces(c, dx, dy, dz, r2, mask, a_i, a_j)
        out[js] = torch.stack([x.sum(2) for x in ch], 2)
    over = count > cap
    if bool(over.any()):
        out = torch.where(over[:, :, None, :], sw_forces_plain(sw, tiles, adj, nbr, valid, hh, ih),
                          out)
    return out


def chunk_spheres_plain(tiles, hh, ih) -> torch.Tensor:
    """The sphere pass: each 32-slot chunk of tiles (B, C, 4, 128) as (cx,
    cy, cz, r) — its slots by their minimum image from the chunk's first
    occupied slot, the centre their mean, r the largest distance from it;
    r = -1 for a chunk with no occupied slot.  (B, C, 4, 4)."""
    B, C = tiles.shape[:2]
    W = TILE // CHUNK
    x = tiles[:, :, :3].reshape(B, C, 3, W, CHUNK)
    occ = tiles[:, :, 3].reshape(B, C, W, CHUNK) > 0.5
    first = occ.to(torch.uint8).argmax(-1)[:, :, None, :, None].expand(B, C, 3, W, 1)
    ref = torch.gather(x, -1, first)[..., 0]  # (B, C, 3, W)
    zero = torch.zeros((), dtype=tiles.dtype, device=tiles.device)
    d = [torch.where(occ, v, zero)
         for v in _min_image([x[:, :, a] - ref[:, :, a, :, None] for a in range(3)], hh, ih)]
    n = occ.sum(-1).clamp(min=1)
    mean = [v.sum(-1) / n for v in d]
    e2 = sum((v - m[..., None]) ** 2 for v, m in zip(d, mean))
    r = torch.sqrt(torch.where(occ, e2, zero).amax(-1))
    r = torch.where(occ.any(-1), r, -torch.ones_like(r))
    return torch.stack([ref[:, :, a] + mean[a] for a in range(3)] + [r], -1)


def pruned_chunks_plain(sph, nbr, valid, hh, ih, rc: float) -> torch.Tensor:
    """The sphere test over the spheres ``sph`` (B, C, 4, 4) of
    :func:`chunk_spheres_plain`: (B, C, K, 4, 4) bool, True where centre
    chunk u of tile c and chunk v of entry e's tile are both occupied and
    ruled out — min over the 27 image offsets m in {-1, 0, 1}^3 of |d_cc +
    h m| >= r_u + r_v + rc + PRUNE_MARGIN, d_cc the minimum image of the
    centres — the test being made only while r_u + r_v is below half the
    box's least height (csrc/sw_bricks.cu states why no live pair is lost)."""
    B = sph.shape[0]
    si = sph[:, :, None, :, None, :]
    sj = sph[:, nbr.long()][:, :, :, None, :, :]
    d = _min_image([sj[..., a] - si[..., a] for a in range(3)], hh, ih)
    shape = (B,) + (1,) * (d[0].dim() - 1)
    best = None
    for m in itertools.product((-1.0, 0.0, 1.0), repeat=3):
        e = [d[a] + sum(hh[:, a, b].reshape(shape) * m[b] for b in range(3)) for a in range(3)]
        n2 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2]
        best = n2 if best is None else torch.minimum(best, n2)
    rr = si[..., 3] + sj[..., 3]
    hlim = (0.5 / ih.pow(2).sum(-1).amax(-1).sqrt()).reshape(shape)
    lim = rr + rc + PRUNE_MARGIN
    return ((si[..., 3] >= 0) & (sj[..., 3] >= 0) & (rr < hlim) & (best >= lim * lim)
            & valid.bool()[None, :, :, None, None])


def live_list_errors(sw, tiles, nbr, valid, hh, ih, count, lst, rtol: float = 1e-4):
    """Holds a kernel's live list (count (B, C, 128), slots (B, C, cap,
    128) of float32 tiles (B, C, 4, 128)) to the plain sweep in float64,
    forgiving only pairs whose r^2 lies within ``rtol`` of rc2, where the
    float32 geometry may decide either way.  With lo, hi = rc2 (1 -/+
    rtol): each slot's count lies between its pairs below lo and below hi;
    its first min(count, cap) listed slots are distinct pairs below hi;
    and, where count <= cap, they hold every pair below lo.  Returns
    (violations, listed pairs within the margin)."""
    dev = tiles.device
    B, C = tiles.shape[:2]
    t64, h64, i64 = tiles.double(), hh.double(), ih.double()
    rc2 = sw_consts(sw)["rc2"]
    # the sweep at hi (rc scaled through a), with every pair listed
    sw_hi = dataclasses.replace(sw, a=float(sw.a) * (1.0 + rtol) ** 0.5)
    cnt_u = live_list_plain(sw_hi, t64, nbr, valid, h64, i64, cap=1)[0]
    cap_u = max(int(cnt_u.max()), 1)
    cnt_u, lst_u = live_list_plain(sw_hi, t64, nbr, valid, h64, i64, cap=cap_u)

    def r2_of(c, ls):  # r^2 of each listed pair (B, C, k, 128), inf past the count
        k = ls.shape[-2]
        listed = torch.arange(k, device=dev)[:, None] < c[:, :, None, :].long()
        idx = torch.where(listed, ls.long(), 0).clamp(0, C * TILE - 1).reshape(B, -1)
        d = [torch.gather(t64[:, :, a, :].reshape(B, C * TILE), 1, idx).reshape(B, C, k, TILE)
             - t64[:, :, None, a, :] for a in range(3)]
        d = _min_image(d, h64, i64)
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        return listed, torch.where(listed, r2, torch.full_like(r2, float("inf")))

    cap = lst.shape[-2]
    shown = torch.minimum(count, torch.full_like(count, cap))
    listed_k, r2_k = r2_of(shown, lst)
    listed_u, r2_u = r2_of(cnt_u, lst_u)
    strict = r2_u < rc2 * (1.0 - rtol)
    bad = int(((count < strict.sum(2)) | (count > cnt_u)).sum())
    # pairs as keys (job, slot, neighbour slot)
    slot = (torch.arange(B * C * TILE, device=dev).reshape(B, C, 1, TILE)) * (C * TILE)

    def keys(ls, sel):
        return (slot + ls.long()).expand(sel.shape)[sel]

    k_keys = keys(lst, listed_k)
    u_keys = keys(lst_u, listed_u)
    bad += int(k_keys.numel() - torch.unique(k_keys).numel())  # repeats
    bad += int((listed_k & ((lst < 0) | (lst >= C * TILE))).sum())  # not a slot
    bad += int((~torch.isin(k_keys, u_keys)).sum())  # listed, not below hi
    whole = (count <= cap)[:, :, None, :]
    s_keys = keys(lst_u, strict & whole)
    bad += int((~torch.isin(s_keys, k_keys)).sum())  # below lo, not listed
    margin = int((listed_k & (r2_k >= rc2 * (1.0 - rtol))).sum())
    return bad, margin


def adjoints(sw, mom: torch.Tensor) -> torch.Tensor:
    """Per-atom three-body adjoints from the moments (..., C, 12, 128):
    A_s = lam eps c0^2 s, A_gsq = -(lam eps / 2)(1 - c0)^2, A_m = -2 lam eps
    c0 m, A_Q = lam eps Q (sw_pallas.py:550-561) -> (..., C, 11, 128)."""
    c = sw_consts(sw)
    s = mom[..., 1:2, :]
    return torch.cat([c["k_s"] * s, torch.full_like(s, c["a_gsq"]), c["k_m"] * mom[..., 3:6, :],
                      c["lam_eps"] * mom[..., 6:12, :]], -2).contiguous()


def energy_from_moments(sw, mom: torch.Tensor) -> torch.Tensor:
    """Total SW energy per job from the moments (..., C, 12, 128)
    (sw_energy_from_moments, sw_pallas.py:149-163): the three-body double
    sum collapses to s, sum g^2, |m|^2 and Tr Q^2 per atom."""
    e2 = mom[..., 0, :].sum((-1, -2))
    s, gsq = mom[..., 1, :], mom[..., 2, :]
    m2 = mom[..., 3, :] ** 2 + mom[..., 4, :] ** 2 + mom[..., 5, :] ** 2
    trq2 = (mom[..., 6, :] ** 2 + mom[..., 7, :] ** 2 + mom[..., 8, :] ** 2
            + 2.0 * (mom[..., 9, :] ** 2 + mom[..., 10, :] ** 2 + mom[..., 11, :] ** 2))
    c0 = float(sw.costheta0)
    e3 = (trq2 - gsq) - 2.0 * c0 * (m2 - gsq) + c0 * c0 * (s * s - gsq)
    return e2 + 0.5 * float(sw.lam) * float(sw.epsilon) * e3.sum((-1, -2))


# --------------------------------------------------------------------------
# Kernel launches (CUDA tensors only)


class _SWK(ctypes.Structure):
    """Mirror of the kernel's SWK."""

    _fields_ = [(name, ctypes.c_float) for name in
                ("rc", "rc2", "sig", "gs", "aeps", "b", "m4b", "q")]


def _swk(sw) -> _SWK:
    k = _SWK()
    for name, v in sw_consts(sw).items():
        if hasattr(k, name):
            setattr(k, name, v)
    return k


def _on_card(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (the plain version); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {x.dtype}")
    return True


def _lists(nbr, valid, C: int, device):
    nbr = torch.as_tensor(nbr, device=device).to(torch.int32).contiguous()
    valid = torch.as_tensor(valid, device=device).to(torch.int32).contiguous()
    if nbr.shape != valid.shape or nbr.dim() != 2 or nbr.shape[0] != C:
        raise ValueError(f"tile lists {tuple(nbr.shape)} / {tuple(valid.shape)} do not fit "
                         f"{C} tiles")
    return nbr, valid


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch_moments(sw, tiles, nbr, valid, hh, ih, lists=None, sph=None) -> torch.Tensor:
    """The path's moments kernel (after the sphere pass) on tiles
    (B, C, 4, 128); with ``lists`` = (count (B, C, 128), slots (B, C, cap,
    128)), int32, it writes the live list into them, and the sphere pass
    writes the chunks' spheres into ``sph`` (B, C, 4, 4) float32 when given
    (the checks hold both to their plain versions)."""
    B, C = tiles.shape[:2]
    out = torch.empty((B, C, NMOM, TILE), dtype=torch.float32, device=tiles.device)
    if B * C == 0:
        return out
    if sph is None:
        sph = torch.empty((B, C, TILE // CHUNK, 4), dtype=torch.float32, device=tiles.device)
    count, lst = lists if lists is not None else (None, None)
    k = _swk(sw)
    rc = _build.library().sw_moments_list_f32(
        tiles.data_ptr(), nbr.data_ptr(), valid.data_ptr(), hh.data_ptr(), ih.data_ptr(),
        sph.data_ptr(), out.data_ptr(), _ptr(count), _ptr(lst),
        0 if lst is None else lst.shape[-2], B, C, nbr.shape[1], ctypes.addressof(k),
        _build.stream_handle(tiles.device))
    _build.check(rc, "sw_moments_list_f32")
    return out


def _launch_forces(sw, tiles, adj, nbr, valid, hh, ih, count, lst, overflow) -> torch.Tensor:
    """The path's forces kernel over the live list (count, lst) of
    :func:`_launch_moments`; ``overflow`` (1,) int32, zeroed by the caller,
    gains the slots past the list's cap."""
    B, C = tiles.shape[:2]
    out = torch.empty((B, C, NFRC, TILE), dtype=torch.float32, device=tiles.device)
    if B * C == 0:
        return out
    k = _swk(sw)
    rc = _build.library().sw_forces_list_f32(
        tiles.data_ptr(), adj.data_ptr(), nbr.data_ptr(), valid.data_ptr(), hh.data_ptr(),
        ih.data_ptr(), count.data_ptr(), lst.data_ptr(), lst.shape[-2], out.data_ptr(),
        overflow.data_ptr(), B, C, nbr.shape[1], ctypes.addressof(k),
        _build.stream_handle(tiles.device))
    _build.check(rc, "sw_forces_list_f32")
    return out


def _moments_first(sw, tiles, nbr, valid, hh, ih) -> torch.Tensor:
    """The first design's moments kernel on tiles (B, C, 4, 128) (the
    plain version on CPU tensors); for the checks only."""
    if not _on_card(tiles, "_moments_first"):
        return sw_moments_plain(sw, tiles, nbr, valid, hh, ih)
    B, C = tiles.shape[:2]
    nbr, valid = _lists(nbr, valid, C, tiles.device)
    tiles = tiles.contiguous()
    out = torch.empty((B, C, NMOM, TILE), dtype=torch.float32, device=tiles.device)
    if B * C:
        k = _swk(sw)
        rc = _build.library().sw_moments_f32(
            tiles.data_ptr(), nbr.data_ptr(), valid.data_ptr(), hh.data_ptr(), ih.data_ptr(),
            out.data_ptr(), B, C, nbr.shape[1], ctypes.addressof(k),
            _build.stream_handle(tiles.device))
        _build.check(rc, "sw_moments_f32")
        _moments_first.launches += 1
    return out


def _forces_first(sw, tiles, adj, nbr, valid, hh, ih) -> torch.Tensor:
    """The first design's forces kernel (the stencil sweep), as
    :func:`_moments_first`."""
    if not _on_card(tiles, "_forces_first"):
        return sw_forces_plain(sw, tiles, adj, nbr, valid, hh, ih)
    B, C = tiles.shape[:2]
    nbr, valid = _lists(nbr, valid, C, tiles.device)
    tiles, adj = tiles.contiguous(), adj.contiguous()
    out = torch.empty((B, C, NFRC, TILE), dtype=torch.float32, device=tiles.device)
    if B * C:
        k = _swk(sw)
        rc = _build.library().sw_forces_f32(
            tiles.data_ptr(), adj.data_ptr(), nbr.data_ptr(), valid.data_ptr(), hh.data_ptr(),
            ih.data_ptr(), out.data_ptr(), B, C, nbr.shape[1], ctypes.addressof(k),
            _build.stream_handle(tiles.device))
        _build.check(rc, "sw_forces_f32")
        _forces_first.launches += 1
    return out


def kernel_info(which: str) -> dict:
    """Registers, local (spill) bytes per thread, resident blocks per SM
    (the card's occupancy calculator) and block width of a K6 kernel:
    "moments" and "forces" (the path's), "moments_first", "forces_first",
    "spheres"."""
    ids = {"moments": 0, "forces": 1, "moments_first": 2, "forces_first": 3, "spheres": 4}
    out = (ctypes.c_int * 4)()
    rc = _build.library().sw_kernel_info(ids[which], out)
    _build.check(rc, f"sw_kernel_info ({which})")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm", "threads"), out))


def _moments(fn, sw, tiles, nbr, valid, h, plain: bool = False):
    """The moments of tiles (..., C, 4, 128): the kernel (counted on
    ``fn``) on the card, the plain version on the CPU or with ``plain``."""
    lead, C = tiles.shape[:-3], tiles.shape[-3]
    flat = tiles.reshape((-1,) + tuple(tiles.shape[-3:]))
    hh, ih = boxes(h, lead, tiles.dtype, tiles.device)
    nbr, valid = _lists(nbr, valid, C, tiles.device)
    if not plain and _on_card(tiles, fn.__name__):
        out = _launch_moments(sw, flat.contiguous(), nbr, valid, hh, ih)
        fn.launches += 1
    else:
        out = sw_moments_plain(sw, flat, nbr, valid, hh, ih)
    return out.reshape(tuple(lead) + tuple(out.shape[1:]))


# --------------------------------------------------------------------------
# Wrappers (``plain=True`` computes the plain version on any device: the
# card's checks hold each kernel against it)


def sw_moments(sw, pos: torch.Tensor, h: torch.Tensor, n_valid: int | None = None,
               plain: bool = False):
    """K6a: the channels of pos (..., N, 3) over all consecutive-atom tile
    pairs, general q (sw_moments_pallas, sw_pallas.py:117-146).  Returns
    (..., T, 12, 128)."""
    check_family(sw, general_q=True)
    tiles = pack_tiles(pos, n_valid)
    nbr, valid = all_tile_pairs(tiles.shape[-3])
    return _moments(sw_moments, sw, tiles, nbr, valid, h, plain)


def sw_moments_adj(sw, pos: torch.Tensor, h: torch.Tensor, nbr, valid,
                   n_valid: int | None = None, plain: bool = False):
    """K6b: the channels over a tile adjacency nbr/valid (T, MAXNB) from
    :func:`tile_adjacency` (sw_moments_pallas_adj, :278-317).  q = 0."""
    check_family(sw)
    return _moments(sw_moments_adj, sw, pack_tiles(pos, n_valid), nbr, valid, h, plain)


def sw_moments_bricks(sw, pos: torch.Tensor, h: torch.Tensor, slot_ids, nbr, valid,
                      plain: bool = False):
    """K6d: the channels of the brick tiles over the 27-stencil
    (sw_moments_pallas_bricks_raw, :651-679).  q = 0.  Returns
    (..., C, 12, 128)."""
    check_family(sw)
    slots = torch.as_tensor(slot_ids, device=pos.device)
    return _moments(sw_moments_bricks, sw, pack_bricks(pos, slots), nbr, valid, h, plain)


def sw_energy_bricks(sw, pos: torch.Tensor, h: torch.Tensor, slot_ids, nbr, valid,
                     plain: bool = False):
    """K6e: the total SW energy (...) of the brick tiles (K6d's kernel,
    reduced by :func:`energy_from_moments`; sw_energy_pallas_bricks,
    :682-713)."""
    check_family(sw)
    slots = torch.as_tensor(slot_ids, device=pos.device)
    mom = _moments(sw_energy_bricks, sw, pack_bricks(pos, slots), nbr, valid, h, plain)
    return energy_from_moments(sw, mom)


def sw_forces_bricks(sw, pos: torch.Tensor, h: torch.Tensor, slot_ids, nbr, valid,
                     atom_slot: torch.Tensor | None = None, plain: bool = False):
    """K6c: forces, energy and potential virial on the brick structure
    (sw_forces_pallas_bricks, :541-604): K6d's moments and live list
    (counted on :func:`sw_moments_bricks`), the adjoints in torch, then the
    forces kernel over the list (``LIST_CAP`` entries per slot; a slot past
    it sweeps the stencil, and on the card ``sw_forces_bricks.overflow``, a
    (1,) int32 tensor, holds the count of such slots; None after the plain
    version, :func:`sw_forces_plain`).  Returns (F (..., N, 3), E (...), W
    (..., 6) Voigt [xx yy zz xy xz yz], W = -sym(sum over ordered pairs of
    w (x) d)) by :func:`_fev`."""
    check_family(sw)
    slots = torch.as_tensor(slot_ids, device=pos.device)
    C = slots.shape[0]
    flat = pack_bricks(pos, slots).reshape(-1, C, 4, TILE)
    hh, ih = boxes(h, tuple(pos.shape[:-2]), pos.dtype, pos.device)
    nb, va = _lists(nbr, valid, C, pos.device)
    overflow = None
    if not plain and _on_card(pos, "sw_forces_bricks"):
        count = torch.empty(flat.shape[:2] + (TILE,), dtype=torch.int32, device=pos.device)
        lst = torch.empty(flat.shape[:2] + (LIST_CAP, TILE), dtype=torch.int32,
                          device=pos.device)
        mom = _launch_moments(sw, flat, nb, va, hh, ih, (count, lst))
        sw_moments_bricks.launches += 1
        adj = adjoints(sw, mom)
        overflow = torch.zeros(1, dtype=torch.int32, device=pos.device)
        fout = _launch_forces(sw, flat, adj, nb, va, hh, ih, count, lst, overflow)
        sw_forces_bricks.launches += 1
    else:
        mom = sw_moments_plain(sw, flat, nb, va, hh, ih)
        fout = sw_forces_plain(sw, flat, adjoints(sw, mom), nb, va, hh, ih)
    sw_forces_bricks.overflow = overflow
    return _fev(sw, fout, mom, pos, slots, atom_slot)


def _fev(sw, fout, mom, pos, slot_ids, atom_slot=None):
    """(F, E, W) of :func:`sw_forces_bricks` from the forces kernel's
    channels ``fout`` (B, C, 9, 128) and the moments ``mom`` (B, C, 12,
    128) of pos (..., N, 3).  Each atom owns one slot, so the slot forces
    come back by a gather (``atom_slot`` (N,): each atom's flat slot,
    derived from ``slot_ids`` when not given) where JAX scatter-adds."""
    n, lead = pos.shape[-2], tuple(pos.shape[:-2])
    C = fout.shape[1]
    if atom_slot is None:
        atom_slot = slot_map(torch.as_tensor(slot_ids, device=pos.device), n)
    f_slots = fout[:, :, :3, :].transpose(-1, -2).reshape(fout.shape[0], C * TILE, 3)
    F = f_slots[:, atom_slot.to(pos.device)]
    W = -fout[:, :, 3:, :].sum((1, 3))
    return (F.reshape(lead + (n, 3)), energy_from_moments(sw, mom).reshape(lead),
            W.reshape(lead + (6,)))


def slot_map(slot_ids: torch.Tensor, n_atoms: int) -> torch.Tensor:
    """(N,) the flat slot (brick * 128 + lane) of each atom; raises if an
    atom has no slot or more than one."""
    ids = torch.as_tensor(slot_ids).reshape(-1).long()
    occ = torch.nonzero(ids < n_atoms).flatten()
    out = torch.full((n_atoms,), -1, dtype=torch.int64, device=ids.device)
    out[ids[occ]] = occ
    if occ.numel() != n_atoms or bool((out < 0).any()):
        raise ValueError("slot_ids must hold every atom exactly once")
    return out


sw_moments.launches = 0
sw_moments_adj.launches = 0
sw_moments_bricks.launches = 0
sw_energy_bricks.launches = 0
sw_forces_bricks.launches = 0
sw_forces_bricks.overflow = None
_moments_first.launches = 0
_forces_first.launches = 0


class SWBricksFF:
    """The SW force field on the brick structure (``SWBricksFF``,
    sw_pallas.py:607-648) for the unfused engine: ``energy``, ``forces``
    and ``forces_energy_virial`` on batched states (pos (..., N, 3), h
    (..., 3, 3)), dispatched to directly by ``engine.forces`` /
    ``engine.forces_energy_virial``; ``slot_ids`` tells
    ``MDSystem.build_neighbors`` that no per-run list is needed.

    The structure is built once on the host from the initial state and is
    affine-invariant (bricks bin fractional coordinates), so fix-deform
    box changes never invalidate it; thermal drift across brick boundaries
    is bounded by the brick margin (edge >= cutoff + skin) for solid-state
    runs, as in the JAX package."""

    def __init__(self, sw, pos0, h0, skin: float = 1.0, target_occ: int = 96, device=None):
        check_family(sw)
        self.sw = sw
        self.cutoff = sw.cutoff
        pos0 = np.asarray(torch.as_tensor(pos0).detach().cpu().double())
        h0 = np.asarray(torch.as_tensor(h0).detach().cpu().double())
        slots, nbr, valid = brick_structure(pos0, h0, sw.cutoff, skin=skin,
                                            target_occ=target_occ)
        self.set_structure(slots, nbr, valid, len(pos0), device)

    @classmethod
    def from_structure(cls, sw, slot_ids, nbr, valid, n_atoms: int, device=None):
        """The force field on a given brick structure (e.g. the JAX
        package's, through ``interop.sw_bricks``)."""
        check_family(sw)
        ff = cls.__new__(cls)
        ff.sw, ff.cutoff = sw, sw.cutoff
        ff.set_structure(slot_ids, nbr, valid, n_atoms, device)
        return ff

    def set_structure(self, slot_ids, nbr, valid, n_atoms: int, device=None) -> None:
        """Use the brick structure (slot_ids (C, 128), nbr, valid (C, 27))."""
        self.slot_ids = torch.as_tensor(np.asarray(slot_ids), device=device).to(torch.int32)
        self.nbr = torch.as_tensor(np.asarray(nbr), device=device).to(torch.int32)
        self.valid = torch.as_tensor(np.asarray(valid), device=device).to(torch.int32)
        self.atom_slot = slot_map(self.slot_ids, n_atoms)

    @property
    def n_bricks(self) -> int:
        return int(self.slot_ids.shape[0])

    def energy(self, pos, h, nbr=None):
        return sw_energy_bricks(self.sw, pos, h, self.slot_ids, self.nbr, self.valid)

    def forces(self, pos, h, nbr=None):
        return self.forces_energy_virial(pos, h)[0]

    def forces_energy_virial(self, pos, h, nbr=None):
        return sw_forces_bricks(self.sw, pos, h, self.slot_ids, self.nbr, self.valid,
                                atom_slot=self.atom_slot)
