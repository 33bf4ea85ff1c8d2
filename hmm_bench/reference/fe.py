"""Plain FE and bridging reference of one HMM macro-step on the dogbone.

A frozen copy of the arithmetic of ``scema_tpu_torch`` at commit ce23eb3:
``fem/mesh.build_cuboid``, ``fem/shapes`` (Q1 shapes, Gauss quadrature,
geometry), ``fem/assembly`` (lumped mass, internal and gravity forces,
rhs, qp strains, reaction force), ``fem/problem_types.make_dogbone``,
``fem/fe_problem`` (begin_step, solve, apply_stress_update, end_step),
``bridging/bridge`` (replica strains, length variation, init-stress
subtraction and replica averaging), ``bridge.job_mask`` and the job
packing of ``hmm/md_coupling.MDBackend.update``, and ``utils/tensors``'s
Voigt algebra.  Plain PyTorch on whatever device and dtype it is given;
imports nothing of the port.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

GRAVITY = 9.81
VOIGT_IJ = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
VOIGT_W = (1.0, 1.0, 1.0, 2.0, 2.0, 2.0)


# -- Voigt algebra ------------------------------------------------------------


def sym_to_voigt(t):
    return torch.stack([t[..., i, j] for (i, j) in VOIGT_IJ], dim=-1)


def voigt_to_sym(v):
    xx, yy, zz, xy, xz, yz = v.unbind(-1)
    return torch.stack([torch.stack([xx, xy, xz], -1), torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], -2)


def voigt_norm(v):
    w = torch.tensor(VOIGT_W, dtype=v.dtype, device=v.device)
    return torch.sqrt(torch.sum(w * v * v, dim=-1))


def rotate_voigt(v, rotam):
    """R t R^T of a Voigt-packed symmetric tensor, symmetrised."""
    tmp = torch.einsum("...im,...mn,...jn->...ij", rotam, voigt_to_sym(v), rotam)
    return sym_to_voigt(0.5 * (tmp + tmp.transpose(-1, -2)))


def contract_c66(c66, eps_v):
    w = torch.tensor(VOIGT_W, dtype=eps_v.dtype, device=eps_v.device)
    return torch.einsum("...ij,...j->...i", c66, w * eps_v)


# -- mesh and geometry --------------------------------------------------------


@dataclass
class Geometry:
    nodes: np.ndarray  # (n_nodes, 3)
    cells: torch.Tensor  # (n_cells, 8) int64
    grads: torch.Tensor  # (n_cells, n_q, 8, 3)
    shapes: torch.Tensor  # (n_q, 8)
    jxw: torch.Tensor  # (n_cells, n_q)

    @property
    def n_nodes(self) -> int:
        return int(self.nodes.shape[0])


def cuboid(xl, yl, zl, nx_c, ny_c, nz_c):
    """Structured hex mesh of [0,xl]x[0,yl]x[0,zl]: nodes x fastest, cells
    x fastest, vertices in bit order x + 2y + 4z."""
    nx, ny, nz = nx_c + 1, ny_c + 1, nz_c + 1
    Z, Y, X = np.meshgrid(np.linspace(0.0, zl, nz), np.linspace(0.0, yl, ny),
                          np.linspace(0.0, xl, nx), indexing="ij")
    nodes = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)
    cells = []
    for iz in range(nz_c):
        for iy in range(ny_c):
            for ix in range(nx_c):
                cells.append([(ix + xb) + nx * ((iy + yb) + ny * (iz + zb))
                              for zb in (0, 1) for yb in (0, 1) for xb in (0, 1)])
    return nodes, np.asarray(cells, dtype=np.int64)


def geometry(mesh: dict, dtype=torch.float64, device="cpu") -> Geometry:
    """The dogbone's cuboid mesh from the config's 'continuum mesh' and its
    Q1 geometry at tensor-product Gauss points (x fastest)."""
    inp = mesh.get("input", {})
    nodes, cells = cuboid(float(inp.get("x length", 0.03)), float(inp.get("y length", 0.03)),
                          float(inp.get("z length", 0.08)), int(inp.get("x cells", 3)),
                          int(inp.get("y cells", 3)), int(inp.get("z cells", 8)))
    x, w = np.polynomial.legendre.leggauss(int(mesh.get("quadrature formula", 2)))
    x, w = 0.5 * (x + 1.0), 0.5 * w
    pts = np.array([[a, b, c] for c in x for b in x for a in x])
    wts = np.array([c * b * a for c in w for b in w for a in w])
    bits = np.array([[(v >> d) & 1 for d in range(3)] for v in range(8)], dtype=float)
    shp = np.empty((len(pts), 8))
    gref = np.empty((len(pts), 8, 3))
    for v in range(8):
        comp = np.where(bits[v][None, :] > 0.5, pts, 1.0 - pts)
        shp[:, v] = comp.prod(axis=1)
        sign = np.where(bits[v] > 0.5, 1.0, -1.0)
        for d in range(3):
            o1, o2 = [o for o in range(3) if o != d]
            gref[:, v, d] = sign[d] * comp[:, o1] * comp[:, o2]
    xyz = nodes[cells]
    jac = np.einsum("cva,qvb->cqab", xyz, gref)
    grads = np.einsum("cqba,qvb->cqva", np.linalg.inv(jac), gref)
    jxw = np.linalg.det(jac) * wts[None, :]

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return Geometry(nodes=nodes, cells=torch.as_tensor(cells, device=device), grads=t(grads),
                    shapes=t(shp), jxw=t(jxw))


@dataclass
class Dogbone:
    constrained: torch.Tensor  # (n_dofs,) bool: fixed or loaded
    loaded: torch.Tensor  # (n_dofs,) bool
    pulled: torch.Tensor  # (n_dofs,) the incremental velocity of timestep 1


def dogbone(g: Geometry, strain_rate: float, dt: float, dtype, device) -> Dogbone:
    """Base (z = 0) fixed; top fixed in x, y and pulled in z with
    strain_rate * z_max / dt imposed at timestep 1 only."""
    nodes, cells = g.nodes, g.cells.cpu().numpy()
    xyz = nodes[cells]
    d = np.linalg.norm(xyz[:, :, None, :] - xyz[:, None, :, :], axis=-1)
    delta = float(np.where(d == 0.0, np.inf, d).min()) / 10.0
    z = nodes[:, 2]
    zmax = float(z.max())
    base = np.where(np.abs(z) < delta)[0]
    top = np.where(np.abs(z - zmax) < delta)[0]
    n = 3 * len(nodes)
    fixed = np.zeros(n, dtype=bool)
    loaded = np.zeros(n, dtype=bool)
    fixed[[3 * i + c for i in base for c in range(3)]] = True
    fixed[[3 * i + c for i in top for c in (0, 1)]] = True
    loaded[[3 * i + 2 for i in top]] = True
    pulled = np.where(loaded, strain_rate * zmax / dt, 0.0)
    return Dogbone(constrained=torch.as_tensor(fixed | loaded, device=device),
                   loaded=torch.as_tensor(loaded, device=device),
                   pulled=torch.as_tensor(pulled, dtype=dtype, device=device))


def _scatter(g: Geometry, vals):
    out = torch.zeros((g.n_nodes,) + vals.shape[2:], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, g.cells.reshape(-1), vals.reshape((-1,) + vals.shape[2:]))


def nodal_mass(g: Geometry, rho_qp):
    nq = g.shapes.shape[0]
    return _scatter(g, torch.einsum("cq,qv,cq->cv", rho_qp.reshape(-1, nq), g.shapes, g.jxw))


def internal_force(g: Geometry, stress):
    nq = g.shapes.shape[0]
    sig = voigt_to_sym(stress.reshape(-1, nq, 6))
    return _scatter(g, torch.einsum("cqij,cqvj,cq->cvi", sig, g.grads, g.jxw)).reshape(-1)


def external_force(g: Geometry, rho_qp):
    f = torch.zeros((g.n_nodes, 3), dtype=rho_qp.dtype, device=rho_qp.device)
    f[:, 2] = -GRAVITY * nodal_mass(g, rho_qp)
    return f.reshape(-1)


def abs_force(g: Geometry, stress, rho_qp):
    """Per dof, the sum of the magnitudes of every term of the internal and
    gravity forces: the scale of a nodal sum's rounding, which the sum
    itself (a near-balance of neighbouring cells' terms) is not."""
    nq = g.shapes.shape[0]
    sig = voigt_to_sym(stress.reshape(-1, nq, 6)).abs()
    f = _scatter(g, torch.einsum("cqij,cqvj,cq->cvi", sig, g.grads.abs(), g.jxw.abs()))
    return f.reshape(-1) + external_force(g, rho_qp).abs()


def residual_scale(g: Geometry, bc: Dogbone, stress, rho_qp, dt):
    """The rhs norm's rounding scale: the norm of dt * :func:`abs_force` over
    the free dofs."""
    a = dt * abs_force(g, stress, rho_qp)
    return torch.linalg.vector_norm(torch.where(bc.constrained, torch.zeros_like(a), a))


def rhs(g: Geometry, bc: Dogbone, stress, rho_qp, dt):
    r = dt * (external_force(g, rho_qp) - internal_force(g, stress))
    return torch.where(bc.constrained, torch.zeros_like(r), r)


def qp_strains(g: Geometry, nodal):
    cell_u = nodal.reshape(g.n_nodes, 3)[g.cells]
    grad = torch.einsum("cvi,cqvj->cqij", cell_u, g.grads)
    return sym_to_voigt(0.5 * (grad + grad.transpose(-1, -2))).reshape(-1, 6)


# -- one macro-step -------------------------------------------------------------


def predict(g: Geometry, bc: Dogbone, st: dict, dt: float, min_strain_norm: float) -> dict:
    """begin_step + solve from the FE state ``st`` (u, v, timestep, the qp
    fields and the history ids): the increments, the qp strains, the MD
    flags and the common-ground strain each MD job takes."""
    ts = st["timestep"] + 1
    inc_v = bc.pulled if ts == 1 else torch.zeros_like(st["u"])
    mass = torch.repeat_interleave(nodal_mass(g, st["rho"]), 3)
    r = rhs(g, bc, st["new_stress"], st["rho"], dt)
    dv = torch.where(bc.constrained, torch.zeros_like(r), r / mass)
    nud = dt * (st["v"] + inc_v + dv)
    newton = qp_strains(g, nud)
    upd = st["upd_strain"] + newton
    flags = st["to_be_updated"] | (voigt_norm(upd) >= min_strain_norm)
    return dict(timestep=ts, residual=torch.linalg.vector_norm(r),
                residual_scale=residual_scale(g, bc, st["new_stress"], st["rho"], dt), inc_u=nud,
                inc_v=inc_v + dv, newton=newton, new_strain=st["new_strain"] + newton,
                upd_strain=upd, flags=flags, update_strain_cg=rotate_voigt(upd, st["rotam"]),
                most_recent_id=st["id_to_get"])


def cluster_ids(timestep: int, n_qp: int, min_steps: int, device):
    """Which qp sources each qp's stress: every qp itself until the history
    is longer than 'min steps'; the similarity merge past it is not
    followed by this reference."""
    if timestep > min_steps:
        raise NotImplementedError("the clustering merge past 'min steps' has no reference here")
    return torch.arange(n_qp, device=device)


def select_jobs(jobs, timestep: int, capacity: int):
    """The qps that run MD: the flagged, undeduplicated ones, at most
    ``capacity``, taken from a window that rotates by timestep."""
    n = jobs.shape[0]
    offset = (int(timestep) * capacity) % n
    rolled = torch.roll(jobs, -offset)
    idx = torch.nonzero(rolled).flatten()[:capacity]
    return torch.sort((idx + offset) % n).values


def job_sources(job_idx, has_run, most_recent_id):
    """Each job's starting microstate: its own if it has run, else its most
    recent provider's if that ran, else its own fresh one."""
    n_qp = has_run.shape[0]
    mri = most_recent_id[job_idx]
    mri_c = torch.clamp(mri, 0, n_qp - 1)
    ok = (mri < n_qp) & has_run[mri_c]
    return torch.where(has_run[job_idx], job_idx, torch.where(ok, mri_c, job_idx))


def length_variation(eps_cg, rotam, init_length):
    """(jobs, 6) common-ground strains -> (jobs, R, 6) box-length variations
    of each replica (rotam (R, 3, 3), init_length (R, 3))."""
    eps_rep = rotate_voigt(eps_cg[:, None, :], rotam.transpose(-1, -2)[None])
    L = init_length[None]
    return eps_rep * torch.stack([L[..., 0], L[..., 1], L[..., 2], L[..., 2], L[..., 1],
                                  L[..., 0]], -1)


def average_replicas(sigma_rep, rotam, init_stress):
    """(jobs, R, 6) replica stresses -> (jobs, 6): the init stress taken off,
    rotated to the common ground, averaged."""
    return rotate_voigt(sigma_rep - init_stress[None], rotam[None]).mean(dim=1)


def correct(g: Geometry, bc: Dogbone, st: dict, pred: dict, update_stress_cg, id_to_get,
            dt: float) -> dict:
    """apply_stress_update + reaction force + end_step: MD-flagged qps take
    their source's MD stress, the others the tangent update."""
    flags = pred["flags"]
    loc = rotate_voigt(update_stress_cg[id_to_get], st["rotam"].transpose(-1, -2))
    tangent = st["new_stress"] + contract_c66(st["stiff"], pred["newton"])
    new_stress = torch.where(flags[:, None], loc, tangent)
    res1 = torch.linalg.vector_norm(rhs(g, bc, new_stress, st["rho"], dt))
    f = internal_force(g, new_stress) - external_force(g, st["rho"])
    reaction = torch.sum(torch.where(bc.loaded, f, torch.zeros_like(f)))
    a = abs_force(g, new_stress, st["rho"])
    return dict(new_stress=new_stress, residual1=res1, reaction=reaction,
                residual1_scale=residual_scale(g, bc, new_stress, st["rho"], dt),
                reaction_scale=torch.sum(torch.where(bc.loaded, a, torch.zeros_like(a))),
                u=st["u"] + pred["inc_u"], v=st["v"] + pred["inc_v"],
                upd_strain=torch.where(flags[:, None], torch.zeros_like(pred["upd_strain"]),
                                       pred["upd_strain"]))
