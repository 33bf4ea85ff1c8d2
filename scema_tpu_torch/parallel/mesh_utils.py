"""Process meshes and collectives over ``torch.distributed``.

Torch twin of ``scema_tpu/parallel/mesh_utils.py``.  The JAX package runs
one program over a mesh of devices (``shard_map`` over named axes); here
every rank is a process of its own, started by ``torchrun`` or
``torch.multiprocessing.spawn``, that runs the same Python with its own
block of the batch, and the collectives are written out: an
``all_gather`` where JAX gathers a sharded output, an ``all_reduce``
where it takes a ``psum``.  This replaces the reference's MPI process
groups as the JAX package does (stmd_sync.h:189-278, 570-618; the
Gatherv/Bcast of FE_problem.h:1381-1467, dealammps.cc:406-415).

Conventions, as in the JAX package: axis ``"md"`` is the MD-job /
quadrature-point batch axis; a two-axis mesh ``("dcn", "md")`` stands for
several slices (the reference's P8 multi-allocation path); a job or qp
batch splits into contiguous blocks over ALL mesh axes, row-major.

The mesh is a torch ``DeviceMesh`` over the initialised default group.
Its device type names the backend's home: ``"cuda"`` under NCCL,
``"cpu"`` under gloo, a host backend, whatever device the tensors are on.
A rank outside a mesh of fewer ranks than the world computes unsharded,
alone.

The collective helpers (:func:`all_reduce`, :func:`all_gather`,
:func:`reduce_scatter`, :func:`broadcast`) hand the tensor to the group's
backend as it is: NCCL takes device tensors, and gloo, whose support for
CUDA tensors differs per collective, takes them in each of these four.
Checked on one H100 80GB HBM3 (torch 2.11.0+cu128, gloo, two ranks on
``cuda:0``, each collective on float32 tensors in a pair of processes of
its own; chip_smoke.py phase 29 repeats the check): ``all_reduce``,
``broadcast``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``, the
list ``all_gather`` and ``barrier`` take CUDA tensors and give the right
sums; ``send``/``recv`` of a CUDA tensor kills the process (gloo's TCP
pair writes from the device pointer), so the port sends nothing point to
point.  NCCL at world 1 takes all six.  No tensor is staged on the host.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..utils import trace


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks of the default group; 1 when none is initialised."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group; 0 when none is initialised."""
    return dist.get_rank() if is_initialized() else 0


def _need_group() -> None:
    if not is_initialized():
        raise RuntimeError("no default process group: call "
                           "torch.distributed.init_process_group first (torchrun sets "
                           "its environment)")


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n: int | None = None, axis: str = "md"):
    """A one-axis mesh over the first ``n`` ranks of the default group (all
    of them when ``n`` is None).  Raises ValueError if the group has fewer
    than ``n`` ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    _need_group()
    w = world_size()
    n = w if n is None else n
    if n > w:
        raise ValueError(f"need {n} ranks, the default group has {w}")
    return DeviceMesh(_mesh_device_type(), torch.arange(n), mesh_dim_names=(axis,))


def make_multislice_mesh(n_slices: int, per_slice: int,
                         axes: tuple[str, str] = ("dcn", "md")):
    """Two-tier mesh for the reference's P8 multi-allocation path
    (stmd_sync.h:728-855): the outer axis enumerates slices, the inner the
    ranks within one; the job batch splits over both (mesh_utils.py:34-58).
    It spans every rank of the default group (the job axis's group is the
    default one); ValueError for any other count."""
    from torch.distributed.device_mesh import DeviceMesh

    _need_group()
    n = n_slices * per_slice
    if n != world_size():
        raise ValueError(f"need {n} ranks, the default group has {world_size()}")
    return DeviceMesh(_mesh_device_type(), torch.arange(n).reshape(n_slices, per_slice),
                      mesh_dim_names=tuple(axes))


def _dim(mesh, axis) -> int:
    return mesh.mesh_dim_names.index(axis) if isinstance(axis, str) else int(axis)


def mesh_group(mesh, axis=None):
    """The process group of one mesh axis, or (``axis`` None) of all its
    ranks; None for a rank outside the mesh."""
    if mesh.get_coordinate() is None:
        return None
    if axis is not None:
        return mesh.get_group(_dim(mesh, axis))
    return mesh.get_group(0) if mesh.ndim == 1 else dist.group.WORLD


def mesh_rank(mesh, axis=None) -> int | None:
    """This rank's index along one mesh axis, or (``axis`` None) its
    row-major index over all axes; None outside the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    if axis is not None:
        return coord[_dim(mesh, axis)]
    flat = 0
    for c, s in zip(coord, mesh.shape):
        flat = flat * s + c
    return flat


def mesh_size(mesh, axis=None) -> int:
    return mesh.size() if axis is None else mesh.size(_dim(mesh, axis))


# -- collectives


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (a new tensor; ``x`` as it
    is for a group of one)."""
    y = x.detach().clone()
    with trace.collective("all_reduce", y):
        dist.all_reduce(y, group=group)
    return y


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``x`` of the rank ``src`` (a global rank) on every rank of the group."""
    y = x.detach().clone().contiguous()
    with trace.collective("broadcast", y):
        dist.broadcast(y, src, group=group)
    return y


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along axis 0 in rank
    order: JAX's ``all_gather(..., tiled=True)``."""
    x = x.detach().contiguous()
    w = dist.get_world_size(group)
    out = torch.empty((w * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    with trace.collective("all_gather", out):
        dist.all_gather_into_tensor(out, x, group=group)
    return out


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's block (axis 0, rank order) of the sum of ``x`` over the
    group; ``x.shape[0]`` must divide by the group's size."""
    x = x.detach().contiguous()
    w = dist.get_world_size(group)
    if x.shape[0] % w:
        raise ValueError(f"reduce_scatter: {x.shape[0]} rows over {w} ranks")
    out = torch.empty((x.shape[0] // w,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    with trace.collective("reduce_scatter", out):
        dist.reduce_scatter_tensor(out, x, group=group)
    return out


# -- sharded functions


def pad_to_multiple(x: torch.Tensor, m: int, axis: int = 0, fill=0):
    """(x padded along ``axis`` with ``fill`` to a multiple of m, the
    original length)."""
    n = x.shape[axis]
    rem = (-n) % m
    if rem == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], axis), n


def block(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Block i of n equal contiguous blocks of axis 0."""
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def shard_pairwise_l2(mesh, axis: str = "md"):
    """Sharded pairwise-L2 distances (mesh_utils.py:72-98), the analog of
    the reference's ring all-to-all history comparison
    (strain2spline.h:546-614): each rank takes its row block of the
    splines, ``all_gather``s the spline set, computes its rows of the
    distance matrix, and the rows are gathered.  Returns a function
    (splines (n, d)) -> (n, n)."""
    n_dev = mesh_size(mesh, axis)

    def wrapped(splines: torch.Tensor) -> torch.Tensor:
        padded, n = pad_to_multiple(splines, n_dev)
        r = mesh_rank(mesh, axis)
        if r is None:
            local, full = padded, padded
        else:
            group = mesh_group(mesh, axis)
            local = block(padded, r, n_dev)
            full = all_gather(local, group)
        diff = local[:, None, :] - full[None, :, :]
        rows = torch.sqrt(torch.sum(diff * diff, dim=-1))
        out = rows if r is None else all_gather(rows, mesh_group(mesh, axis))
        return out[:n, :n]

    return wrapped


def broadcast_job_inputs(jobs, eps_cg, most_recent_id, group=None):
    """The (jobs, eps_cg, most_recent_id) of the group's first rank on
    every rank of it, in one broadcast (float64 holds the ids and float32
    strains exactly).  Ranks that each step a replicated FE state sum in
    their own atomic order on the card, so a flag can flip on one rank
    alone; every rank then works on the first rank's job list, and the
    first rank's copy of the state is the one written out."""
    packed = torch.cat([jobs[:, None].double(), eps_cg.double(),
                        most_recent_id[:, None].double()], 1)
    src = 0 if group is None else dist.get_global_rank(group, 0)
    packed = broadcast(packed, src, group)
    return (packed[:, 0] > 0.5, packed[:, 1:7].to(eps_cg.dtype),
            packed[:, 7].to(most_recent_id.dtype))


def shard_md_update(md_update_fn, mesh, axis=None):
    """Wrap a dense per-qp ``md_update_fn(eps_cg, material, jobs,
    most_recent_id)`` so each rank computes its contiguous block of qps
    (the reference's round-robin job->batch assignment, stmd_sync.h:583,
    as a block distribution; mesh_utils.py:101-136).  Over more than one
    rank the mesh's first rank's strains, jobs and ids are broadcast first
    (:func:`broadcast_job_inputs`), the four inputs are padded to a
    multiple of the mesh size, the blocks span every mesh axis unless
    ``axis`` names one, and the result is all-gathered, because the dedup
    gather downstream (``update_stress_cg[id_to_get]``) may cross
    blocks."""
    n_dev = mesh_size(mesh, axis)

    @functools.wraps(md_update_fn)
    def wrapped(eps_cg, material, jobs, most_recent_id):
        r = mesh_rank(mesh, axis)
        if r is None:
            return md_update_fn(eps_cg, material, jobs, most_recent_id)
        if n_dev > 1:
            jobs, eps_cg, most_recent_id = broadcast_job_inputs(
                jobs, eps_cg, most_recent_id, mesh_group(mesh, axis))
        eps_p, n = pad_to_multiple(eps_cg, n_dev)
        args = [block(eps_p, r, n_dev)] + [block(pad_to_multiple(a, n_dev)[0], r, n_dev)
                                           for a in (material, jobs, most_recent_id)]
        local = md_update_fn(*args)
        return all_gather(local, mesh_group(mesh, axis))[:n]

    return wrapped
