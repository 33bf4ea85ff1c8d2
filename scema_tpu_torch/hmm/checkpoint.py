"""Two-scale checkpoint / restart.

Torch twin of ``scema_tpu/hmm/checkpoint.py`` (reference: the macroscale
solution/velocity and per-qp history, FEProblem::checkpoint/restart,
FE_problem.h:2278-2335, 540-712, and the microscale per-qp LAMMPS restart
dumps, stmd_problem.h:266-273).  Both scales live in one carry, ``FEState``
or ``(FEState, (MicroStates, ...))``, so a checkpoint is one compressed npz
of the carry's leaves.

The file is the JAX package's layout: ``leaf_{i}`` in the order of
``jax.tree_util.tree_flatten`` on the same carry (dataclass and NamedTuple
fields in declaration order, tuples in order, ``None`` dropped), with the
JAX package's dtypes: the port's int64 index fields as int32, and its
Python scalars ``FEState.timestep``, ``FEState.time`` and
``HistoryState.count`` as 0-d int32 / FE-dtype / int32 arrays.  A
checkpoint of either package therefore restores in the other (on the card,
with float32 FE, ``time`` comes back rounded to float32, as in the JAX
package).  The write is atomic (a temporary file, then ``os.replace``).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def _fields(node) -> list | None:
    """The children of a carry node in JAX's flattening order, or None for
    a leaf."""
    if dataclasses.is_dataclass(node):
        return [getattr(node, f.name) for f in dataclasses.fields(node)]
    if isinstance(node, (tuple, list)):
        return list(node)
    return None


def _flatten(node, fdtype=np.float64) -> list:
    """[(leaf, numpy array)] of a carry; a float scalar takes ``fdtype``,
    the dtype of the enclosing FE state's vectors."""
    if node is None:
        return []
    if torch.is_tensor(node):
        a = node.detach().cpu().numpy()
        return [(node, a.astype(np.int32) if a.dtype == np.int64 else a)]
    if isinstance(node, bool):
        raise TypeError("a checkpoint carry holds no Python bools")
    if isinstance(node, int):
        return [(node, np.asarray(node, np.int32))]
    if isinstance(node, float):
        return [(node, np.asarray(node, fdtype))]
    children = _fields(node)
    if children is None:
        raise TypeError(f"cannot checkpoint a {type(node).__name__}")
    u = getattr(node, "u", None)
    if torch.is_tensor(u):  # an FEState: its time takes the FE dtype
        fdtype = torch.empty(0, dtype=u.dtype).numpy().dtype
    return [leaf for c in children for leaf in _flatten(c, fdtype)]


def save_checkpoint(path: str, carry) -> None:
    """Serialize an HMM carry (FEState or (FEState, MicroStates...)), or an
    MD state, to npz."""
    arrays = {f"leaf_{i}": a for i, (_, a) in enumerate(_flatten(carry))}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def _restore(template, data):
    """template's structure with its leaves taken, in order, from the
    iterator ``data``."""
    if template is None:
        return None
    if torch.is_tensor(template):
        a = next(data)
        if tuple(a.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint leaf of shape {a.shape} where the carry "
                             f"holds {tuple(template.shape)}")
        return torch.as_tensor(a).to(device=template.device, dtype=template.dtype)
    if isinstance(template, int):
        return int(next(data))
    if isinstance(template, float):
        return float(next(data))
    children = [_restore(c, data) for c in _fields(template)]
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: c for f, c in zip(dataclasses.fields(template), children)})
    if hasattr(template, "_fields"):  # NamedTuple
        return type(template)(*children)
    return type(template)(children)


def load_checkpoint(path: str, template):
    """Restore a carry saved by :func:`save_checkpoint` (or by the JAX
    package's) into ``template``'s structure, dtypes and devices."""
    n = len(_flatten(template))
    with np.load(path) as data:
        if len(data.files) != n:
            raise ValueError(f"{path}: {len(data.files)} leaves, the carry has {n}")
        return _restore(template, iter([data[f"leaf_{i}"] for i in range(n)]))
