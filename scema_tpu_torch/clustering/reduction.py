"""Greedy max-degree graph reduction -> qp dedup mapping.

Torch twin of ``scema_tpu/clustering/reduction.py`` (reference:
clustering/coarsegrain_dependency_network.py:59-90 via FE_problem.h:1248-1262):
repeatedly take the highest-degree node of the similarity graph, map it and
its neighbours to it, and remove them.  Ties go to the lowest node id.

The loop keeps the JAX semantics: at most ``min(n, max_picks)`` picks, and
a pick with no active node left changes nothing.  Because such picks are
no-ops, the loop stops at the first one instead of running them out.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import trace


def reduce_graph(adj: torch.Tensor, max_picks: int = 512,
                 return_saturated: bool = False):
    """(n, n) bool adjacency -> (n,) int64 mapping (qp -> source qp).

    With ``return_saturated`` also returns a bool tensor that is True when
    the pick cap truncated the reduction (an edge between two still-active
    nodes remains)."""
    n = adj.shape[0]
    ids = torch.arange(n, device=adj.device)
    mapping = ids.clone()
    active = adj.any(dim=1)
    for _ in range(min(n, max_picks)):
        with trace.sync("cluster.reduce"):
            if not bool(active.any()):
                break
        live = adj & active[:, None] & active[None, :]
        deg = live.sum(dim=1)
        score = torch.where(active, deg, torch.full_like(deg, -1))
        # argmax of the first maximal entry: the lowest id among ties
        node = int(torch.argmax(score))
        neigh = live[node]
        mapping = torch.where(neigh, torch.full_like(mapping, node), mapping)
        active = active & ~(neigh | (ids == node))
    if return_saturated:
        live = adj & active[:, None] & active[None, :]
        return mapping, live.any()
    return mapping


def reduce_graph_host(adj: np.ndarray) -> np.ndarray:
    """Host (numpy) twin of :func:`reduce_graph` without the pick cap, for
    tools and tests (reduction.py:77-92)."""
    n = adj.shape[0]
    adj = adj.copy()
    mapping = np.arange(n, dtype=np.int32)
    active = adj.any(axis=1)
    while active.any():
        live = adj & active[:, None] & active[None, :]
        deg = live.sum(axis=1)
        score = np.where(active, deg, -1)
        node = int(np.argmax(score))
        neigh = live[node]
        mapping[neigh] = node
        active &= ~neigh
        active[node] = False
    return mapping
