"""Similarity-network visualiser — the reference's py2 graph-viz tool.

Numpy copy of ``scema_tpu/clustering/render_network.py`` (the port's
``run --dump-similarity`` writes the same npz).

The reference ships ``clustering/render_network.py`` (python 2): it cats
the per-rank ``__results/ID_*`` edge files into ``network.txt``, builds a
weighted networkx graph (weight = 1/distance), replays the greedy
max-degree reduction printing each pick, and draws the surviving nodes
with a spring layout.  This is its counterpart for the rebuild:

* reads the reference's edge-file format (``cell1 cell2 dist`` per line,
  one file or a glob of ``ID_*`` shards) AND the rebuild's similarity
  artifacts (an ``.npz`` with a dense ``dist`` matrix + ``threshold``,
  as written by the run loop's ``--dump-similarity`` hook);
* replays the SAME deterministic greedy reduction the production path
  uses (``reduction.reduce_graph_host`` — lowest-id tie-breaking, where
  the reference inherits dict order) and prints the pick ledger;
* renders before/after panels to a file (PNG/EPS/PDF by extension) with
  a dependency-free spring layout — matplotlib is imported lazily and
  only when rendering, so the module stays importable on slim images.

Usage:
    python -m scema_tpu_torch.clustering.render_network network.txt -o net.png
    python -m scema_tpu_torch.clustering.render_network "__results/ID_*" -o net.eps
    python -m scema_tpu_torch.clustering.render_network similarity.npz -o net.png
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from .reduction import reduce_graph_host


def load_edges(path: str):
    """Edge list (i, j, dist) from reference text shards or a rebuild npz.

    Returns (edges float array (m, 3), n_nodes).
    """
    paths = sorted(glob.glob(path)) or [path]
    if paths[0].endswith(".npz"):
        with np.load(paths[0]) as z:
            dist = np.asarray(z["dist"], np.float64)
            thr = float(z["threshold"]) if "threshold" in z else np.inf
        iu, ju = np.triu_indices(dist.shape[0], k=1)
        keep = dist[iu, ju] <= thr
        edges = np.stack([iu[keep], ju[keep], dist[iu, ju][keep]], axis=1)
        return edges, dist.shape[0]
    rows = []
    for p in paths:
        with open(p) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) != 3:
                    continue
                rows.append((int(parts[0]), int(parts[1]), float(parts[2])))
    if not rows:
        raise SystemExit(f"no edges found in {path!r}")
    edges = np.asarray(rows, np.float64)
    return edges, int(edges[:, :2].max()) + 1


def adjacency(edges: np.ndarray, n: int) -> np.ndarray:
    adj = np.zeros((n, n), bool)
    i = edges[:, 0].astype(int)
    j = edges[:, 1].astype(int)
    adj[i, j] = adj[j, i] = True
    np.fill_diagonal(adj, False)
    return adj


def spring_layout(adj: np.ndarray, iters: int = 120, seed: int = 0):
    """Fruchterman-Reingold positions, (n, 2) in [0, 1] — no networkx
    needed (the reference leans on nx.spring_layout; same algorithm)."""
    n = adj.shape[0]
    rng = np.random.default_rng(seed)
    pos = rng.uniform(size=(n, 2))
    k = 1.0 / max(np.sqrt(n), 1.0)
    t = 0.1
    for _ in range(iters):
        d = pos[:, None, :] - pos[None, :, :]
        r2 = (d * d).sum(-1) + 1e-9
        rep = k * k * d / r2[..., None]
        att = -np.where(adj[..., None], np.sqrt(r2)[..., None] / k, 0.0) * d
        disp = (rep + att).sum(axis=1)
        norm = np.sqrt((disp * disp).sum(-1, keepdims=True)) + 1e-9
        pos += disp / norm * np.minimum(norm, t)
        pos = np.clip(pos, 0.0, 1.0)
        t *= 0.97
    return pos


def render(edges: np.ndarray, n: int, out: str, show_labels: bool = False):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    adj = adjacency(edges, n)
    mapping = reduce_graph_host(adj)
    picks = np.unique(mapping[mapping != np.arange(n)])
    # pick ledger, like the reference's stdout trace
    for node in picks:
        members = np.flatnonzero(mapping == node)
        print(f"Max degree node = {node}  absorbs {members.size} qps: "
              f"{members.tolist()}")
    kept = np.unique(mapping)
    print(f"{n} qps, {len(edges)} similarity edges -> "
          f"{kept.size} MD simulations ({n - kept.size} deduplicated)")

    pos = spring_layout(adj)
    fig, axes = plt.subplots(1, 2, figsize=(11, 5.2))
    for ax, title, nodes in (
            (axes[0], f"similarity network ({n} qps)", np.arange(n)),
            (axes[1], f"after reduction ({kept.size} sims)", kept)):
        for a, b, _ in edges:
            a, b = int(a), int(b)
            if title.startswith("after") and not (
                    mapping[a] == a and mapping[b] == b):
                continue
            ax.plot(*zip(pos[a], pos[b]), lw=0.4, color="0.55", zorder=1)
        sel = np.zeros(n, bool)
        sel[nodes] = True
        ax.scatter(pos[sel, 0], pos[sel, 1], s=14, alpha=0.8, zorder=2)
        if show_labels:
            for i in np.flatnonzero(sel):
                ax.annotate(str(i), pos[i], fontsize=6)
        ax.set_title(title)
        ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    print(f"wrote {out}")
    return mapping


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("edges", help="network.txt / 'ID_*' glob / similarity.npz")
    ap.add_argument("-o", "--out", default="network.png",
                    help="output image (extension picks the format)")
    ap.add_argument("--labels", action="store_true", help="draw qp ids")
    args = ap.parse_args(argv)
    edges, n = load_edges(args.edges)
    render(edges, n, args.out, show_labels=args.labels)


if __name__ == "__main__":
    main()
