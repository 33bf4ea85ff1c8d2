"""The port's similarity-network tool (``clustering/render_network.py``, a
numpy copy of the JAX package's) and ``reduction.reduce_graph_host``:
mirrors of tests/test_render_network.py and of tests/test_clustering.py's
networkx case, on the CPU.

The reference edge shards and npz are written by the tests; the
``--dump-similarity`` round trip runs the port's own CLI on a 1x1x2-cell
dogbone (16 qps, Hooke's law, 2 steps; the JAX test reads the reference's
3x3x8 config, which is absent, and is marked slow: drawing the ~93k edges
of its 576 qps takes over a minute).  Every comparison is exact: the
same numpy arithmetic on the same inputs."""
import json

import numpy as np
import pytest

from scema_tpu.clustering import reduction as JR
from scema_tpu.clustering import render_network as JRN

from scema_tpu_torch import cli
from scema_tpu_torch.clustering.reduction import reduce_graph_host
from scema_tpu_torch.clustering.render_network import (adjacency, load_edges, render,
                                                        spring_layout)

from torch_port_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _write_reference_shards(tmp_path):
    # two per-rank shards, reference format: "cell1 cell2 dist"
    (tmp_path / "ID_0").write_text("0 1 0.5\n1 2 0.25\n")
    (tmp_path / "ID_1").write_text("3 4 0.125\n")
    return str(tmp_path / "ID_*")


def test_load_reference_edge_shards(tmp_path):
    path = _write_reference_shards(tmp_path)
    edges, n = load_edges(path)
    assert n == 5 and edges.shape == (3, 3)
    assert edges[0].tolist() == [0.0, 1.0, 0.5]
    jedges, jn = JRN.load_edges(path)
    assert jn == n and np.array_equal(jedges, edges)


def test_load_npz_distance_matrix(tmp_path):
    rng = np.random.default_rng(0)
    d = rng.uniform(1.0, 2.0, size=(6, 6))
    d = (d + d.T) / 2
    np.fill_diagonal(d, 0.0)
    d[0, 1] = d[1, 0] = 0.1
    d[2, 3] = d[3, 2] = 0.2
    p = tmp_path / "sim.npz"
    np.savez(p, dist=d, threshold=0.5)
    edges, n = load_edges(str(p))
    assert n == 6
    assert sorted(map(tuple, edges[:, :2].astype(int))) == [(0, 1), (2, 3)]


def test_render_mapping_matches_production_reduction(tmp_path):
    edges, n = load_edges(_write_reference_shards(tmp_path))
    out = tmp_path / "net.png"
    mapping = render(edges, n, str(out))
    assert out.exists() and out.stat().st_size > 0
    np.testing.assert_array_equal(mapping, reduce_graph_host(adjacency(edges, n)))
    np.testing.assert_array_equal(mapping, JR.reduce_graph_host(JRN.adjacency(edges, n)))


def test_spring_layout_shapes_and_bounds():
    adj = np.zeros((8, 8), bool)
    adj[0, 1] = adj[1, 0] = True
    pos = spring_layout(adj, iters=30)
    assert pos.shape == (8, 2)
    assert np.all(pos >= 0.0) and np.all(pos <= 1.0)
    assert np.array_equal(pos, JRN.spring_layout(adj, iters=30))
    assert np.isfinite(np.linalg.norm(pos[0] - pos[1]))


def test_cli_dump_similarity_roundtrip(tmp_path):
    """The port's ``run --dump-similarity`` writes an npz render_network
    reads."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"continuum mesh": {"input": {
        "style": "cuboid", "x length": 0.03, "y length": 0.03, "z length": 0.08,
        "x cells": 1, "y cells": 1, "z cells": 2}}}))
    out = tmp_path / "sim.npz"
    assert cli.main(["run", str(cfg), "--hooke", "--cpu", "--steps", "2",
                     "--dump-similarity", str(out)]) == 0
    edges, n = load_edges(str(out))
    assert n == 16  # 1x1x2 dogbone qp count
    png = tmp_path / "net.png"
    render(edges, n, str(png))
    assert png.exists()


def _nx_reduce(adj):
    """tests/test_clustering.py's networkx reference of the greedy
    reduction."""
    import networkx as nx

    n = adj.shape[0]
    G = nx.Graph()
    G.add_nodes_from(range(n))
    for i in range(n):
        for j in range(i + 1, n):
            if adj[i, j]:
                G.add_edge(i, j)
    mapping = list(range(n))
    while len(G) > 0:
        degs = dict(G.degree())
        maxdeg = max(degs.values())
        node = min(k for k, v in degs.items() if v == maxdeg)
        mapping[node] = node
        neigh = [node] + list(nx.all_neighbors(G, node))
        for m in neigh[1:]:
            mapping[m] = node
        G.remove_nodes_from(neigh)
    return np.asarray(mapping)


def test_reduce_graph_host_matches_networkx():
    rng = np.random.default_rng(2)
    for trial in range(5):
        n = 20
        adj = rng.random((n, n)) < 0.15
        adj = adj | adj.T
        np.fill_diagonal(adj, False)
        got = reduce_graph_host(adj)
        assert (got == _nx_reduce(adj)).all(), trial
        assert np.array_equal(got, JR.reduce_graph_host(adj)) and got.dtype == np.int32
