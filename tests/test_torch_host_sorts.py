"""Port host-side graph work against the reference: the sorts and loops
of `graphs/csr.py`, `graphs/datasets.py`, `core/partition.py`,
`core/reorder.py` and `sampling/neighbor.py` that the port computes
another way (packed-key sorts, a per-row partial sort, a vectorized tile
fill) must give the reference's arrays on the same inputs.

Tolerance: bit-equal everywhere (the same numpy values in both packages;
only the way they are computed differs).
"""
import numpy as np
import pytest

import repro.core.partition as j_partition
import repro.core.reorder as j_reorder
import repro.graphs.csr as j_csr
import repro.graphs.datasets as j_datasets
import repro.sampling.neighbor as j_neighbor

import repro_torch.core.partition as t_partition
import repro_torch.core.reorder as t_reorder
import repro_torch.graphs.csr as t_csr
import repro_torch.graphs.datasets as t_datasets
import repro_torch.sampling.neighbor as t_neighbor
from repro_torch.models.gnn import gcn_edge_values


def _graphs():
    return {
        "power-law": t_csr.random_power_law(3000, 12.0, seed=1),
        "dense-power-law": t_csr.random_power_law(2000, 60.0, seed=2),
        "community": t_csr.random_community_graph(40, 30, seed=3),
    }


def _jg(g):
    return j_csr.CSRGraph(g.indptr.copy(), g.indices.copy())


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


class _TiedKeys:
    """A generator stand-in whose ``random`` draws only four values, so
    many candidate edges of a row share a key: equal keys must be taken
    by position, as the reference's stable lexsort takes them."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def random(self, k):
        return np.floor(self.rng.random(k) * 4) / 4


@pytest.mark.parametrize("name", ["power-law", "dense-power-law",
                                  "community"])
@pytest.mark.parametrize("fanout", [1, 3, 10, 50])
@pytest.mark.parametrize("tied", [False, True])
def test_sample_frontier_bit_equal(name, fanout, tied):
    g = _graphs()[name]
    frontier = np.unique(np.random.default_rng(fanout).integers(
        0, g.num_nodes, 300))

    def rng():
        return (_TiedKeys(fanout) if tied
                else np.random.default_rng((fanout, 5)))
    _equal(t_neighbor.sample_frontier(g, frontier, fanout, rng()),
           j_neighbor.sample_frontier(_jg(g), frontier, fanout, rng()))


@pytest.mark.parametrize("name", ["power-law", "dense-power-law",
                                  "community"])
def test_community_labels_and_renumber_bit_equal(name):
    g = _graphs()[name]
    np.testing.assert_array_equal(
        t_reorder.community_labels(g, seed=4),
        j_reorder.community_labels(_jg(g), seed=4))
    np.testing.assert_array_equal(t_reorder.renumber(g, seed=4),
                                  j_reorder.renumber(_jg(g), seed=4))


@pytest.mark.parametrize("name", ["power-law", "community"])
def test_permute_bit_equal(name):
    g = _graphs()[name]
    perm = np.random.default_rng(6).permutation(g.num_nodes)
    vals = np.random.default_rng(7).random(g.num_edges).astype(np.float32)
    a, b = g.permute(perm), _jg(g).permute(perm)
    _equal((a.indptr, a.indices), (b.indptr, b.indices))
    np.testing.assert_array_equal(g.permute_edge_vals(perm, vals),
                                  _jg(g).permute_edge_vals(perm, vals))


@pytest.mark.parametrize("self_loops", [False, True])
@pytest.mark.parametrize("knobs", [
    dict(gs=4, gpt=8, ont=8, src_win=2048),
    dict(gs=16, gpt=16, ont=8, src_win=512),
    dict(gs=2, gpt=4, ont=4, src_win=64)])
def test_partition_and_transpose_bit_equal(self_loops, knobs):
    """GCN's self loops put each row's own id first, so its rows arrive
    unsorted: the packed sort must order them as the lexsort did."""
    g = _graphs()["power-law"]
    vals = None
    if self_loops:
        g, vals = gcn_edge_values(g)
    jg = _jg(g)
    _equal(t_partition._sort_rows_by_neighbor(g, vals),
           j_partition._sort_rows_by_neighbor(jg, vals))
    gT, vT, perm = t_partition.transpose_graph(g, vals)
    jgT, jvT, jperm = j_partition.transpose_graph(jg, vals)
    _equal((gT.indptr, gT.indices, vT, perm),
           (jgT.indptr, jgT.indices, jvT, jperm))
    a = t_partition.partition_graph(g, edge_vals=vals, **knobs)
    b = j_partition.partition_graph(jg, edge_vals=vals, **knobs)
    fields = ("nbrs", "edge_val", "local_node", "tile_node_block",
              "tile_window", "edge_slot", "edge_pos")
    _equal([getattr(a, f) for f in fields], [getattr(b, f) for f in fields])


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("symmetrize", [False, True])
def test_from_edges_bit_equal(dedup, symmetrize):
    rng = np.random.default_rng(8)
    src, dst = rng.integers(0, 500, 4000), rng.integers(0, 500, 4000)
    a = t_csr.from_edges(500, src, dst, symmetrize=symmetrize, dedup=dedup)
    b = j_csr.from_edges(500, src, dst, symmetrize=symmetrize, dedup=dedup)
    _equal((a.indptr, a.indices), (b.indptr, b.indices))


@pytest.mark.parametrize("name", ["pubmed", "reddit", "artist",
                                  "proteins_full"])
def test_make_dataset_keeps_its_graph_and_draws_features(name):
    """A second call reuses the first call's graph; features are drawn
    anew at each width and equal the reference's."""
    kw = dict(scale=0.02, max_nodes=3000, seed=3)
    g1, spec, f1 = t_datasets.make_dataset(name, max_dim=8, **kw)
    g2, _, f2 = t_datasets.make_dataset(name, max_dim=4, **kw)
    assert g2 is g1
    jg, jspec, jf = j_datasets.make_dataset(name, max_dim=4, **kw)
    assert spec.name == jspec.name
    _equal((g2.indptr, g2.indices, f2), (jg.indptr, jg.indices, jf))
    assert f1.shape == (g1.num_nodes, min(8, spec.dim))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("size", [0, 1, 5000])
def test_sorted_unique_is_np_unique(dtype, size):
    a = np.random.default_rng(size).integers(0, 700, size).astype(dtype)
    u = t_csr.sorted_unique(a)
    assert u.dtype == np.unique(a).dtype
    np.testing.assert_array_equal(u, np.unique(a))


@pytest.mark.parametrize("share", [0.001, 0.01, 0.05])
def test_apply_delta_bit_equal(share):
    """A stream delta (insertions, deletions, new nodes) applied to the
    power-law graph: the new CSR, its dirty rows, edge origins and
    inserted values equal the reference's."""
    g = _graphs()["dense-power-law"]
    delta = next(t_datasets.interaction_stream(
        g, num_batches=1, edges_per_batch=max(8, int(g.num_edges * share)),
        seed=9))
    a, b = g.apply_delta(delta), _jg(g).apply_delta(delta)
    _equal((a.graph.indptr, a.graph.indices, a.dirty_rows, a.edge_origin,
            a.inserted_val),
           (b.graph.indptr, b.graph.indices, b.dirty_rows, b.edge_origin,
            b.inserted_val))
