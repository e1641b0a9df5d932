"""The frozen generator copy gives the port's ``io.synth`` arrays."""
import numpy as np
import pytest

from flex_tpu_torch.io import synth as port
from spmm_bench.data import synth

REDDIT = dict(n_comm=41, cross=0.128, act_mean=6.0, act_sigma=0.9,
              act_max=256, pop_sigma=1.5)
FLICKR = dict(n_comm=7, cross=0.25, act_mean=3.5, act_sigma=0.8, act_max=64,
              pop_sigma=1.4)


@pytest.mark.parametrize("m,nnz,params,seed,shuffle", [
    (2000, 30000, REDDIT, 0, True),
    (1500, 16000, FLICKR, 0, True),
    (1200, 9000, REDDIT, 3, False),
])
def test_copy_gives_the_ports_arrays(m, nnz, params, seed, shuffle):
    row_ptr, col, vals = synth.bipartite_projection_graph(
        m, nnz, seed=seed, shuffle=shuffle, **params)
    g = port.bipartite_projection_graph(m, nnz, seed=seed, shuffle=shuffle,
                                        **params)
    assert row_ptr.dtype == np.int64 and col.dtype == np.int32
    assert vals.dtype == np.float32
    np.testing.assert_array_equal(row_ptr, g.row_ptr)
    np.testing.assert_array_equal(col, g.col)
    np.testing.assert_array_equal(vals, g.vals)


def test_configs_name_the_ports_stand_ins():
    """The configurations' generator arguments are those of the port's
    reddit_posts and flickr_posts (read from their defaults by a call at a
    small size with the same keywords)."""
    import inspect
    import json
    import os

    from spmm_bench.tests.small import BENCH

    for name, params in (("reddit-gcn", REDDIT), ("flickr-gcn", FLICKR)):
        with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
            cfg = json.load(f)
        got = cfg["graph"]["params"]
        assert {k: got[k] for k in params} == params
        assert got["seed"] == 0
        inspect.signature(synth.bipartite_projection_graph).bind(**got)
    src = inspect.getsource(port.reddit_posts)
    assert "232_965, 23_446_803" in src and "cross=0.128" in src
    src = inspect.getsource(port.flickr_posts)
    assert "89_250, 989_006" in src and "cross=0.25" in src


def test_caches_are_read_back(tmp_path):
    """The graph, the port's ordering and the autotuner's choice are made
    once and read from the cache after; other arguments to ``suggest``
    make a new choice."""
    import json
    import os

    from flex_tpu_torch.sparse.csr import CSRGraph
    from spmm_bench import graphs
    from spmm_bench.tests.small import BENCH

    with open(os.path.join(BENCH, "configs", "flickr-gcn.json")) as f:
        cfg = json.load(f)
    cfg["graph"]["params"].update(m=2000, nnz_target=60000)
    arrs = synth.bipartite_projection_graph(**cfg["graph"]["params"])
    cfg["graph"].update(nodes=2000, nnz=len(arrs[1]))
    cache = str(tmp_path)

    def once():
        said = []
        arrs = graphs.load_graph(cfg["graph"], said.append, cache)
        g = CSRGraph.from_arrays(*arrs)
        perm = graphs.port_order(g, cfg["graph"], cfg["order"], said.append,
                                 cache)
        choice = graphs.port_suggest(g, cfg, said.append, cache)
        return arrs, perm, choice, said

    first = once()
    again = once()
    assert not any("from the cache" in s for s in first[3])
    assert [s.split("]")[0] for s in again[3]] == ["[graph", "[order",
                                                   "[suggest"]
    assert all("read from the cache" in s for s in again[3])
    for a, b in zip(first[0], again[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(first[1], again[1])
    assert first[2][0] == again[2][0]
    assert first[2][1].keys() == again[2][1].keys()
    key = graphs.suggest_key(cfg)
    cfg["suggest"] = dict(cfg["suggest"], k=32)
    assert graphs.suggest_key(cfg) != key
