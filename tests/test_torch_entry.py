"""The port's counterparts of ``__graft_entry__.py``
(``flex_tpu_torch/entry.py``) on the CPU against the JAX package's:
``entry()``'s GCN forward against the JAX ``model.apply`` with the
parameters carried across by ``convert.gcn_params_from_numpy`` (rtol =
atol = 1e-5), and ``dryrun_multichip(n)`` on a CPU mesh, whose training
step's loss equals the JAX step's on the same R-MAT graph, labels and
initial parameters (rtol 1e-4): rows only at n = 2 and 3, the 2-D ("x",
"y") mesh at n = 4 and 8, as the JAX dry run chooses."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh as JMesh
from flex_tpu.io import make_features as j_make_features
from flex_tpu.models import GCN as JGCN
from flex_tpu.models import make_train_step as j_make_train_step
from flex_tpu.ops.ell_spmm import prepare_ell as j_prepare_ell
from flex_tpu.parallel import prepare_ell_sharded as j_prepare_ell_sharded
from flex_tpu.parallel.gcn_sharded import (
    make_train_step_2d as j_make_train_step_2d,
)

from flex_tpu_torch.convert import gcn_params_from_numpy
from flex_tpu_torch.entry import (
    PUBMED_EDGES, PUBMED_NODES, dryrun_graph, dryrun_multichip, entry,
    pubmed_sized_graph,
)
from flex_tpu_torch.io import make_features, rmat_graph
from flex_tpu_torch.models import GCN
from test_torch_ell import jax_graph


@pytest.mark.parametrize("m, nnz, seed", [(2048, 32768, 3), (777, 5000, 1)])
def test_entry_forward_matches_jax_apply(m, nnz, seed):
    g = rmat_graph(m, nnz, seed=seed, name="pubmed")
    fn, (model, plan, X) = entry(g, device="cpu")
    assert tuple(X.shape) == (g.n, 64)
    jmodel = JGCN(d_in=64, d_hidden=32, n_classes=g.label_width, nnz=g.nnz)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    gcn_params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                          model)
    with torch.no_grad():
        out = fn(model, plan, X).numpy()
    ref = np.asarray(jmodel.apply(jparams, j_prepare_ell(jax_graph(g)),
                                  jnp.asarray(j_make_features(
                                      jax_graph(g), 64))))
    assert out.shape == ref.shape == (g.m, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_entry_defaults_to_a_pubmed_sized_graph():
    g = pubmed_sized_graph()
    assert (g.m, g.label_width) == (PUBMED_NODES, 3)
    assert 0 < g.nnz <= PUBMED_EDGES
    fn, (model, plan, X) = entry(device="cpu")
    with torch.no_grad():
        out = fn(model, plan, X)
        again = fn(model, plan, X)
    assert tuple(out.shape) == (PUBMED_NODES, 3)
    assert bool(torch.isfinite(out).all()) and torch.equal(out, again)
    assert model.nnz == g.nnz


def _jax_first_loss(n):
    """The JAX dry run's training step (``__graft_entry__._dryrun_body``)
    from the port's initial parameters: its loss."""
    g = dryrun_graph(n)
    jg = jax_graph(g)
    devs = np.asarray(jax.devices()[:n])
    two_d = n >= 4 and n % 2 == 0
    mesh = (JMesh(devs.reshape(n // 2, 2), ("x", "y")) if two_d
            else JMesh(devs, ("x",)))
    plan = j_prepare_ell_sharded(jg, mesh, axis="x")
    jmodel = JGCN(d_in=16, d_hidden=16, n_classes=4, nnz=g.nnz)
    port = GCN(16, 16, 4, nnz=g.nnz,
               generator=torch.Generator().manual_seed(0))
    params = {k: jnp.asarray(v.detach().numpy())
              for k, v in port.named_parameters()}
    opt = optax.adam(1e-2)
    step = (j_make_train_step_2d(jmodel, plan, opt, mesh, model_axis="y")
            if two_d else j_make_train_step(jmodel, plan, opt))
    rng = np.random.default_rng(0)
    X = jnp.asarray(j_make_features(jg, 16))
    y = jnp.asarray(rng.integers(0, 4, g.m).astype(np.int32))
    _, _, loss = step(params, opt.init(params), X, y,
                      jnp.ones((g.m,), jnp.float32))
    return float(loss)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_dryrun_multichip_first_loss_matches_jax(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    loss = dryrun_multichip(n, device="cpu")
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, _jax_first_loss(n), rtol=1e-4)


def test_dryrun_graph_matches_the_jax_one():
    from flex_tpu.io.synth import rmat_graph as j_rmat_graph

    g = dryrun_graph(4)
    jg = j_rmat_graph(256, 2048, seed=0, name="dryrun")
    assert np.array_equal(g.row_ptr, jg.row_ptr)
    assert np.array_equal(g.col, jg.col)
    assert np.array_equal(g.vals, jg.vals)
    assert np.array_equal(make_features(g, 16), j_make_features(jg, 16))
