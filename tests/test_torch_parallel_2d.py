"""2-D sharded GCN training of the PyTorch port (rows over "x" in a sharded
plan, the weights' column blocks over "y") against the JAX package's
``make_train_step_2d`` on the CPU (the counterparts of
tests/test_parallel_2d.py and tests/test_final.py::test_2d_train_odd_classes):
the same initial parameters (carried across by
``convert.gcn_params_from_numpy``), X, y and mask; one SGD step each.  The
loss and the updated parameters agree at rtol = atol = 1e-4, and the 2-D
loss equals the one-device step's."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh as JMesh
from flex_tpu.models import GCN as JGCN
from flex_tpu.parallel import prepare_ell_sharded as j_prepare_ell_sharded
from flex_tpu.parallel.gcn_sharded import (
    make_train_step_2d as j_make_train_step_2d,
)
from flex_tpu.parallel.gcn_sharded import shard_params_2d as j_shard_params_2d

from flex_tpu_torch.convert import gcn_params_from_numpy
from flex_tpu_torch.io import make_features, rmat_graph
from flex_tpu_torch.models import GCN, make_train_step
from flex_tpu_torch.ops.ell_spmm import prepare_ell
from flex_tpu_torch.parallel import (
    Mesh, make_mesh, make_train_step_2d, prepare_ell_sharded,
    prepare_windowed_sharded, shard_params_2d,
)
from flex_tpu_torch.parallel.gcn_sharded import column_sharded_matmul
from test_torch_sharded import _community
from test_torch_ell import jax_graph

needs_8dev = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _rmat():
    return rmat_graph(2048, 32768, seed=3, name="small_rmat")


def _meshes(x, y):
    port = Mesh(np.asarray(make_mesh(x * y, device="cpu").devices).reshape(
        x, y), ("x", "y"))
    jmesh = JMesh(np.asarray(jax.devices()[:x * y]).reshape(x, y),
                  ("x", "y"))
    return port, jmesh


def _data(g, d_in, n_cls, seed=0):
    rng = np.random.default_rng(seed)
    X = make_features(g, d_in)
    y = rng.integers(0, n_cls, g.m).astype(np.int32)
    mask = (rng.random(g.m) < 0.7).astype(np.float32)
    return X, y, mask


def _port_model(jparams, d_in, d_hid, n_cls, nnz):
    model = GCN(d_in, d_hid, n_cls, nnz, torch.Generator().manual_seed(0))
    gcn_params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                          model)
    return model


@needs_8dev
@pytest.mark.parametrize("x,y,d_in,d_hid,n_cls", [
    (4, 2, 16, 8, 4),     # tests/test_parallel_2d.py
    (2, 2, 8, 8, 3),      # odd classes: W2 and both biases replicated
    (2, 4, 16, 16, 8),
])
def test_2d_step_matches_jax(x, y, d_in, d_hid, n_cls):
    g = _rmat()
    port_mesh, jmesh = _meshes(x, y)
    jmodel = JGCN(d_in=d_in, d_hidden=d_hid, n_classes=n_cls, nnz=g.nnz)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    X, yl, mask = _data(g, d_in, n_cls)

    jplan = j_prepare_ell_sharded(jax_graph(g), jmesh, axis="x")
    jopt = optax.sgd(1e-2)
    jstep = j_make_train_step_2d(jmodel, jplan, jopt, jmesh)
    jp1, _, jloss = jstep(j_shard_params_2d(jparams, jmesh),
                          jopt.init(jparams), jnp.asarray(X),
                          jnp.asarray(yl), jnp.asarray(mask))

    model = _port_model(jparams, d_in, d_hid, n_cls, g.nnz)
    plan = prepare_ell_sharded(g, port_mesh, axis="x")
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    step = make_train_step_2d(model, plan, opt, port_mesh)
    loss = step(torch.from_numpy(X), torch.from_numpy(yl),
                torch.from_numpy(mask))
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp1[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    assert not np.allclose(model.W1.detach().numpy(),
                           np.asarray(jparams["W1"]))

    # the one-device step's loss from the same parameters
    local = _port_model(jparams, d_in, d_hid, n_cls, g.nnz)
    lstep = make_train_step(local, prepare_ell(g, device="cpu"),
                            torch.optim.SGD(local.parameters(), lr=1e-2))
    np.testing.assert_allclose(
        float(lstep(torch.from_numpy(X), torch.from_numpy(yl),
                    torch.from_numpy(mask))), float(loss), rtol=1e-4)


@needs_8dev
@pytest.mark.parametrize("x,y,n_cls", [(4, 2, 4), (2, 2, 3)])
def test_shard_params_2d_matches_jax(x, y, n_cls):
    """Column blocks where the width divides the "y" axis, the whole tensor
    on each "y" device otherwise: the JAX sharding's shard shapes."""
    g = _rmat()
    port_mesh, jmesh = _meshes(x, y)
    jmodel = JGCN(d_in=8, d_hidden=8, n_classes=n_cls, nnz=g.nnz)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jsh = j_shard_params_2d(jparams, jmesh)
    model = _port_model(jparams, 8, 8, n_cls, g.nnz)
    sh = shard_params_2d(model, port_mesh)
    for name, parts in sh.items():
        assert len(parts) == y
        want = jsh[name].sharding.shard_shape(jsh[name].shape)
        assert all(tuple(t.shape) == want for t in parts), name
        split = want != tuple(jparams[name].shape)
        whole = torch.cat(parts, dim=-1) if split else parts[-1]
        np.testing.assert_array_equal(whole.detach().numpy(),
                                      np.asarray(jparams[name]))
    assert tuple(sh["W1"][0].shape) == (8, 8 // y)


def test_column_sharded_matmul_is_the_product():
    port_mesh, _ = _meshes(2, 4)
    mm = column_sharded_matmul(port_mesh)
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.standard_normal((50, 12)).astype(np.float32))
    for c in (8, 6):   # divides the axis of 4, and does not
        W = torch.from_numpy(rng.standard_normal((12, c)).astype(np.float32))
        torch.testing.assert_close(mm(X, W), X @ W, rtol=1e-6, atol=1e-6)


def test_2d_step_on_a_sharded_windowed_plan():
    """The 2-D step also takes the sharded windowed plan (rows over "x"):
    its first loss equals the one-device step's, and the loss falls."""
    g = _community()
    port_mesh, _ = _meshes(2, 2)
    plan = prepare_windowed_sharded(g, port_mesh, axis="x", tm=256, W=128,
                                    min_count=16)
    d_in, d_hid, n_cls = 16, 16, 5
    X, yl, mask = (torch.from_numpy(a) for a in _data(g, d_in, n_cls))
    model = GCN(d_in, d_hid, n_cls, g.nnz, torch.Generator().manual_seed(1))
    local = GCN(d_in, d_hid, n_cls, g.nnz, torch.Generator().manual_seed(1))
    step = make_train_step_2d(model, plan, torch.optim.Adam(
        model.parameters(), lr=1e-2), port_mesh)
    lstep = make_train_step(local, prepare_ell(g, device="cpu"),
                            torch.optim.Adam(local.parameters(), lr=1e-2))
    losses = [float(step(X, yl, mask)) for _ in range(4)]
    np.testing.assert_allclose(losses[0], float(lstep(X, yl, mask)),
                               rtol=1e-4)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
