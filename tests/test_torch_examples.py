"""The port's training examples (``flex_tpu_torch/examples/``) for two
steps each at a small size on the CPU: a finite loss that falls; the
windowed GCN's initial loss against the JAX ``gcn_loss`` on the same graph,
features, labels and initial parameters (rtol 1e-4); the Pubmed GCN's
checkpoint; and the scripts' command lines."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flex_tpu.models import GCN as JGCN
from flex_tpu.models import gcn_loss as j_gcn_loss
from flex_tpu.ops.window_spmm import prepare_windowed as j_prepare_windowed

from flex_tpu_torch.examples import labels, parse
from flex_tpu_torch.examples import train_gat_pubmed, train_gcn_pubmed
from flex_tpu_torch.examples import train_gcn_windowed
from flex_tpu_torch.io import community_graph, make_features, rmat_graph
from flex_tpu_torch.io import save_csv
from flex_tpu_torch.models import GCN
from flex_tpu_torch.reorder import reorder
from test_torch_ell import jax_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, NNZ = 2000, 200_000


def _falls(r, steps=2):
    losses = [r["loss0"]] + r["losses"]
    assert len(r["losses"]) == steps
    assert np.isfinite(losses).all()
    assert r["losses"][0] == pytest.approx(r["loss0"], rel=1e-6)
    assert r["losses"][-1] < r["loss0"]
    assert r["ms_per_step"] > 0


def test_train_gcn_windowed_first_loss_matches_jax():
    r = train_gcn_windowed.main(2, m=M, nnz=NNZ, device="cpu")
    _falls(r)
    g = reorder(community_graph(M, NNZ, n_comm=8, seed=0), "rbdeg",
                check=False)
    port = GCN(64, 64, 8, nnz=g.nnz,
               generator=torch.Generator().manual_seed(0))
    params = {k: jnp.asarray(v.detach().numpy())
              for k, v in port.named_parameters()}
    y, mask = labels(g.m, 8, 0.3, "cpu")
    jplan = j_prepare_windowed(jax_graph(g), tm=256, W=128, min_count=64)
    ref = j_gcn_loss(JGCN(d_in=64, d_hidden=64, n_classes=8, nnz=g.nnz),
                     params, jplan, jnp.asarray(make_features(g, 64)),
                     jnp.asarray(y.numpy().astype(np.int32)),
                     jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(r["loss0"], float(ref), rtol=1e-4)


@pytest.fixture(scope="module")
def small_csv(tmp_path_factory):
    """A small graph as a CSV named after Pubmed (its 3 classes)."""
    path = str(tmp_path_factory.mktemp("graph") / "pubmed.csv")
    save_csv(rmat_graph(2000, 16_000, seed=4), path)
    return path


def test_train_gcn_pubmed_trains_and_resumes(small_csv, monkeypatch):
    from flex_tpu_torch.models import checkpoint

    saved = []
    save = checkpoint.save_checkpoint

    def spy(path, *args, **kw):
        save(path, *args, **kw)
        saved.append(torch.load(path, weights_only=True))

    monkeypatch.setattr(checkpoint, "save_checkpoint", spy)
    _falls(train_gcn_pubmed.main(2, csv=small_csv, device="cpu"))
    (state,) = saved
    assert state["step"] == 2 and state["optimizer"] is not None
    assert tuple(state["model"]["W2"].shape) == (64, 3)


def test_train_gat_pubmed_trains(small_csv):
    _falls(train_gat_pubmed.main(2, csv=small_csv, device="cpu"))


def test_labels_follow_the_jax_examples():
    rng = np.random.default_rng(0)
    y_ref = rng.integers(0, 5, 300).astype(np.int32)
    mask_ref = (rng.random(300) < 0.3).astype(np.float32)
    y, mask = labels(300, 5, 0.3, "cpu")
    assert np.array_equal(y.numpy(), y_ref)
    assert np.array_equal(mask.numpy(), mask_ref)


def test_parse_takes_positionals_and_a_device():
    assert parse(["3", "g.csv", "--device=cpu"], ("steps", "graph.csv")) \
        == (["3", "g.csv"], "cpu")
    assert parse([], ("steps",)) == ([], None)
    for bad in (["1", "2"], ["--cpu"]):
        with pytest.raises(SystemExit):
            parse(bad, ("steps",))


def test_examples_run_as_modules(small_csv):
    p = subprocess.run(
        [sys.executable, "-m", "flex_tpu_torch.examples.train_gcn_pubmed",
         "2", small_csv, "--device=cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "checkpoint round-trip: step=2, parameters equal" in p.stdout
    assert "(improved)" in p.stdout
