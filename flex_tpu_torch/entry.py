"""Entry points: the flagship model's forward, and a sharded dry run.

Counterpart of the repository's ``__graft_entry__.py``:

- :func:`entry` returns ``(fn, args)``: ``fn(model, plan, X)`` is the
  forward of a 2-layer GCN (64 → 32 → the graph's classes) on the ELL plan
  of a Pubmed-sized graph.
- :func:`dryrun_multichip` runs the sharded paths once on an n-device
  mesh: a GCN training step (rows over "x", and the weights' columns over
  "y" when n is even and at least 4), the sharded windowed plan's forward
  and gradient, the gathered B layout and the budgeted selection.

The JAX package reads Pubmed from a path outside the repository and
re-executes itself to get n virtual devices.  Here the default graph is an
R-MAT graph of Pubmed's published node and edge count (a caller may pass
the real one), and the mesh is the single-controller
:func:`..parallel.make_mesh`, which needs no subprocess.  Both run on the
card unless the caller names another device.
"""
from __future__ import annotations

import numpy as np
import torch

# Pubmed's published size: nodes and edges
PUBMED_NODES, PUBMED_EDGES = 19_717, 88_648


def pubmed_sized_graph():
    """An R-MAT graph of Pubmed's node and edge count, seed 0, named
    ``pubmed`` so that its ``label_width`` is Pubmed's 3 classes."""
    from flex_tpu_torch.io import rmat_graph

    return rmat_graph(PUBMED_NODES, PUBMED_EDGES, seed=0, name="pubmed")


def entry(g=None, device=None):
    """``(fn, (model, plan, X))``: ``fn(model, plan, X)`` is the forward of
    ``GCN(d_in=64, d_hidden=32, n_classes=g.label_width)`` (weights from
    seed 0) on ``prepare_ell(g)``, X = ``make_features(g, 64)``.  ``g``
    defaults to :func:`pubmed_sized_graph`."""
    from flex_tpu_torch.io import make_features
    from flex_tpu_torch.models import GCN
    from flex_tpu_torch.ops.ell_spmm import prepare_ell
    from flex_tpu_torch.sparse.device import resolve_device

    dev = resolve_device(device)
    g = pubmed_sized_graph() if g is None else g
    plan = prepare_ell(g, device=dev)
    model = GCN(d_in=64, d_hidden=32, n_classes=g.label_width, nnz=g.nnz,
                generator=torch.Generator().manual_seed(0)).to(dev)
    X = torch.from_numpy(make_features(g, 64)).to(dev)

    def fn(model, plan, X):
        return model(plan, X)

    return fn, (model, plan, X)


def dryrun_graph(n_devices: int):
    """The dry run's training graph: R-MAT, 64 rows a device, 8 nonzeros a
    row, seed 0."""
    from flex_tpu_torch.io import rmat_graph

    return rmat_graph(64 * n_devices, 64 * n_devices * 8, seed=0,
                      name="dryrun")


def dryrun_multichip(n_devices: int, device=None) -> float:
    """The sharded paths on a mesh of ``n_devices`` entries of ``device``'s
    kind (:func:`..parallel.make_mesh`; on one card every entry is that
    card), each output checked finite.  Returns the training step's loss.

    - A GCN(16 → 16 → 4) step with Adam(1e-2) on :func:`dryrun_graph`: on a
      2-D ("x", "y") mesh through ``make_train_step_2d`` when n is even and
      at least 4, else on rows only through ``make_train_step``; initial
      weights from seed 0, labels from ``default_rng(0)``, every node
      labelled.
    - The sharded windowed plan (tm = W = 128, min_count 4) on an rbdeg
      community graph: its forward, and the gradient of
      ``(plan(X @ Wt) ** 2).sum()`` in Wt (finite and not all zero).
    - The sharded ELL plan with B gathered from its row shards.
    - The budgeted selection: min_count 1 under a per-shard budget of four
      128 × 128 windows."""
    from flex_tpu_torch.io import community_graph, make_features
    from flex_tpu_torch.models import GCN, make_train_step
    from flex_tpu_torch.parallel import (
        Mesh, make_mesh, make_train_step_2d, prepare_ell_sharded,
        prepare_windowed_sharded,
    )
    from flex_tpu_torch.reorder import reorder

    def finite(t, what):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"dryrun: {what} is not finite")

    devs = make_mesh(n_devices, device=device).devices
    home = devs[0]
    g = dryrun_graph(n_devices)
    two_d = n_devices >= 4 and n_devices % 2 == 0
    mesh = (Mesh(devs.reshape(n_devices // 2, 2), ("x", "y")) if two_d
            else Mesh(devs, ("x",)))
    plan = prepare_ell_sharded(g, mesh, axis="x")
    model = GCN(16, 16, 4, nnz=g.nnz,
                generator=torch.Generator().manual_seed(0)).to(home)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = (make_train_step_2d(model, plan, opt, mesh) if two_d
            else make_train_step(model, plan, opt))
    rng = np.random.default_rng(0)
    X = torch.from_numpy(make_features(g, 16)).to(home)
    y = torch.from_numpy(rng.integers(0, 4, g.m)).to(home)
    mask = torch.ones(g.m, device=home)
    loss = float(step(X, y, mask))
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun: loss {loss}")

    # the row-sharded windowed hybrid on a community graph
    gw = reorder(community_graph(128 * n_devices, 128 * n_devices * 24,
                                 n_comm=max(n_devices // 2, 2), seed=1),
                 "rbdeg", check=False)
    wmesh = Mesh(devs, ("w",))
    wplan = prepare_windowed_sharded(gw, wmesh, axis="w", tm=128, W=128,
                                     min_count=4)
    Xw = torch.from_numpy(make_features(gw, 16)).to(home)
    finite(wplan(Xw), "the sharded windowed forward")

    # B gathered from its row shards
    gplan = prepare_ell_sharded(g, Mesh(devs, ("x",)), axis="x",
                                b_layout="gathered")
    finite(gplan(X), "the gathered-B sharded ELL forward")

    # the windowed plan's gradient
    Wt = torch.eye(16, device=home, requires_grad=True)
    (wplan(Xw @ Wt) ** 2).sum().backward()
    finite(Wt.grad, "the sharded windowed gradient")
    if not float(Wt.grad.abs().sum()) > 0.0:
        raise AssertionError("dryrun: the sharded windowed gradient is zero")

    # budgeted selection: about four windows fit each shard
    wplan_b = prepare_windowed_sharded(
        gw, wmesh, axis="w", tm=128, W=128, min_count=1,
        max_dense_bytes=128 * 128 * 4 * 4)
    if not wplan_b.stats["min_count_eff"] >= 1:
        raise AssertionError(f"dryrun: min_count_eff "
                             f"{wplan_b.stats['min_count_eff']}")
    finite(wplan_b(Xw), "the budgeted sharded windowed forward")
    return loss
