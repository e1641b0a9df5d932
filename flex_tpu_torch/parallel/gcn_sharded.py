"""2-D sharded GCN training: rows over one mesh axis, features over the
other.

Counterpart of ``flex_tpu.parallel.gcn_sharded``, on one mesh of torch
devices held by one process (:mod:`.mesh`):

- axis "x": the adjacency's row shards (a sharded plan built over "x",
  :func:`.spmm_sharded.prepare_ell_sharded`); C comes out row by row.
- axis "y": the GCN weights column-sharded where their width divides the
  axis (biases and other widths replicated): the dense product X·W runs
  one column block on each device along "y" (those of the mesh's first
  row), and the blocks are concatenated.  The JAX package leaves that
  placement to GSPMD through sharding constraints.

The parameters stay one tensor each on the model's device, so the
optimizer updates them as it would on one device; their blocks are
copies that autograd differentiates through.
"""
from __future__ import annotations

from typing import Callable

import torch

from flex_tpu_torch.parallel.mesh import Mesh


def _axis_devices(mesh: Mesh, axis: str) -> list:
    """The mesh's devices along ``axis`` at index 0 of every other axis."""
    ax = mesh.axis_names.index(axis)
    idx = [0] * mesh.devices.ndim
    out = []
    for i in range(mesh.devices.shape[ax]):
        idx[ax] = i
        out.append(mesh.devices[tuple(idx)])
    return out


def _column_sharded(name: str, p: torch.Tensor, y: int) -> bool:
    return name.startswith("W") and p.shape[-1] % y == 0


def shard_params_2d(params, mesh: Mesh, model_axis: str = "y") -> dict:
    """name -> one tensor per device along ``model_axis``: the weight
    matrices' column blocks where the width divides the axis, else (biases,
    odd widths such as pubmed's 3 classes) the whole tensor on each.
    ``params`` is a dict of tensors or a module."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    devs = _axis_devices(mesh, model_axis)
    out = {}
    for name, p in params.items():
        parts = (torch.tensor_split(p, len(devs), dim=-1)
                 if _column_sharded(name, p, len(devs))
                 else (p,) * len(devs))
        out[name] = tuple(t.to(d) for t, d in zip(parts, devs))
    return out


def column_sharded_matmul(mesh: Mesh, model_axis: str = "y") -> Callable:
    """``matmul(X, W)``: when W's width divides the axis, block j of W's
    columns times X on the axis's device j, the blocks concatenated on X's
    device; otherwise one product on X's device."""
    devs = _axis_devices(mesh, model_axis)

    def matmul(X, W):
        if W.shape[-1] % len(devs):
            return torch.matmul(X, W)
        return torch.cat([
            torch.matmul(X.to(d), Wj.to(d)).to(X.device)
            for Wj, d in zip(torch.tensor_split(W, len(devs), dim=-1),
                             devs)], dim=-1)

    return matmul


def make_train_step_2d(model, plan, optimizer, mesh: Mesh,
                       model_axis: str = "y") -> Callable:
    """Like :func:`.models.gcn.make_train_step` (the same loss, through
    :func:`.models.common.make_step`), with the dense products run
    column-sharded over ``model_axis`` while the SpMM runs row-sharded in
    the plan.  Returns ``step(X, y, mask) -> loss``."""
    from flex_tpu_torch.models import common

    matmul = column_sharded_matmul(mesh, model_axis)

    def loss_fn(plan_, X, y, mask):
        return common.masked_xent(model(plan_, X, matmul=matmul), y, mask)

    return common.make_step(loss_fn, common.training_plan(plan), optimizer)
