"""A mesh of torch devices, held by one process.

Counterpart of ``flex_tpu.parallel.mesh``.  The JAX package is
single-controller: one process holds a ``jax.sharding.Mesh`` and
``shard_map`` places each shard on its device.  The port keeps that
design: one process holds a :class:`Mesh` of ``torch.device`` entries, a
sharded plan keeps each shard's tensors on its own device, and its
collectives are explicit copies between devices (``Tensor.to``,
``torch.cat``).  CUDA launches are asynchronous, so shards on distinct
cards overlap.  Several entries may name one device: on a machine with
one card every shard of a 4-way mesh lies on ``cuda:0`` (NCCL would not
take two ranks on one card, which is why this is not
``torch.distributed``).
"""
from __future__ import annotations

import numpy as np
import torch

from flex_tpu_torch.sparse.device import resolve_device


class Mesh:
    """An ndarray of ``torch.device`` (``devices``) with one name per
    axis; ``shape`` maps each axis name to its size, as a JAX mesh's
    does."""

    def __init__(self, devices, axis_names):
        devs = np.empty(np.shape(devices), dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            devs[idx] = torch.device(d)
        axis_names = ((axis_names,) if isinstance(axis_names, str)
                      else tuple(axis_names))
        if devs.ndim != len(axis_names) or not devs.size:
            raise ValueError(f"{devs.ndim}-D devices of size {devs.size} "
                             f"for axes {axis_names}")
        self.devices = devs
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.ravel()]})")


def make_mesh(n_devices: int | None = None, axis: str = "x",
              device=None) -> Mesh:
    """A 1-D mesh over ``axis``.  CUDA by default: every visible card, or
    ``n_devices`` entries that take the cards in turn (cuda:0, cuda:1, ...,
    cuda:0, ...), so a machine with fewer cards than shards still runs
    them all, several on one card.  ``device`` names another device
    (``"cpu"``, or one card): the mesh then holds ``n_devices`` entries of
    it (1 by default)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        pool = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        pool = [dev]
    n = len(pool) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs a device, got n_devices={n}")
    devs = np.empty(n, dtype=object)
    for i in range(n):
        devs[i] = pool[i % len(pool)]
    return Mesh(devs, (axis,))
