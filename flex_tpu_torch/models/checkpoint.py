"""Checkpoint and resume for model training.

Counterpart of ``flex_tpu.models.checkpoint``, with ``torch.save`` of the
state dicts in place of orbax.  A checkpoint holds the model's and the
optimizer's state and the step count; resuming from it gives the same
next step, bit for bit, as the run that was not interrupted.
"""
from __future__ import annotations

import os
import tempfile

import torch


def save_checkpoint(path: str, model: torch.nn.Module, optimizer=None,
                    step: int = 0) -> None:
    """Write ``model``'s (and ``optimizer``'s) state and ``step`` to the
    file ``path``: first to a temporary file beside it, then renamed, so a
    reader never sees a partial checkpoint."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {"model": model.state_dict(),
             "optimizer": optimizer.state_dict() if optimizer is not None
             else None,
             "step": int(step)}
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    os.close(fd)
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore_checkpoint(path: str, model: torch.nn.Module,
                       optimizer=None) -> int:
    """Load a checkpoint written by :func:`save_checkpoint` into ``model``
    (and ``optimizer``), whose tensors stay on their own devices, and
    return its step.  ``weights_only`` loading: the file holds tensors and
    plain containers only."""
    params = list(model.parameters())
    where = params[0].device if params else torch.device("cpu")
    state = torch.load(os.path.abspath(path), map_location=where,
                       weights_only=True)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        if state["optimizer"] is None:
            raise ValueError(f"{path} holds no optimizer state")
        optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])
