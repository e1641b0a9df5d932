"""Faults planted in the program underneath a run, for the checks that
the comparison catches them (``tests/test_spmm_bench_faults.py``) and for
the readings of a training cell's numbers under them (``calibrate.py``).
Each traffic kind names those a run of it can have (``FAULTS`` in
``kinds/<kind>.py``).  Never used by ``run.py``.  Each is a context
manager that patches the port while it is open:

- ``answer``: one output row of every ELL plan call is garbage (×1000 +
  1), where the answer is produced.
- ``half_rows``: the second half of every ELL plan call's output rows is
  left out (zeros).
- ``half_batch``: the loss leaves out the second half of the nodes and
  takes the mean over the rest.
- ``stale_state``: Adam's step returns with the parameters and its state
  unchanged.
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("answer", "half_rows", "half_batch", "stale_state")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _ell_output(alter):
    from flex_tpu_torch.ops import ell_spmm

    orig = ell_spmm._ell_raw_call

    def call(plan, B, into):
        out = orig(plan, B, into)
        alter(out)
        return out

    return _patched(ell_spmm, "_ell_raw_call", call)


def plant(name: str):
    """The context manager that plants fault ``name``."""
    if name == "answer":
        def garbage(out):
            out[out.shape[0] // 3].mul_(1e3).add_(1.0)
        return _ell_output(garbage)
    if name == "half_rows":
        def drop(out):
            out[(out.shape[0] + 1) // 2:].zero_()
        return _ell_output(drop)
    if name == "half_batch":
        from flex_tpu_torch.models import common

        orig = common.masked_xent

        def half(logits, y, mask):
            kept = mask.clone()
            kept[(len(kept) + 1) // 2:] = 0
            return orig(logits, y, kept)

        return _patched(common, "masked_xent", half)
    if name == "stale_state":
        return _patched(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    raise ValueError(f"unknown fault {name!r}; have {FAULTS}")
