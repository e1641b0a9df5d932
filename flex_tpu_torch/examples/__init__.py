"""Training examples on the port, counterparts of the repository's
``examples/`` scripts; each runs as ``python -m
flex_tpu_torch.examples.<name>`` (on the card unless ``--device=cpu``)
and has ``main(steps, ..., device=None)``, which returns the initial loss,
the loss of every step and the median milliseconds per step."""
from __future__ import annotations

import time

import torch


def train(step, args, steps: int, device: torch.device, every: int):
    """Run ``step(*args)`` ``steps`` times, printing the loss every
    ``every`` steps and at the last.  Returns (the losses, the median
    milliseconds per step).  Each step ends by reading its loss, which
    waits for the device, so a step's time is the host clock from call to
    loss."""
    losses, times = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        t = time.perf_counter()
        losses.append(float(step(*args)))
        times.append((time.perf_counter() - t) * 1e3)
        if (i + 1) % every == 0 or i == steps - 1:
            print(f"step {i + 1:4d}  loss {losses[-1]:.4f}  "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    ms = float(sorted(times)[len(times) // 2]) if times else float("nan")
    return losses, ms


def summary(loss0: float, losses: list, ms: float) -> dict:
    """Print the JAX examples' closing line and return the result dict."""
    last = losses[-1] if losses else loss0
    print(f"loss {loss0:.4f} -> {last:.4f} "
          f"({'improved' if last < loss0 else 'NO IMPROVEMENT'}); "
          f"{ms:.2f} ms/step (median)", flush=True)
    return {"loss0": loss0, "losses": losses, "ms_per_step": ms}


def labels(m: int, n_classes: int, labelled: float, device):
    """Seeded labels (``default_rng(0)``) and a mask that labels about
    ``labelled`` of the nodes, as the JAX examples draw them."""
    import numpy as np

    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.integers(0, n_classes, m)).to(device)
    mask = torch.from_numpy(
        (rng.random(m) < labelled).astype(np.float32)).to(device)
    return y, mask


def parse(argv, names: tuple) -> tuple[list, str | None]:
    """Positional arguments (as many as ``names``) and ``--device=``."""
    device = None
    pos = []
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--") or len(pos) == len(names):
            raise SystemExit(f"usage: [{'] ['.join(names)}] [--device=cpu]")
        else:
            pos.append(a)
    return pos, device
