"""Traffic kind ``train``: full-graph training steps of the
configuration's model (masked cross-entropy, Adam at ``lr``) back to
back, a synchronise only at each end of the window; set-up drives the
same step object through ``first_steps`` steps, which are judged.  The
window counts ``train_steps``.  Parameters: ``lr``, ``first_steps``."""
import math
import time

import numpy as np
import torch

from spmm_bench.reference import common as ref
from spmm_bench.workload import TINY, Workload, generator, sync

FAULTS = ("answer", "half_batch", "stale_state")


def _leaf_gaps(prog, refs) -> list[float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    med = float(np.median(refs))
    return [abs(p - r) / max(r, med, TINY) for p, r in zip(prog, refs)]


class Train(Workload):
    """Set-up builds the training step once (the configuration's model in
    the program, the plan's transposed backward, Adam) and drives it
    through the first steps; that same step object runs in the window.
    Judged against the reference's first steps by three numbers that are
    steady from seed to seed:

    - ``loss1_err``: the first step's loss, relative gap;
    - ``grad_err``: the worst leaf's gap (:func:`_leaf_gaps`) of the norm
      of the first gradient as Adam got it (its first moment after one
      step over 1 - beta1);
    - ``change_med_err``: the median leaf's gap of the norm of the change
      over the first steps (the parameters after them against the
      initial ones).  Leaves whose reference gradient is under a
      thousandth of the median leaf's are left out.

    The later steps' losses and the worst leaf's change are not compared:
    Adam's first update is lr times the sign of each gradient element, so
    an element whose gradient lies within float32's rounding of zero moves
    by 2·lr the other way, and the later steps carry that on (``detail``
    keeps them, with the count of such elements, for ``calibrate.py``)."""

    def __init__(self, cell, seed, plan_options):
        from flex_tpu_torch.models.common import make_step, training_plan
        from flex_tpu_torch.ops.ell_spmm import EllPlan, with_bwd_plan

        super().__init__(cell, seed, plan_options)
        t, md = cell.traffic, cell.cfg["model"]
        m, dev = cell.m, self.dev
        self.X = torch.randn((m, md["d_in"]),
                             generator=generator(dev, seed, 0), device=dev)
        gen = generator(dev, seed, 1)
        self.y = torch.randint(0, md["n_classes"], (m,), generator=gen,
                               device=dev)
        self.mask = torch.zeros(m, device=dev)
        self.mask[torch.randperm(m, generator=gen, device=dev)
                  [:round(md["train_frac"] * m)]] = 1.0
        self.params = self.weights()
        plan = cell.build(**plan_options)
        self.plan = with_bwd_plan(plan, cell.g.n) \
            if isinstance(plan, EllPlan) else training_plan(plan)
        self.model = self.port_model(self.params)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=t["lr"])
        model, loss = self.model, cell.model.loss
        self.step = make_step(
            lambda p, X, y, mask: loss(model, p, X, y, mask), self.plan,
            self.opt)
        beta1 = self.opt.param_groups[0]["betas"][0]
        losses = []
        for i in range(t["first_steps"]):
            losses.append(self.step(self.X, self.y, self.mask))
            if i == 0:  # a leaf Adam holds no state for got no gradient
                first = [self.opt.state[p].get("exp_avg")
                         for p in model.parameters()]
                self.grad_norms = [0.0 if a is None else
                                   float(a.norm() / (1 - beta1))
                                   for a in first]
                self.signs = [None if a is None else torch.sign(a)
                              for a in first]
        sync(dev)
        self.losses = [float(x) for x in losses]
        self.change_norms = [float((p.detach() - w).norm())
                             for p, w in zip(model.parameters(),
                                             self.params)]
        self.detail = {}

    def window(self, seconds, spans):
        step, X, y, mask = self.step, self.X, self.y, self.mask
        i = 0
        sync(self.dev)
        t0 = time.perf_counter()
        with spans.span("window"):
            end = t0 + seconds
            while True:
                step(X, y, mask)
                i += 1
                if time.perf_counter() >= end:
                    break
            sync(self.dev)
        return {"count": i, "counts": "train_steps",
                "window_s": time.perf_counter() - t0}

    def release(self):
        del self.step, self.opt, self.model, self.plan

    def _reference(self, A, mode):
        t = self.cell.traffic
        losses, grads, theta = ref.train(
            A, self.cell.model_ref.forward, self.X, self.y, self.mask,
            self.params, t["lr"], t["first_steps"], mode)
        change = [float((p.double() - w.double()).norm())
                  for p, w in zip(theta, self.params)]
        return losses, grads, change

    def judge(self, A):
        r_loss, r_grads, r_change = self._reference(A, "f64")
        r_grad = [float(g.norm()) for g in r_grads]
        med = float(np.median(r_grad))
        moved = [i for i, g in enumerate(r_grad) if g >= 1e-3 * med]
        loss_gaps = [abs(p - r) / max(abs(r), TINY)
                     for p, r in zip(self.losses, r_loss)]
        change_gaps = _leaf_gaps([self.change_norms[i] for i in moved],
                                 [r_change[i] for i in moved])
        out = {"loss1_err": loss_gaps[0],
               "grad_err": max(_leaf_gaps(self.grad_norms, r_grad)),
               "change_med_err": float(np.median(change_gaps))}
        out = {k: (v if math.isfinite(v) else math.inf)
               for k, v in out.items()}
        self.detail = {"loss_gaps": loss_gaps, "change_gaps": change_gaps}
        if self.signs[0] is not None:
            self.detail["sign_flips"] = [
                int((s != torch.sign(g.to(s.dtype))).sum())
                for s, g in zip(self.signs, r_grads)]
        return out, list(out.items())

    def control(self, A):
        self.losses, grads, self.change_norms = self._reference(A, "tf32")
        self.grad_norms = [float(g.norm()) for g in grads]
        self.signs = [torch.sign(g) for g in grads]


WORKLOAD = Train
