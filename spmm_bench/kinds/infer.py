"""Traffic kind ``infer``: one client in a closed loop.  A request is a
full-graph forward of the configuration's model on a feature matrix
cycled from a pool of ``pool`` seed-made ones, then a synchronise, timed
on the host clock from issue to the synchronise's return.  ``warmup``
forwards come before the window; ``sample`` answers are judged: the
largest logit gap over the largest reference logit, ``logit_err``.  The
window counts ``requests`` and keeps their ``latencies``."""
import math
import time

import torch

from spmm_bench.workload import TINY, Workload, generator, sync

FAULTS = ("answer", "half_rows")


class Infer(Workload):
    def __init__(self, cell, seed, plan_options):
        super().__init__(cell, seed, plan_options)
        t, md = cell.traffic, cell.cfg["model"]
        self.X = torch.randn((t["pool"], cell.m, md["d_in"]),
                             generator=generator(self.dev, seed, 0),
                             device=self.dev)
        self.params = self.weights()
        self.plan = cell.build(**plan_options)
        self.model = self.port_model(self.params)
        with torch.no_grad():
            for i in range(t["warmup"]):
                t0 = time.perf_counter()
                self.like = self.model(self.plan, self.X[i % t["pool"]])
                sync(self.dev)
                self.per_op_s = time.perf_counter() - t0

    def window(self, seconds, spans):
        self._choose_kept(self.per_op_s, seconds, self.like)
        P, model, plan, X = len(self.X), self.model, self.plan, self.X
        lat = []
        i = 0
        sync(self.dev)
        t0 = time.perf_counter()
        with spans.span("window"), torch.no_grad():
            end = t0 + seconds
            while True:
                ta = time.perf_counter()
                with spans.span("enqueue"):
                    Z = model(plan, X[i % P])
                sync(self.dev)
                lat.append(time.perf_counter() - ta)
                if i in self.keep_at:
                    self._keep(i % P, Z)
                i += 1
                if time.perf_counter() >= end:
                    break
        t1 = time.perf_counter()
        self._keep((i - 1) % P, Z)
        return {"count": i, "counts": "requests", "window_s": t1 - t0,
                "latencies": lat}

    def release(self):
        del self.plan, self.model, self.like

    def judge(self, A):
        forward = self.cell.model_ref.forward
        params = [p.to(torch.float64) for p in self.params]
        worst, answers = 0.0, []
        for j, Z in self.kept:
            R = forward(A, self.X[j], params)
            err = (Z.to(torch.float64) - R).abs().max() / \
                (R.abs().max() + TINY)
            e = float(err) if torch.isfinite(err) else math.inf
            answers.append(("logit_err", e))
            worst = max(worst, e)
        return {"logit_err": worst}, answers

    def control(self, A):
        forward = self.cell.model_ref.forward
        self.kept = [(j, forward(A, self.X[j], self.params, "tf32"))
                     for j, _ in self.kept]


WORKLOAD = Infer
