"""Traffic kind ``stream``: SpMM calls back to back at width ``k`` on B
operands cycled from a pool of ``pool`` seed-made matrices, one
synchronise at each end of the window; ``sample`` answers are judged
(``spmm_err``).  The window counts ``spmm_calls``.  Parameters: ``k``,
``pool``, ``sample``."""
import time

import torch

from spmm_bench.workload import SpmmJudged, generator, sync

FAULTS = ("answer", "half_rows")


class Stream(SpmmJudged):
    def __init__(self, cell, seed, plan_options):
        super().__init__(cell, seed, plan_options)
        t = cell.traffic
        self.B = torch.randn((t["pool"], cell.g.n, t["k"]),
                             generator=generator(self.dev, seed, 0),
                             device=self.dev)
        self.plan = cell.build(**plan_options)
        for _ in range(2):  # the first pass builds the kernels
            sync(self.dev)
            t0 = time.perf_counter()
            for j in range(t["pool"]):
                C = self.plan(self.B[j])
            sync(self.dev)
        self.per_op_s = (time.perf_counter() - t0) / t["pool"]
        self.like = C

    def window(self, seconds, spans):
        self._choose_kept(self.per_op_s, seconds, self.like)
        P, plan, B, keep = len(self.B), self.plan, self.B, self.keep_at
        i = 0
        sync(self.dev)
        t0 = time.perf_counter()
        with spans.span("window"):
            end = t0 + seconds
            while True:
                C = plan(B[i % P])
                if i in keep:
                    self._keep(i % P, C)
                i += 1
                if time.perf_counter() >= end:
                    break
            sync(self.dev)
        t1 = time.perf_counter()
        self._keep((i - 1) % P, C)
        return {"count": i, "counts": "spmm_calls", "window_s": t1 - t0}

    def release(self):
        del self.plan, self.like


WORKLOAD = Stream
