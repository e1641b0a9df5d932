"""Runtime configuration shared by the command line, the bench harness
and the autotuner.

Copy of ``flex_tpu.config.FlexConfig`` with the same fields, flags and
``prep_kwargs``, plus ``device``: where the run goes (``"cuda"`` unless
``--device=cpu`` is asked for).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FlexConfig:
    # kernel strategy: "ell" | "panel" | "xla" | "auto" | "sweep" | ...
    method: str = "auto"
    # vertex ordering: "ovo" | "deg" | "rcm" | "dfs" | "gorder" | "rabbit"
    order: str = "deg"
    k: int = 128

    # ell params; None = ops.ell_spmm.DEFAULT_WIDTHS
    widths: tuple[int, ...] | None = None
    b_dtype: str = "float32"          # "bfloat16": bf16 gathers of B

    # panel params
    tm: int = 128
    hub_threshold: int = 512
    hub_width: int = 2048

    # windowed params (J = per-panel window cap)
    W: int = 128
    J: int = 1024
    min_count: int = 128
    # the narrow-k transposed kernel (Aᵀ step layout, Cᵀ = Bᵀ·Aᵀ)
    transposed: bool = False

    # bench params
    iters: int = 10
    check: bool = True
    csv: str | None = None
    # profiler trace directory (--trace=DIR traces one call of the run)
    trace: str | None = None
    # persist/reuse the computed ordering: --order-file=path.npy loads it
    # if present, else computes and saves it
    order_file: str | None = None
    # the torch device of the run
    device: str = "cuda"

    # flag names the user set on the command line (from_args fills it);
    # --method=auto honours them over the autotuner's choices
    explicit: frozenset = frozenset()

    def prep_kwargs(self, method: str) -> dict:
        if method == "ell":
            kw = {"b_dtype": self.b_dtype}
            if self.widths is not None:
                kw["widths"] = self.widths
            return kw
        if method == "panel":
            return {
                "tm": self.tm,
                "hub_threshold": self.hub_threshold,
                "hub_width": self.hub_width,
            }
        if method == "windowed":
            return {
                "tm": max(self.tm, 256), "W": self.W, "J": self.J,
                "min_count": self.min_count, "b_dtype": self.b_dtype,
                "transposed": self.transposed,
            }
        if method == "band":
            return {"tm": max(self.tm, 256)}
        return {}

    @staticmethod
    def from_args(argv) -> tuple["FlexConfig", list[str]]:
        """Parse --key=value overrides; returns (config, positional args)."""
        cfg = FlexConfig()
        pos = []
        explicit = set()
        for a in argv:
            if a.startswith("--"):
                key, eq, val = a[2:].partition("=")
                key = key.replace("-", "_")
                if not hasattr(cfg, key) or key == "explicit":
                    raise SystemExit(f"unknown flag --{key}")
                cur = getattr(cfg, key)
                if isinstance(cur, bool):
                    val = val.lower() not in ("0", "false", "no") if val else True
                else:
                    if not val:
                        # a bare non-bool flag would become None and fail
                        # far from here
                        raise SystemExit(f"--{key} needs a value (--{key}=...)")
                    if isinstance(cur, int):
                        val = int(val)
                    elif isinstance(cur, tuple) or key == "widths":
                        val = tuple(int(x) for x in val.split(","))
                setattr(cfg, key, val)
                explicit.add(key)
            else:
                pos.append(a)
        cfg.explicit = frozenset(explicit)
        return cfg, pos
