"""Roofline plot from a bench CSV, against a card's published roofs.

Counterpart of the repository's ``plot/roofline.py``:

    python -m flex_tpu_torch.bench.roofline bench.csv [out.png] [--card=H100]

Reads the rows that :func:`.harness.write_csv` writes and plots each
row's effective GFLOP/s (2·nnz·k / tElap) against its arithmetic
intensity under the ideal byte model (A's 8 bytes a nonzero once, B read
once and C written once: 8·m·k bytes), under the roofs of the card named
by ``--card`` (a key of :data:`..utils.device_info.PEAKS`): its memory
rate and its FP32 rate outside the tensor cores.  Rows with an error or
no rate are skipped.  Exit status 2 on a missing CSV argument or an
unknown card.
"""
from __future__ import annotations

import csv
import sys


def main(argv=None) -> int:
    from flex_tpu_torch.utils.device_info import PEAKS

    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    card = "H100"
    for a in argv:
        if a.startswith("--card="):
            card = a.split("=", 1)[1]
    if not args:
        print(__doc__)
        return 2
    if card not in PEAKS:
        print(f"unknown card {card!r}; choose from {sorted(PEAKS)}")
        return 2
    csv_path = args[0]
    out = args[1] if len(args) > 1 else "roofline.png"

    # matplotlib only here: the plot is made where matplotlib is installed
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    roofs = PEAKS[card]
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    ai = np.logspace(-2, 3, 200)
    plt.figure(figsize=(7, 5))
    plt.loglog(ai, np.minimum(ai * roofs["bytes"], roofs["fp32"]) / 1e9,
               label=f"{card} roof (memory {roofs['bytes'] / 1e9:.0f} GB/s, "
                     f"FP32 {roofs['fp32'] / 1e12:.0f} TF/s)")
    for r in rows:
        # error rows carry no rate, or gflops "0.0": a truthy string
        gf = float(r.get("gflops") or 0)
        if gf <= 0:
            continue
        nnz, k, m = int(r["nnz"]), int(r["k"]), int(r["m"])
        x = 2 * nnz * k / (nnz * 8 + m * k * 8)
        plt.scatter([x], [gf],
                    label=f"{r['graph']}/{r['order']}/{r['method']}")
    plt.xlabel("arithmetic intensity (FLOP/byte, ideal-traffic model)")
    plt.ylabel("effective GFLOP/s (2·nnz·k/t)")
    plt.legend(fontsize=7)
    plt.grid(True, which="both", alpha=0.3)
    plt.tight_layout()
    plt.savefig(out, dpi=120)
    plt.close()
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
