"""Device information: the banner the command line prints first, and the
card's published peak rates.

Counterpart of ``flex_tpu.utils.device_info``, from ``torch.cuda``: each
card's name, SM count, memory in use and total
(``torch.cuda.mem_get_info``) and, where ``nvidia-smi`` answers, its power
limit.  :data:`PEAKS` is the one table of published peaks that the bench
harness and ``chip_smoke.py`` read for their bounds.
"""
from __future__ import annotations

import platform
import subprocess

import torch

# Published dense peaks (NVIDIA data sheets): FP32 outside the tensor
# cores, and device-memory rate, at each part's full power limit (700 W
# for the SXM5 part).  Keyed by a substring of the card name; the first
# key that the name contains wins.  The port's runs so far used an
# "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi name, power limit).
PEAKS = {
    "H100 PCIe": {"fp32": 51e12, "bytes": 2.0e12},
    "H100 NVL": {"fp32": 60e12, "bytes": 3.9e12},
    "H100": {"fp32": 67e12, "bytes": 3.35e12},  # SXM5 80GB HBM3
}


def peaks_for(name: str) -> dict:
    """The published peaks of the card named ``name``; raises for a card
    the table does not know."""
    for key, p in PEAKS.items():
        if key in name:
            return p
    raise RuntimeError(f"no published peak rates for card {name!r}")


def smi_query(index: int = 0) -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    for card ``index``, or None where nvidia-smi does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def device_info(device=None) -> list[dict]:
    """One dict per device the entry points would run on: every CUDA card
    (``device`` None or CUDA), or the host (``device="cpu"``).  A card's
    dict holds its name, SM count, memory in use and total and, where
    nvidia-smi answers, its name and power limit as nvidia-smi gives them."""
    from flex_tpu_torch.sparse.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return [{"id": 0, "platform": dev.type,
                 "kind": platform.processor() or platform.machine()}]
    out = []
    ids = [dev.index] if dev.index is not None else range(
        torch.cuda.device_count())
    for i in ids:
        props = torch.cuda.get_device_properties(i)
        free, total = torch.cuda.mem_get_info(i)
        out.append({
            "id": i, "platform": "cuda", "kind": props.name,
            "sm_count": props.multi_processor_count,
            "bytes_in_use": total - free, "bytes_limit": total,
            "smi": smi_query(i),
        })
    return out


def device_banner(device=None) -> str:
    """One line per device for the command line."""
    lines = []
    for r in device_info(device):
        extra = ""
        if "bytes_limit" in r:
            extra = (f" {r['sm_count']} SMs, memory "
                     f"{r['bytes_in_use'] / 2**30:.2f}"
                     f"/{r['bytes_limit'] / 2**30:.1f} GiB")
        if r.get("smi"):
            extra += f" (nvidia-smi: {r['smi']})"
        lines.append(f"  device {r['id']}: {r['platform']}/{r['kind']}{extra}")
    return "\n".join(lines)
