"""``model.kind: "gat3"``: the three-layer GAT of Veličković et al.'s
inductive model (heads concatenated after an ELU, concatenated with the
identity skip across the layer, averaged), the program's
``models.gat.GAT`` with per-layer heads and widths from the
configuration (``heads``, ``widths``, ``combine``, ``skip``,
``negative_slope``) and the benchmark's seed-made weights copied in; its
loss is the program's ``gat_loss`` on the attention graph that
:func:`build` prepares.  The plain reference is ``reference/gat3.py``.

The program's ``GATLayer`` is imported when this file is loaded, so a
program without per-layer GATs fails before the cell's graph is made."""
import math

import torch

from flex_tpu_torch.models.gat import GATLayer

COMBINE = ("concat", "concat", "mean")
SKIP = 2            # the layer (from 1) with the identity skip
NEGATIVE_SLOPE = 0.2  # gat_head's LeakyReLU slope


def layers(md: dict) -> list:
    """The configuration's layers as the program's ``GATLayer``; raises
    where the configuration states another architecture than this kind's
    (the reference computes this one)."""
    stated = (tuple(md["combine"]), md["skip"], md["negative_slope"],
              md["widths"][-1])
    if stated != (COMBINE, SKIP, NEGATIVE_SLOPE, md["n_classes"]) \
            or not len(md["heads"]) == len(md["widths"]) == len(COMBINE):
        raise ValueError(f"gat3 is {len(COMBINE)} layers {COMBINE}, the "
                         f"skip on layer {SKIP}, slope {NEGATIVE_SLOPE} and "
                         f"n_classes outputs; the configuration states "
                         f"{md}")
    return [GATLayer(h, w, c == "concat")
            for h, w, c in zip(md["heads"], md["widths"], md["combine"])]


def _glorot(shape, gen, device) -> torch.Tensor:
    """Glorot-uniform float32 weights with the program's fans: the last
    axis fan-out, the one before it fan-in, the leading (head) axis
    multiplying both."""
    limit = math.sqrt(6.0 / ((shape[-2] + shape[-1]) * math.prod(shape[:-2])))
    return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * limit


def weights(md: dict, gen: torch.Generator, device) -> list:
    """(W1, a1s, a1d, W2, a2s, a2d, W3, a3s, a3d): Glorot-uniform from
    ``gen`` in the program's parameter order and shapes (the a vectors
    drawn as (heads, width, 1))."""
    out, d = [], md["d_in"]
    for spec in layers(md):
        out.append(_glorot((spec.heads, d, spec.width), gen, device))
        out += [_glorot((spec.heads, spec.width, 1), gen, device)[..., 0]
                for _ in range(2)]
        d = spec.heads * spec.width if spec.concat else spec.width
    return out


def build(cell, params: list):
    """The program's GAT on the cell's device with ``params`` copied in,
    and its attention graph (``prepare_attention`` on the resident CSR)
    as ``model.attention``."""
    from flex_tpu_torch.models.gat import GAT, prepare_attention

    md = cell.cfg["model"]
    model = GAT(md["d_in"], layers=layers(md), skip=md["skip"],
                generator=torch.Generator().manual_seed(0)).to(cell.device)
    with torch.no_grad():
        for p, w in zip(model.parameters(), params):
            p.copy_(w)
    model.attention = prepare_attention(cell.g, dev=cell.csr)
    return model


def loss(model, plan, X, y, mask):
    """The program's masked cross-entropy of ``model``'s logits on its
    attention graph; ``plan``, the traffic kind's SpMM plan, is not
    read."""
    from flex_tpu_torch.models.gat import gat_loss

    return gat_loss(model, model.attention, X, y, mask)
