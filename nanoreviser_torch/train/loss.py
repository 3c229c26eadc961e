"""Training loss: class-weighted sparse CE + center loss.

Counterpart of ``nanoreviser_tpu/train/loss.py`` (the reference's Keras
objective, lstmmodel.py:70-74, NanoReviser_train.py:165-172):

* primary head: sparse categorical cross-entropy over the softmax output,
  sample-weighted by class_weight[y];
* auxiliary head: center loss sum((feature - center[y])^2) with loss weight
  0.4. Keras also applies class_weight to this head through its all-zeros
  dummy target, so every sample weighs class_weight[0]; the default of
  ``center_target_weight`` reproduces that quirk;
* Keras clips the softmax outputs to [eps, 1 - eps], eps = 1e-7, before the
  log;
* a target of -1 (model2's label of a reference 'N', refvals2 - 1) picks
  the last class's probability, weight and center, as numpy and JAX
  indexing wrap it, and never counts as a hit.
"""

from __future__ import annotations

import torch

KERAS_EPS = 1e-7


def reviser_loss(
    probs: torch.Tensor,            # [B, C] softmax outputs
    feature: torch.Tensor,          # [B, 16]
    centers: torch.Tensor,          # [C, 16]
    y: torch.Tensor,                # [B] int labels
    class_weights: torch.Tensor,    # [C]
    center_loss_weight: float = 0.4,
    center_target_weight: float | torch.Tensor | None = None,
    sample_weight: torch.Tensor | None = None,   # [B]; pad rows weigh 0
    denominator: float | None = None,
) -> tuple[torch.Tensor, dict]:
    """(total loss, {"ce_loss", "center_loss", "accuracy"}), all scalars on
    the inputs' device.

    ``denominator`` replaces ``max(sum(sample_weight), 1)``: a process that
    holds a slice of a global batch passes the global batch's (known on the
    host), so that its terms are its share of the global loss and the
    processes' shares sum to it."""
    y = y.long()
    yi = torch.remainder(y, probs.shape[1])     # -1 -> the last class
    p = torch.clamp(probs, KERAS_EPS, 1.0 - KERAS_EPS)
    ce = -torch.log(torch.gather(p, 1, yi[:, None]))[:, 0]
    w = class_weights[yi]
    if center_target_weight is None:
        center_target_weight = class_weights[0]
    l2 = torch.sum((feature - centers[yi]) ** 2, dim=1)
    hit = (torch.argmax(probs, dim=-1) == y).to(torch.float32)

    if sample_weight is None:
        ce_loss = torch.mean(ce * w)
        center_loss = torch.mean(l2 * center_target_weight)
        acc = torch.mean(hit)
    else:
        denom = (torch.clamp(torch.sum(sample_weight), min=1.0)
                 if denominator is None else denominator)
        ce_loss = torch.sum(ce * w * sample_weight) / denom
        center_loss = torch.sum(l2 * center_target_weight * sample_weight) / denom
        acc = torch.sum(hit * sample_weight) / denom

    total = ce_loss + center_loss_weight * center_loss
    return total, {"ce_loss": ce_loss, "center_loss": center_loss, "accuracy": acc}
