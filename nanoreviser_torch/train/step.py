"""One training step: forward in train mode, loss, backward, Adam, then the
BN moving statistics.

Counterpart of ``nanoreviser_tpu/train/step.py:27-94``, in plain PyTorch
with autograd: the JAX package trains in plain XLA (no Pallas kernel, no
custom gradient), so the port has no hand-written kernel here either.

* Optimizer: Adam with Keras-2.2.4 defaults (lr 1e-3, betas (0.9, 0.999),
  eps 1e-7 = K.epsilon(); torch's default eps is 1e-8). Its update
  m_hat / (sqrt(v_hat) + eps) is optax's.
* BN moving statistics live in the parameter tree but are not trained:
  their JAX gradient is identically zero (the train-mode forward uses batch
  moments), so here they carry no grad and stay out of the optimizer. After
  the optimizer step they move with Keras' momentum 0.99.
* Pad rows (weight 0) take part in the BN batch moments, as in JAX, which
  normalizes over the whole padded batch; only the loss masks them.

Data parallel (``mesh``, a distributed ``parallel.Mesh``). The JAX package
jits the global step over dp-sharded arrays
(``nanoreviser_tpu/train/step.py:97-115``), so every reduction is the global
batch's. Here each process holds a slice of the global batch, and the step
keeps those semantics where plain ``DistributedDataParallel`` would not:
the BN moments are reduced across processes (``models/layers.py``), the
dropout mask is the global one's rows (``models/reviser.py``), the loss
divides by the global batch's weight (``denominator``, known on the host),
and the gradients are summed across processes, not averaged, as one flat
bucket with the step's metrics appended.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.reviser import ReviserConfig, reviser_apply
from .loss import reviser_loss

BN_KEYS = ("bn_c1", "bn_c2", "bn_r1", "bn_r2", "bn_t1")
KERAS_BN_MOMENTUM = 0.99


def default_class_weights(n_classes: int) -> np.ndarray:
    """Reference class weights {0:3, 1:5, rest:1} (NanoReviser_train.py:167)."""
    w = np.ones(n_classes, np.float32)
    w[0] = 3.0
    if n_classes > 1:
        w[1] = 5.0
    return w


def param_leaves(tree: dict, prefix=()):
    """(path, leaf) of a parameter tree in sorted path order, so that the
    optimizer's parameter order does not depend on how the tree was built."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from param_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def is_trained(path: tuple) -> bool:
    """False for the BN moving statistics, True for every other leaf."""
    return not (path[0] in BN_KEYS and path[-1] in ("mean", "var"))


def params_to_torch(params: dict, device, dtype=torch.float32) -> dict:
    """Numpy (or tensor) parameter tree -> tensors of ``dtype`` on
    ``device``, the trained leaves requiring grad. Training runs in f32;
    f64 serves the parity checks."""
    out: dict = {}
    for path, leaf in param_leaves(params):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
        t = torch.as_tensor(np.asarray(leaf)).to(device=device, dtype=dtype).clone()
        node[path[-1]] = t.requires_grad_(is_trained(path))
    return out


def params_to_numpy(params: dict) -> dict:
    out: dict = {}
    for path, leaf in param_leaves(params):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf.detach().cpu().numpy()
    return out


def keras_adam(params: dict, learning_rate: float = 1e-3) -> torch.optim.Adam:
    """Adam over the trained leaves of a tensor tree, Keras-2.2.4 settings."""
    trained = [leaf for path, leaf in param_leaves(params) if is_trained(path)]
    return torch.optim.Adam(trained, lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-7)


def update_moving_stats(params: dict, stats: dict,
                        momentum: float = KERAS_BN_MOMENTUM) -> None:
    """Keras' moving-statistics update, in place: s = s*m + batch*(1 - m)."""
    with torch.no_grad():
        for key in BN_KEYS:
            for k in ("mean", "var"):
                s = params[key][k]
                s.copy_(s * momentum + stats[key][k] * (1 - momentum))


def _sum_across(mesh, optimizer, metrics: torch.Tensor) -> torch.Tensor:
    """Sum every trained leaf's gradient and the ``metrics`` vector across
    the mesh's processes in one all-reduce; returns the summed metrics."""
    import torch.distributed as dist

    trained = [p for g in optimizer.param_groups for p in g["params"]]
    flat = torch.cat([p.grad.reshape(-1) for p in trained]
                     + [metrics.to(trained[0].grad.dtype)])
    dist.all_reduce(flat, group=mesh.group)
    off = 0
    for p in trained:
        p.grad = flat[off : off + p.numel()].view_as(p)
        off += p.numel()
    return flat[off:]


def make_train_step(
    cfg: ReviserConfig,
    class_weights: np.ndarray | None = None,
    center_loss_weight: float = 0.4,
    bn_momentum: float = KERAS_BN_MOMENTUM,
    mesh=None,
):
    """Returns ``train_step(params, optimizer, batch, generator=None,
    denominator=None) -> (metrics, stats)``.

    ``params`` is a tensor tree from ``params_to_torch`` and ``optimizer``
    a ``keras_adam`` over it; both are updated in place, and each trained
    leaf's ``.grad`` holds this step's gradient afterwards. ``batch``:
    {"signal": [B,T,50], "feats": [B,T,6], "y": [B], "weight": [B]
    (optional)} on the params' device. ``generator`` draws the dropout mask
    (needed while ``cfg.dropout_rate`` > 0). ``metrics`` ("loss",
    "ce_loss", "center_loss", "accuracy") and ``stats`` (the BN batch
    moments) are detached tensors on the device: nothing here waits for
    the card.

    Over a distributed ``mesh`` ``batch`` is this process's slice of the
    global batch and ``denominator`` is required: ``max(sum(weight), 1)``
    of the global batch. The gradients, metrics and moments are then the
    global batch's, equal on every process.
    """
    dp = mesh is not None and mesh.distributed
    if class_weights is None:
        class_weights = default_class_weights(cfg.n_classes)
    cw_host = torch.as_tensor(np.asarray(class_weights), dtype=torch.float32)
    cw_on: dict = {}

    def train_step(params, optimizer, batch, generator=None, denominator=None):
        dev = batch["signal"].device
        if dev not in cw_on:
            cw_on[dev] = cw_host.to(dev)
        if dp and denominator is None:
            raise ValueError("a distributed step needs the global batch's "
                             "denominator, max(sum(weight), 1)")
        optimizer.zero_grad(set_to_none=True)
        probs, feature, stats = reviser_apply(
            params, batch["signal"], batch["feats"], cfg, train=True,
            generator=generator, mesh=mesh)
        weight = batch.get("weight")
        if dp and weight is None:
            weight = torch.ones(probs.shape[0], device=dev)
        loss, metrics = reviser_loss(
            probs, feature, params["centers"], batch["y"], cw_on[dev],
            center_loss_weight, sample_weight=weight,
            denominator=denominator if dp else None)
        loss.backward()
        metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
        if dp:
            names = sorted(metrics)
            summed = _sum_across(mesh, optimizer,
                                 torch.stack([metrics[k] for k in names]))
            metrics = {k: summed[i].to(metrics[k].dtype)
                       for i, k in enumerate(names)}
        optimizer.step()
        stats = {k: {m: v.detach() for m, v in s.items()} for k, s in stats.items()}
        update_moving_stats(params, stats, bn_momentum)
        return metrics, stats

    return train_step
