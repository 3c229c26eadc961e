"""Training loop: Keras-fit semantics on one device or N processes.

Counterpart of ``nanoreviser_tpu/train/loop.py:31-297``: per-epoch
checkpoints with resume, the eval step (inference forward with the moving
statistics, class-weighted CE and accuracy over the validation windows),
the history dict, and the flat ``.npz`` weight format that both packages
read.

The JAX loop scans K steps per dispatch (``steps_per_dispatch``) to hide
the host's dispatch latency. Here nothing inside an epoch waits for the
card instead: each step is enqueued as soon as the host has built it,
batches go up from pinned memory with ``non_blocking=True``, and the
losses and accuracies stay on the device until the epoch ends. So the
card runs ahead of the host by as many steps as the allocator allows, and
``steps_per_dispatch`` is accepted for signature parity and changes
nothing.

Data parallel (``mesh``, a ``parallel.Mesh`` of N processes): as in the JAX
package (``nanoreviser_tpu/train/loop.py:135-145``), every process builds the
same global batches from the same seed and trains on its own slice of each
(``dist.local_batch_slice``); the step reduces across processes so that the
result is one process's on the global batches (``train/step.py``). The
validation sums are reduced once per epoch, so ``history`` is global; only
process 0 writes the checkpoint, and every process resumes from it.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import time

import numpy as np
import torch

from ..models.reviser import ReviserConfig, init_reviser_params, reviser_apply
from .data import BatchIterator
from .step import (
    default_class_weights,
    keras_adam,
    make_train_step,
    params_to_numpy,
    params_to_torch,
)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_cpu(v) for v in obj]
    return obj


def save_checkpoint(path: str, params: dict, optimizer: torch.optim.Optimizer,
                    epoch: int) -> None:
    """Write the params (as numpy), Adam's ``state_dict`` (on the CPU) and
    the number of epochs done, atomically (a temporary file, then
    ``os.replace``). The checkpoint is the port's own format: the JAX
    package's pickled optax state does not load here, nor this there."""
    payload = {"params": params_to_numpy(params),
               "opt_state": _to_cpu(optimizer.state_dict()), "epoch": epoch}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    """{"params", "opt_state", "epoch"} of ``save_checkpoint`` (this
    program's own file, so unpickling it is safe)."""
    return torch.load(path, map_location="cpu", weights_only=False)


def resolve_device(device) -> torch.device:
    """``None`` means the card; a card that is absent raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is available; pass "
                "device='cpu' to train on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _uploader(device: torch.device):
    """numpy batch -> tensors on ``device``; from pinned memory without
    waiting for the copy on the card."""
    cuda = device.type == "cuda"

    def up(batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if k == "y":
                t = t.long()
            out[k] = t.pin_memory().to(device, non_blocking=True) if cuda else t
        return out

    return up


def _prefetched(batches, pinned, depth: int = 2):
    """Build (gather and pin) the next batches on a host thread while the
    current one is enqueued."""
    with cf.ThreadPoolExecutor(1) as pool:
        queue = []
        for b in batches:
            queue.append(pool.submit(pinned, b))
            if len(queue) > depth:
                yield queue.pop(0).result()
        while queue:
            yield queue.pop(0).result()


def train_model(
    x_train: np.ndarray,
    signal_x_train: np.ndarray,
    y_train: np.ndarray,
    *,
    n_classes: int,
    window: int,
    epochs: int = 50,
    batch_size: int = 512,
    validation_split: float = 0.01,
    learning_rate: float = 1e-3,
    seed: int = 0,
    init_params=None,
    checkpoint_path: str | None = None,
    resume: bool = False,
    verbose: bool = True,
    mesh=None,
    steps_per_dispatch: int = 8,
    device=None,
) -> tuple[dict, dict]:
    """Train one reviser model; returns (numpy params, history dict of lists).

    x_train/signal_x_train are either pre-windowed [W, T, *] tensors or
    streaming base arrays [N, *] (windows gathered per batch; see
    BatchIterator); y_train is [W, 1] window-centre targets either way.
    ``device``: None means the card (raises without one); "cpu" trains on
    the CPU. ``mesh``: a ``parallel.Mesh``; training runs on its device,
    and over N processes ``batch_size`` is the global batch and must be a
    multiple of N (the CLI rounds it up). ``steps_per_dispatch`` has no
    effect (module docstring).
    """
    from ..parallel import Mesh

    del steps_per_dispatch
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh, not {type(mesh).__name__}")
    if (mesh is not None and device is not None
            and torch.device(device).type != mesh.device.type):
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    dev = resolve_device(device) if mesh is None else mesh.device
    dp = mesh is not None and mesh.distributed
    if dp and batch_size % mesh.world:
        raise ValueError(f"batch_size {batch_size} is not a multiple of the "
                         f"{mesh.world} processes")
    rank = mesh.rank if dp else 0
    cfg = ReviserConfig(window=window, n_classes=n_classes)
    params = init_params
    if params is None:
        params = init_reviser_params(torch.Generator().manual_seed(seed), cfg)
    if "centers" not in params:
        params = dict(params)
        params["centers"] = np.zeros((n_classes, 16), np.float32)
    params = params_to_torch(params, dev)
    optimizer = keras_adam(params, learning_rate)
    start_epoch = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        ck = load_checkpoint(checkpoint_path)
        params = params_to_torch(ck["params"], dev)
        optimizer = keras_adam(params, learning_rate)
        optimizer.load_state_dict(ck["opt_state"])
        start_epoch = ck["epoch"]
        if verbose:
            print(f"[p:::] resumed from {checkpoint_path} at epoch {start_epoch}")

    step = make_train_step(cfg, mesh=mesh)
    cw = torch.as_tensor(default_class_weights(n_classes), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if dp:
        from ..dist import distribute_batch, local_batch_slice

        def upload(batch: dict):
            """(this process's slice on the device, the global batch's
            loss denominator)."""
            denom = max(float(np.sum(batch["weight"], dtype=np.float64)), 1.0)
            local = local_batch_slice(batch, mesh.rank, mesh.world)
            return distribute_batch(mesh, local), denom
    else:
        up = _uploader(dev)

        def upload(batch: dict):
            return up(batch), None

    @torch.no_grad()
    def eval_step(batch, denom=None):
        """(loss, accuracy) of a batch; given the global batch's
        ``denom``, this slice's shares of them."""
        probs, _ = reviser_apply(params, batch["signal"], batch["feats"], cfg)
        y, w = batch["y"], batch["weight"]
        yi = torch.remainder(y, n_classes)      # -1 -> the last class (loss.py)
        pc = torch.clamp(probs, 1e-7, 1 - 1e-7)
        ce = -torch.log(torch.gather(pc, 1, yi[:, None]))[:, 0]
        if denom is None:
            denom = torch.clamp(torch.sum(w), min=1.0)
        loss = torch.sum(ce * cw[yi] * w) / denom
        acc = torch.sum((torch.argmax(probs, -1) == y) * w) / denom
        return loss, acc

    it = BatchIterator(x_train, signal_x_train, y_train, batch_size,
                       validation_split, seed, window=window)
    history: dict[str, list] = {
        "loss": [], "accuracy": [], "val_loss": [], "val_accuracy": [],
    }
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        losses, accs = [], []
        for batch, denom in _prefetched(it.epoch(), upload):
            metrics, _ = step(params, optimizer, batch, gen, denominator=denom)
            losses.append(metrics["loss"])
            accs.append(metrics["accuracy"])
        ep_loss = float(torch.stack(losses).mean())
        ep_acc = float(torch.stack(accs).mean())
        vl, va = [], []
        for batch, denom in _prefetched(it.validation(), upload):
            loss, acc = eval_step(batch, denom)
            vl.append(loss)
            va.append(acc)
        if dp and vl:
            import torch.distributed as dist

            shares = torch.stack([torch.stack(vl), torch.stack(va)])
            dist.all_reduce(shares, group=mesh.group)
            vl, va = list(shares[0]), list(shares[1])
        val_loss = float(torch.stack(vl).mean()) if vl else float("nan")
        val_acc = float(torch.stack(va).mean()) if va else float("nan")
        history["loss"].append(ep_loss)
        history["accuracy"].append(ep_acc)
        history["val_loss"].append(val_loss)
        history["val_accuracy"].append(val_acc)
        if verbose:
            print(
                f"[p:::] epoch {epoch + 1}/{epochs} loss={ep_loss:.4f} "
                f"acc={ep_acc:.4f} val_loss={val_loss:.4f} "
                f"({time.time() - t0:.1f}s)"
            )
        if checkpoint_path and rank == 0:
            save_checkpoint(checkpoint_path, params, optimizer, epoch + 1)

    return params_to_numpy(params), history


def save_params_npz(params: dict, path: str) -> None:
    """Flat ``.npz`` of a parameter tree, keys ``a/b/c`` (the JAX package's
    layout: each package loads the other's files)."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}/", v)
        else:
            flat[prefix[:-1]] = np.asarray(node)

    walk("", params)
    np.savez(path, **flat)


def load_params_npz(path: str) -> dict:
    z = np.load(path)
    params: dict = {}
    for key in z.files:
        parts = key.split("/")
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key]
    return params
