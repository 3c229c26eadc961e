"""Training loop: Keras-fit semantics on one device or N processes.

Counterpart of ``nanoreviser_tpu/train/loop.py:31-297``: per-epoch
checkpoints with resume, the eval step (inference forward with the moving
statistics, class-weighted CE and accuracy over the validation windows),
the history dict, and the flat ``.npz`` weight format that both packages
read.

K steps per dispatch (``steps_per_dispatch``, default 8), as the JAX loop
(``nanoreviser_tpu/train/loop.py:96-133``, ``:170-195``): ``chunked``
stacks K consecutive batches of one shape, a batch left over comes alone,
and each stack is one call of ``train/step.py``'s ``make_multi_step``. On
the card that call is one replay of a CUDA graph of K whole train steps.
Measured at batch 512, T = 13 on an NVIDIA H100 80GB HBM3 (700 W,
``chip_smoke.py`` phase train): an eager step launches ≈7,100 kernels
and copies and takes 111-160 ms, the card busy ≈15 ms of it, since the
host's launching sets its pace; a replayed step takes 13.5-16 ms, the
card busy ≈13.5 ms of it (62-74 steps/s against 6.3-9.0). A thread ahead of the
loop gathers, stacks and pins the batches (≈1.1 ms a batch), each stack
goes up as one copy into the graph's static inputs, and the losses and
accuracies stay on the device until the epoch ends, so nothing inside an
epoch waits for the card. On the CPU a call is K eager steps. Across
processes K is 1 and the step is eager, as the JAX loop keeps K = 1
across processes; validation is eager everywhere.

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
    load_optimizer_state,
    make_multi_step,
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


def _host_tensors(batch: dict, pin: bool) -> dict:
    """numpy batch (or stack) -> CPU tensors, targets as int64; in pinned
    memory if ``pin``."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k == "y":
            t = t.long()
        out[k] = t.pin_memory() if pin else t
    return out


def _uploader(device: torch.device):
    """numpy batch -> tensors on ``device``; from pinned memory without
    waiting for the copy on the card."""
    cuda = device.type == "cuda"

    def up(batch: dict) -> dict:
        return {k: t.to(device, non_blocking=True)
                for k, t in _host_tensors(batch, cuda).items()}

    return up


def chunked(batches, k: int):
    """(count, stack) per dispatch: every ``k`` consecutive batches of one
    shape stacked on a new leading axis (count ``k``), and a batch left
    over at a change of shape or at the end, alone (count 1). The JAX
    loop's rule (``nanoreviser_tpu/train/loop.py:170-195``); there a batch
    left over comes unstacked, here as a stack of one."""
    buf: list = []

    def flush():
        if len(buf) == k:
            yield k, {key: np.stack([b[key] for b in buf]) for key in buf[0]}
        else:
            for b in buf:
                yield 1, {key: v[None] for key, v in b.items()}
        buf.clear()

    for b in batches:
        if buf and b["y"].shape != buf[0]["y"].shape:
            yield from flush()
        buf.append(b)
        if len(buf) == k:
            yield from flush()
    yield from flush()


def _prefetched(items, prepare, depth: int = 2):
    """``prepare(item)`` for each item, ``depth`` ahead of the caller: one
    host thread draws the items (the batch gather and stacking happen in
    that iterator) and prepares them (pinning, upload) while the caller
    enqueues the previous ones."""
    items = iter(items)
    end = object()

    def produce():
        item = next(items, end)
        return item if item is end else prepare(item)

    with cf.ThreadPoolExecutor(1) as pool:
        queue = [pool.submit(produce) for _ in range(depth + 1)]
        while (out := queue.pop(0).result()) is not end:
            queue.append(pool.submit(produce))
            yield out


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
    multiple of N (the CLI rounds it up). ``steps_per_dispatch``: K train
    steps per dispatch on one process, 1 over N (module docstring).
    """
    from ..parallel import Mesh

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
    k_steps = 1 if dp else max(1, steps_per_dispatch)
    graphed = dev.type == "cuda" and not dp
    cfg = ReviserConfig(window=window, n_classes=n_classes)
    params = init_params
    if params is None:
        params = init_reviser_params(torch.Generator().manual_seed(seed), cfg)
    if "centers" not in params:
        params = dict(params)
        params["centers"] = np.zeros((n_classes, 16), np.float32)
    params = params_to_torch(params, dev)
    optimizer = keras_adam(params, learning_rate, capturable=graphed)
    start_epoch = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        ck = load_checkpoint(checkpoint_path)
        params = params_to_torch(ck["params"], dev)
        optimizer = keras_adam(params, learning_rate, capturable=graphed)
        load_optimizer_state(optimizer, ck["opt_state"])
        start_epoch = ck["epoch"]
        if verbose:
            print(f"[p:::] resumed from {checkpoint_path} at epoch {start_epoch}")

    cw = torch.as_tensor(default_class_weights(n_classes), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if dp:
        from ..dist import distribute_batch, local_batch_slice

        step = make_train_step(cfg, mesh=mesh)

        def upload(batch: dict):
            """(this process's slice on the device, the global batch's
            loss denominator)."""
            denom = max(float(np.sum(batch["weight"], dtype=np.float64)), 1.0)
            local = local_batch_slice(batch, mesh.rank, mesh.world)
            return distribute_batch(mesh, local), denom

        def train_epoch():
            """(loss [1], accuracy [1]) per step."""
            for batch, denom in _prefetched(it.epoch(), upload):
                metrics, _ = step(params, optimizer, batch, gen, denominator=denom)
                yield metrics["loss"][None], metrics["accuracy"][None]
    else:
        up = _uploader(dev)
        multi_step = make_multi_step(cfg, device=dev)

        def upload(batch: dict):
            return up(batch), None

        def train_epoch():
            """(loss [K], accuracy [K]) per dispatch of K steps."""
            stacks = _prefetched(chunked(it.epoch(), k_steps),
                                 lambda c: _host_tensors(c[1], pin=graphed))
            for stack in stacks:
                metrics = multi_step(params, optimizer, stack, gen)
                yield metrics["loss"], metrics["accuracy"]

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
        for loss, acc in train_epoch():
            losses.append(loss)
            accs.append(acc)
        ep_loss = float(torch.cat(losses).mean())
        ep_acc = float(torch.cat(accs).mean())
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
