"""Multi-process runs: torch.distributed, file sharding, batch slices.

Counterpart of ``nanoreviser_tpu/dist/__init__.py``:

* ``initialize`` joins N processes (one per GPU, on one host or several)
  into a gloo process group over TCP. In inference it carries only
  barriers, as every process revises its own reads on its own card; in
  training ``parallel.make_mesh`` builds the reducing group on it;
* ``shard_files`` gives every process a deterministic, disjoint,
  contiguous slice of the sorted file list, so per-read outputs never
  collide and the optional single-file merge (``write_merged_part`` +
  ``merge_parts``) is in shard order and byte-identical to one process's,
  whatever order the processes finish in;
* ``local_batch_slice`` and ``distribute_batch``: every training process
  builds the same global batch and uploads its own contiguous slice.

torch is imported inside the functions that need it.
"""

from __future__ import annotations

import os
import time


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join the process group when multi-process flags or the environment
    ask for it; returns True when running multi-process.

    Arguments fall back to NANOREV_COORDINATOR (``host:port`` of process 0),
    NANOREV_NUM_PROCESSES and NANOREV_PROCESS_ID."""
    coordinator_address = coordinator_address or os.environ.get(
        "NANOREV_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("NANOREV_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("NANOREV_PROCESS_ID")
        process_id = int(pid) if pid is not None else None

    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(
            f"process id {process_id} is not in [0, {num_processes}): pass "
            f"--process_id or NANOREV_PROCESS_ID")

    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


def process_info() -> tuple[int, int]:
    """(process index, process count); (0, 1) when not distributed."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    """Block until every process reaches this point (no-op single-process)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def shutdown(wait: bool = True) -> None:
    """Leave the process group; with ``wait``, once every process has
    reached this point (a process that failed leaves at once)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        if wait:
            barrier()
        dist.destroy_process_group()


def shard_files(
    fns: list[str], process_index: int, process_count: int
) -> list[str]:
    """Deterministic disjoint shard of a sorted file list.

    Contiguous slices of the sorted order (extra files go to the first
    shards), so concatenating per-shard outputs in shard order reproduces
    the global sorted order. Every file goes to exactly one process."""
    fns = sorted(fns)
    n, w, k = len(fns), process_count, process_index
    base, extra = divmod(n, w)
    start = k * base + min(k, extra)
    return fns[start : start + base + (1 if k < extra else 0)]


def write_merged_part(
    out_dir: str, process_index: int, records: list[tuple[str, str]]
) -> str:
    """Write this shard's (header, body) records as ``merged.part<k>`` and
    a done marker. ``records`` are in this shard's sorted-name order."""
    part_fn = os.path.join(out_dir, f"merged.part{process_index:05d}")
    tmp = part_fn + ".tmp"
    with open(tmp, "w") as fp:
        for header, body in records:
            fp.write(header + "\n" + body + "\n")
    os.replace(tmp, part_fn)
    with open(part_fn + ".done", "w") as fp:
        fp.write("ok\n")
    return part_fn


def merge_parts(
    out_dir: str, merged_fn: str, process_count: int, timeout_s: float = 600.0
) -> str:
    """Process 0: wait for every shard's part on the shared file system,
    concatenate them in shard order and remove them."""
    parts = [os.path.join(out_dir, f"merged.part{k:05d}")
             for k in range(process_count)]
    deadline = time.time() + timeout_s
    for part in parts:
        while not os.path.exists(part + ".done"):
            if time.time() > deadline:
                raise TimeoutError(f"missing shard output {part}")
            time.sleep(0.2)
    tmp = merged_fn + ".tmp"
    with open(tmp, "w") as out:
        for part in parts:
            with open(part) as fp:
                out.write(fp.read())
    os.replace(tmp, merged_fn)
    for part in parts:
        os.remove(part)
        os.remove(part + ".done")
    return merged_fn


# ------------------------------------------------------- batch distribution


def distribute_batch(mesh, batch: dict) -> dict:
    """This process's numpy slice of the global batch -> tensors on the
    mesh's device (from pinned memory, without waiting for the copy)."""
    from ..train.loop import _uploader

    return _uploader(mesh.device)(batch)


def local_batch_slice(batch: dict, process_index: int, process_count: int):
    """The slice of a globally-constructed batch owned by this process."""
    out = {}
    for k, v in batch.items():
        n = len(v)
        per = n // process_count
        out[k] = v[process_index * per : (process_index + 1) * per]
    return out
