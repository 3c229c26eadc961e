"""Reviser command line on PyTorch: model-path revision on one GPU per process.

Counterpart of ``nanoreviser_tpu/cli/reviser.py``, with its flag surface
(reference NanoReviser.py:42-95), the multi-process flags, plus
``--device {cuda,cpu}`` (default cuda; cpu runs the plain versions).

    python -m nanoreviser_torch.cli.reviser -d <fast5_dir> -o <out> \\
        --revise_mode model -F fastq --device cuda

* ``--revise_mode model`` decodes, compacts and wire-encodes reads on
  ``infer.hostpipe.PrepPool`` worker processes (``min(--thread, usable
  CPUs)`` of them) and revises them through ``infer.StreamingReviser``;
  ``passthrough`` writes the original basecalls (fasta) or the embedded
  fastq trimmed 7/7 (fastq), byte-identical to the JAX package, decoding on
  a thread pool; ``auto`` picks model when both weight files exist.
* Multi-process: ``--coordinator_address host:port --num_processes N
  --process_id k`` (or NANOREV_COORDINATOR / NANOREV_NUM_PROCESSES /
  NANOREV_PROCESS_ID) runs N cooperating processes; each revises a
  contiguous shard of the sorted files on ``cuda:(k % device count)``.
  ``--merged_output F`` also writes one multi-record file of all reads in
  sorted order, byte-identical to a one-process run's.
* ``--revise_mode basecaller`` rebasecalls every read with an external
  basecaller (``--basecaller_exe``, config ``--basecaller_config``, by
  default ``<exe dir>/../data/dna_r9.4.1_450bps_hac.cfg``) through
  ``infer.basecaller.rebasecall_read``, reads decoded on the thread pool
  that passthrough uses. A read whose rebasecall fails degrades to its own
  bases (in fastq, the embedded fastq trimmed 7/7) and is recorded in the
  ``-e`` file; the output is byte-identical to the JAX package's. With
  ``--basecaller_model DIR`` (a Bonito CRF-CTC model directory) it runs
  that model in this process instead (``infer.basecall.Basecaller`` on
  ``--device``, the raw signals read by the prep pool's workers), with the
  same output contract: each read's basecall trimmed ``[13:-12]``, in
  fastq with a quality per base from its move's posterior.
* The per-read files are written by one writer thread
  (``io.writers.FileWriter``), in bursts, while this thread goes on
  feeding the device; a read's printed line follows its write, in read
  order, and a failed write goes to the ``-e`` file when it is known. The
  writer is joined before the merged output and the ``-e`` file are
  written, so ``main`` returns with every file written.
* ``--trace_json FILE`` traces the run (``utils.trace``: seconds and calls
  of the spans of the CLI, the prep pool and the engine, and the pool's and
  the writer's counters) and writes what it recorded to FILE as JSON at the
  end.
* Every read is processed. A read that cannot be decoded, compacted or
  encoded fails: it goes to the ``-e`` file and gets no output file. A read
  the engine cannot revise degrades to its original bases and is recorded
  in the ``-e`` file too. The exit code is 1 if any read failed or degraded.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures as cf
import json
import os
import sys
import time

from ..utils import trace


def _bounded_map(pool, fn, items, prefetch: int):
    """pool.map with a bounded prefetch window, in input order."""
    queue = collections.deque()
    for item in items:
        queue.append(pool.submit(fn, item))
        if len(queue) >= prefetch:
            yield queue.popleft().result()
    while queue:
        yield queue.popleft().result()


def get_args(argv=None):
    p = argparse.ArgumentParser(
        prog="nanoreviser",
        description="An Error-correction Tool for Nanopore Sequencing, "
                    "PyTorch/CUDA",
    )
    p.add_argument("-d", "--fast5_base_dir", required=False)
    p.add_argument("-o", "--output_dir", default="./unitest/nanorev_output/")
    p.add_argument("-F", "--output_format", default="fasta", choices=["fasta", "fastq"])
    p.add_argument("-S", "--species", default="human")
    p.add_argument("--thread", type=int, default=8, help="host ingestion threads")
    p.add_argument("-t", "--tmp_dir", dest="temp_dir", default="./unitest/tmp/")
    p.add_argument(
        "-e", "--failed_read", dest="failed_reads_filename", default="failed_reads.txt"
    )
    p.add_argument("-g", "--basecall_group", default="Basecall_1D_000")
    p.add_argument("-s", "--basecall_subgroup", default="BaseCalled_template")
    p.add_argument("--test_mode", action="store_true", default=False)
    p.add_argument("--model1_predict_dir", default="./model/human/human_win13_50ep_model1.h5")
    p.add_argument("--model2_predict_dir", default="./model/human/human_win13_50ep_model2.h5")
    p.add_argument("--model_dir_root", default="./model/")
    p.add_argument(
        "--revise_mode", default="auto",
        choices=["auto", "model", "passthrough", "basecaller"],
    )
    p.add_argument("--basecaller_exe", default="./nanorevutils/utils/bin/basecaller")
    p.add_argument("--basecaller_config", default=None)
    p.add_argument(
        "--basecaller_model", default=None, metavar="DIR",
        help="a Bonito CRF-CTC model directory (config.toml, weights_<n>.tar): "
             "--revise_mode basecaller then runs it in this process on "
             "--device instead of an external basecaller")
    p.add_argument(
        "--align", default="auto", choices=["auto", "reference", "center"],
        help="prediction-to-base alignment: 'auto' calibrates the window-"
             "center offset from the weights; 'reference' reproduces the "
             "reference's zip-from-0 wiring; 'center' uses (window-1)//2")
    p.add_argument("--merged_output", default=None)
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the CUDA kernels; cpu the plain versions")
    p.add_argument(
        "--trace_json", default=None, metavar="FILE",
        help="trace this run (utils.trace) and write its spans' seconds and "
             "calls and its counters to FILE as JSON")
    p.add_argument("-v", "--virsion", action="store_true", help="version")
    args = p.parse_args(argv)
    if args.virsion:
        print("The virsion of NanoReviser : 1.0 (nanoreviser-torch)")
        sys.exit(0)
    if not args.fast5_base_dir:
        p.print_help()
        sys.exit(1)
    return args


def _resolve_models(args) -> tuple[str, str]:
    species = "ecoli" if args.test_mode else args.species
    if species:
        root = args.model_dir_root
        m1 = os.path.join(root, species, f"{species}_win13_50ep_model1.h5")
        m2 = os.path.join(root, species, f"{species}_win13_50ep_model2.h5")
        if os.path.exists(m1) and os.path.exists(m2):
            return m1, m2
    return args.model1_predict_dir, args.model2_predict_dir


def _engine_device(device: str, rank: int, world: int) -> str:
    """Process k of a multi-process run drives cuda:(k % device count)."""
    if device != "cuda" or world == 1:
        return device
    import torch

    dev = f"cuda:{rank % max(torch.cuda.device_count(), 1)}"
    torch.cuda.set_device(dev)
    return dev


def main(argv=None) -> int:
    args = get_args(argv)
    if not args.trace_json:
        return _main(args)
    was = trace.enable(True)
    try:
        return _main(args)
    finally:
        with open(args.trace_json, "w") as fp:
            json.dump(trace.take(), fp, indent=1, sort_keys=True)
        trace.enable(was)


def _main(args) -> int:
    from .. import dist
    from ..io import (
        extract_fastq,
        format_read_fasta,
        format_read_fastq,
        get_read_data,
        list_fast5_files,
    )
    from ..io.writers import FileWriter
    from ..utils import check_path, logger_config

    is_dist = dist.initialize(args.coordinator_address, args.num_processes,
                              args.process_id)
    ok = False
    try:
        rank, world = dist.process_info() if is_dist else (0, 1)
        logger = None
        if args.test_mode:
            logger = logger_config("./unitest/unitest_log.txt", "unitest")

        m1, m2 = _resolve_models(args)
        mode = args.revise_mode
        if mode == "auto":
            mode = ("model" if (os.path.exists(m1) and os.path.exists(m2))
                    else "passthrough")
        if mode == "model" and not (os.path.exists(m1) and os.path.exists(m2)):
            raise RuntimeError(
                "！！！[Error] model file: Please check the dir of models file!!"
            )
        check_path(args.output_dir)
        with trace.span("cli.list"):
            fast5_fns = list_fast5_files(args.fast5_base_dir)
            if world > 1:
                fast5_fns = dist.shard_files(fast5_fns, rank, world)
                print(f"[p:::] process {rank}/{world}: {len(fast5_fns)} reads")
        start_time = time.time()
        failed: list[tuple[str, str]] = []

        def complain(fn: str, err) -> None:
            if args.test_mode and logger:
                logger.error("[!!! Error] Basecalling")
            elif not args.test_mode:
                print(f"！！！[Error] fast5 file: {fn}: {err}")

        def model_items():
            """(fn, WireRead, seq, qual) through the prep pool and the device."""
            from ..infer import PrepPool, StreamingReviser

            n_workers = min(max(1, args.thread), len(os.sched_getaffinity(0)))
            with trace.span("cli.pool_spawn"):
                pool = PrepPool(n_workers, args.basecall_group,
                                args.basecall_subgroup)
            try:
                with trace.span("cli.engine_init"):
                    engine = StreamingReviser(
                        m1, m2, align=args.align,
                        emit_quality=(args.output_format == "fastq"),
                        device=_engine_device(args.device, rank, world),
                    )
                with trace.span("cli.pool_ready"):
                    pool.ready()

                def prepped():
                    for fn, wire, err in pool.stream(args.fast5_base_dir,
                                                     fast5_fns):
                        if err is not None:
                            report(fn, err)
                            continue
                        yield fn, wire

                # the engine records degraded reads in `failed` before
                # yielding them
                yield from engine.revise_stream(prepped(), errors=failed)
            finally:
                with trace.span("cli.pool_close"):
                    pool.close()

        def decoded():
            """(fn, ReadData), decoded on a thread pool."""
            def load(fn: str):
                path = os.path.join(args.fast5_base_dir, fn)
                try:
                    return fn, get_read_data(path, args.basecall_group,
                                             args.basecall_subgroup), None
                except Exception as exc:  # noqa: BLE001 — a bad read fails alone
                    return fn, None, exc

            n_threads = max(1, args.thread)
            with cf.ThreadPoolExecutor(max_workers=n_threads) as pool:
                for fn, read, exc in _bounded_map(pool, load, fast5_fns,
                                                  max(2 * n_threads, 64)):
                    if exc is not None:
                        report(fn, exc)
                        continue
                    yield fn, read

        def passthrough_items():
            """(fn, ReadData, bases, None)."""
            for fn, read in decoded():
                yield fn, read, read.bases, None

        def basecaller_items():
            """(fn, ReadData, seq, qual) from the external basecaller; a
            read whose rebasecall fails is recorded and yields its own
            bases with no quality."""
            from ..infer.basecaller import DEFAULT_CONFIG_NAME, rebasecall_read

            config_fn = args.basecaller_config or os.path.join(
                os.path.dirname(args.basecaller_exe), "..", "data",
                DEFAULT_CONFIG_NAME)
            check_path(args.temp_dir)
            for fn, read in decoded():
                try:
                    seq, qual = rebasecall_read(
                        os.path.join(args.fast5_base_dir, fn), args.temp_dir,
                        args.basecaller_exe, config_fn)
                except Exception as exc:  # noqa: BLE001 — a read degrades alone
                    failed.append((fn, str(exc)))
                    yield fn, read, read.bases, None
                    continue
                yield fn, read, seq, qual

        def basecaller_model_items():
            """(fn, ReadData or None, seq, qual) from the CRF-CTC model of
            ``--basecaller_model`` in this process (``infer.basecall``),
            the raw signals read on the prep pool; a degraded read yields
            its own bases with no quality."""
            from ..infer import PrepPool
            from ..infer.basecall import Basecaller

            n_workers = min(max(1, args.thread), len(os.sched_getaffinity(0)))
            with trace.span("cli.pool_spawn"):
                pool = PrepPool(n_workers, args.basecall_group,
                                args.basecall_subgroup)
            try:
                with trace.span("cli.engine_init"):
                    engine = Basecaller(
                        args.basecaller_model,
                        device=_engine_device(args.device, rank, world),
                        emit_quality=(args.output_format == "fastq"))
                with trace.span("cli.pool_ready"):
                    pool.ready()

                def signals():
                    for fn, sig, err in pool.stream_signals(
                            args.fast5_base_dir, fast5_fns):
                        if err is not None:
                            report(fn, err)
                            continue
                        yield fn, sig

                for fn, seq, qual in engine.basecall_stream(signals(),
                                                            errors=failed):
                    if seq is not None:
                        yield fn, None, seq, qual
                        continue
                    try:
                        read = get_read_data(
                            os.path.join(args.fast5_base_dir, fn),
                            args.basecall_group, args.basecall_subgroup)
                    except Exception as exc:  # noqa: BLE001 — fails alone
                        report(fn, exc)
                        continue
                    yield fn, read, read.bases, None
            finally:
                with trace.span("cli.pool_close"):
                    pool.close()

        degraded_names: set[str] = set()
        n_failed_seen = 0

        def was_degraded(fn: str) -> bool:
            nonlocal n_failed_seen
            while n_failed_seen < len(failed):
                degraded_names.add(failed[n_failed_seen][0])
                n_failed_seen += 1
            return fn in degraded_names

        # the files are written on the writer's thread; what follows a file
        # (its printed line, its merged record, or its write error in
        # `failed`) waits in `after`, in read order, with the lines of the
        # reads that failed in between, until the writer has written it
        writer = FileWriter()
        after: collections.deque = collections.deque()  # (waits for a file, action)

        def settle() -> None:
            done = collections.deque(writer.finished())
            while after and (done or not after[0][0]):
                waits, action = after.popleft()
                action(done.popleft() if waits else None)

        def report(fn: str, err) -> None:
            failed.append((fn, str(err)))
            if after:
                after.append((False, lambda _: complain(fn, err)))
            else:
                complain(fn, err)

        def emitted(fn: str, stem: str, record, degraded: bool):
            def action(err) -> None:
                if err is not None:
                    failed.append((fn, str(err)))
                    complain(fn, err)
                    return
                if record is not None:
                    merged_records.append(record)
                if degraded:
                    if args.test_mode and logger:
                        logger.error("[!!! Error] read degraded to passthrough: %s", fn)
                    else:
                        print(f"！！！[Error] {stem} degraded to passthrough "
                              f"(see {args.failed_reads_filename})")
                elif args.test_mode and logger:
                    logger.info("Congratulations, NanoReviser is installed properly")
                elif not args.test_mode:
                    print(f"[p:::] {stem}_out.{args.output_format} was saved......")
            return action

        merged_records: list = []
        if mode == "basecaller" and args.basecaller_model:
            items = basecaller_model_items()
        else:
            items = {"model": model_items, "basecaller": basecaller_items,
                     "passthrough": passthrough_items}[mode]()
        try:
            for fn, _, seq, qual in items:
                with trace.span("cli.emit"):
                    try:
                        stem = fn.split(".")[0]
                        degraded = mode in ("model", "basecaller") and was_degraded(fn)
                        if args.output_format == "fasta":
                            out_fn = os.path.join(args.output_dir, stem + "_out.fasta")
                            text = format_read_fasta(fn, seq)
                        else:
                            out_fn = os.path.join(args.output_dir, stem + "_out.fastq")
                            if qual is None:
                                # degraded or passthrough: the reference's fastq
                                # fallback is the embedded fastq trimmed 7/7
                                seq, qual = extract_fastq(
                                    os.path.join(args.fast5_base_dir, fn),
                                    args.basecall_group, args.basecall_subgroup,
                                )
                            text = format_read_fastq(fn, seq, qual)
                        with trace.span("cli.write"):
                            writer.put(out_fn, text)
                        # the split that reading the file back gave
                        record = (tuple(text.split("\n", 1)) if args.merged_output
                                  else None)
                        after.append((True, emitted(fn, stem, record, degraded)))
                    except Exception as exc:  # noqa: BLE001 — per-read output failure
                        report(fn, exc)
                    settle()
        finally:
            try:
                items.close()   # stops the prep pool if the loop raised
            finally:
                with trace.span("cli.write_join"):
                    writer.close()
                trace.count("writer.files", writer.files)
                trace.count("writer.bursts", writer.bursts)
                trace.count("writer.busy_s", writer.busy_s)
                settle()

        with trace.span("cli.finish"):
            if args.merged_output:
                # every process writes its shard's part; process 0
                # concatenates them in shard order
                dist.write_merged_part(args.output_dir, rank, merged_records)
                if rank == 0:
                    dist.merge_parts(args.output_dir, args.merged_output, world)

            if failed and args.failed_reads_filename:
                with open(args.failed_reads_filename, "w") as fp:
                    for fn, err in failed:
                        fp.write(f"{fn}\t{err}\n")

            if not args.test_mode:
                print("[s:::] NanoReviser time consuming:%.2f seconds"
                      % (time.time() - start_time))
        ok = True
        return 0 if not failed else 1
    finally:
        if is_dist:
            dist.shutdown(wait=ok)


if __name__ == "__main__":
    sys.exit(main())
