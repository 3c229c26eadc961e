"""Reviser command line on PyTorch: model-path revision on one GPU.

Counterpart of ``nanoreviser_tpu/cli/reviser.py``, with its flag surface
for the model and passthrough modes (reference NanoReviser.py:42-95) plus
``--device {cuda,cpu}`` (default cuda; cpu runs the plain versions).

    python -m nanoreviser_torch.cli.reviser -d <fast5_dir> -o <out> \\
        --revise_mode model -F fastq --device cuda

* ``--revise_mode model`` decodes reads on a thread pool
  (``get_read_data -> compact_read_numpy -> encode_read``) and revises them
  through ``infer.StreamingReviser``; ``passthrough`` writes the original
  basecalls (fasta) or the embedded fastq trimmed 7/7 (fastq),
  byte-identical to the JAX package; ``auto`` picks model when both weight
  files exist.
* ``--revise_mode basecaller``, ``--merged_output`` and the multi-host
  flags are not yet ported and raise.
* Every read is processed; failed reads are written to the ``-e`` file and
  the exit code is 1 if any read failed or degraded.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures as cf
import os
import sys
import time


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


def main(argv=None) -> int:
    args = get_args(argv)
    if args.revise_mode == "basecaller":
        raise NotImplementedError("--revise_mode basecaller is not yet ported")
    if args.merged_output:
        raise NotImplementedError("--merged_output is not yet ported")
    if args.coordinator_address or (args.num_processes or 1) > 1:
        raise NotImplementedError("multi-host runs are not yet ported")

    from ..infer.wire import encode_read
    from ..io import (
        extract_fastq,
        get_read_data,
        list_fast5_files,
        write_read_fasta,
        write_read_fastq,
    )
    from ..signal.host_prep import compact_read_numpy
    from ..utils import check_path, logger_config

    logger = None
    if args.test_mode:
        logger = logger_config("./unitest/unitest_log.txt", "unitest")

    m1, m2 = _resolve_models(args)
    mode = args.revise_mode
    if mode == "auto":
        mode = "model" if (os.path.exists(m1) and os.path.exists(m2)) else "passthrough"
    if mode == "model" and not (os.path.exists(m1) and os.path.exists(m2)):
        raise RuntimeError(
            "！！！[Error] model file: Please check the dir of models file!!"
        )

    check_path(args.output_dir)
    engine = None
    if mode == "model":
        from ..infer import StreamingReviser

        engine = StreamingReviser(
            m1, m2, align=args.align,
            emit_quality=(args.output_format == "fastq"),
            device=args.device,
        )

    fast5_fns = list_fast5_files(args.fast5_base_dir)
    start_time = time.time()
    failed: list[tuple[str, str]] = []

    def report(fn: str, err) -> None:
        failed.append((fn, str(err)))
        if args.test_mode and logger:
            logger.error("[!!! Error] Basecalling")
        elif not args.test_mode:
            print(f"！！！[Error] fast5 file: {fn}: {err}")

    def load(fn: str):
        path = os.path.join(args.fast5_base_dir, fn)
        try:
            read = get_read_data(path, args.basecall_group, args.basecall_subgroup)
        except Exception as exc:  # noqa: BLE001 — per-read degradation
            return fn, None, None, exc
        wire = None
        if mode == "model":
            try:
                wire = encode_read(compact_read_numpy(read))
            except Exception:  # noqa: BLE001 — the engine degrades the read
                wire = None    # itself and records why
        return fn, read, wire, None

    def revised_items(loaded):
        """(fn, read, seq, qual) tuples; model mode streams through the device."""
        def ok_reads():
            for fn, read, wire, exc in loaded:
                if exc is not None:
                    report(fn, exc)
                    continue
                yield fn, read, wire

        if mode == "model":
            items = ((fn, wire if wire is not None else read)
                     for fn, read, wire in ok_reads())
            # the engine records degraded reads in `failed` before yielding
            for fn, read, seq, qual in engine.revise_stream(items, errors=failed):
                yield fn, read, seq, qual
        else:
            for fn, read, _ in ok_reads():
                yield fn, read, read.bases, None

    degraded_names: set[str] = set()
    n_failed_seen = 0

    def was_degraded(fn: str) -> bool:
        nonlocal n_failed_seen
        while n_failed_seen < len(failed):
            degraded_names.add(failed[n_failed_seen][0])
            n_failed_seen += 1
        return fn in degraded_names

    n_threads = max(1, args.thread)
    with cf.ThreadPoolExecutor(max_workers=n_threads) as pool:
        loaded = _bounded_map(pool, load, fast5_fns, max(2 * n_threads, 64))
        for fn, read, seq, qual in revised_items(loaded):
            try:
                stem = fn.split(".")[0]
                if args.output_format == "fasta":
                    out_fn = os.path.join(args.output_dir, stem + "_out.fasta")
                    write_read_fasta(fn, out_fn, seq)
                else:
                    out_fn = os.path.join(args.output_dir, stem + "_out.fastq")
                    if qual is None:
                        # degraded or passthrough: the reference's fastq
                        # fallback is the embedded fastq trimmed 7/7
                        seq, qual = extract_fastq(
                            os.path.join(args.fast5_base_dir, fn),
                            args.basecall_group, args.basecall_subgroup,
                        )
                    write_read_fastq(fn, out_fn, seq, qual)
                if mode == "model" and was_degraded(fn):
                    if args.test_mode and logger:
                        logger.error(
                            "[!!! Error] read degraded to passthrough: %s", fn)
                    else:
                        print(f"！！！[Error] {stem} degraded to passthrough "
                              f"(see {args.failed_reads_filename})")
                elif args.test_mode and logger:
                    logger.info("Congratulations, NanoReviser is installed properly")
                elif not args.test_mode:
                    print(f"[p:::] {stem}_out.{args.output_format} was saved......")
            except Exception as exc:  # noqa: BLE001 — per-read output failure
                report(fn, exc)

    if failed and args.failed_reads_filename:
        with open(args.failed_reads_filename, "w") as fp:
            for fn, err in failed:
                fp.write(f"{fn}\t{err}\n")

    if not args.test_mode:
        print("[s:::] NanoReviser time consuming:%.2f seconds"
              % (time.time() - start_time))
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
