"""Training command line on PyTorch: label reads, then train on one GPU or
on N processes, one GPU each.

Counterpart of ``nanoreviser_tpu/cli/train.py``, flag-compatible with the
reference ``NanoReviser_train.py`` (:30-114): -d, -o, -r/--reference,
--model_type, -S/--species, -M/--output_model, -m/--mapper_exe, -L,
--thread, -t, -f, -g, -s, -b/--batch_size, -e/--epochs, -w/--window_size,
-c/--read_counts, --validation_split, --model{1,2}_train_dir, --test_mode,
-v, plus the JAX package's --aligner, --resume and multi-process flags and
``--device {cuda,cpu}`` (default cuda; a host without a card raises).

    python -m nanoreviser_torch.cli.train -d <fast5_dir> -r <genome.fasta> \\
        --model_type both -e 50 -b 512 -w 13 --thread 8

Steps:
1. label every read with the banded Smith-Waterman aligner (``--aligner
   sw``, the port's host library) or GraphMap (``--aligner graphmap``), on
   ``--thread`` threads (the aligner's C call releases the GIL);
2. cache each read's labels as a reference-compatible ``.npz`` under
   ``<-M>/<species>/training_input/``;
3. build the streaming windowed corpus;
4. train model1 and/or model2 (``train.loop.train_model``, Keras-2.2.4
   semantics), from ``--model{1,2}_train_dir`` weights when given, with a
   per-epoch checkpoint that ``--resume`` continues from;
5. write the ``.npz`` weights, the Keras ``.h5``, the history CSV and the
   parameters JSON under the reference's names.

Multi-process: ``--coordinator_address host:port --num_processes N
--process_id k`` (or NANOREV_COORDINATOR / NANOREV_NUM_PROCESSES /
NANOREV_PROCESS_ID) runs N cooperating processes, process k on
``cuda:(k % device count)`` (or the CPU with ``--device cpu``). Each labels
a contiguous shard of the sorted reads into the shared cache (failed reads
go to ``-f`` suffixed ``.rank<k>``), and after a barrier all of them build
the same corpus and train data-parallel over the ``dp`` mesh
(``parallel.make_mesh``) on global batches of ``-b``, rounded up to a
multiple of N. Process 0 alone writes the checkpoint and the artifacts;
no process cleans up before every process is done.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time


def get_args(argv=None):
    p = argparse.ArgumentParser(prog="nanoreviser-train")
    p.add_argument("-d", "--fast5_base_dir", default="./unitest/training_data/fast5/")
    p.add_argument("-o", "--output_dir", default="./unitest/nanorev_training_result/")
    p.add_argument("-r", "--reference", dest="genome_fn",
                   default="./unitest/training_data/reference.fasta")
    p.add_argument("--model_type", default="both", choices=["both", "model1", "model2"])
    p.add_argument("-S", "--species", default="unitest")
    p.add_argument("-M", "--output_model", dest="model_dir", default="./model/")
    p.add_argument("-m", "--mapper_exe", dest="graphmap_exe", default="graphmap")
    p.add_argument("-L", "--output_format", default="sam")
    p.add_argument("--thread", type=int, default=2)
    p.add_argument("-t", "--tmp_dir", dest="temp_dir", default="./train_tmp/")
    p.add_argument("-f", "--failed_read", dest="failed_reads_filename",
                   default="failed_reads.txt")
    p.add_argument("-g", "--basecall_group", default="Basecall_1D_000")
    p.add_argument("-s", "--basecall_subgroup", default="BaseCalled_template")
    p.add_argument("-b", "--batch_size", type=int, default=512)
    p.add_argument("-e", "--epochs", type=int, default=50)
    p.add_argument("-w", "--window_size", type=int, default=13)
    p.add_argument("-c", "--read_counts", type=int, default=0)
    p.add_argument("--validation_split", type=float, default=0.01)
    p.add_argument("--model1_train_dir", default="")
    p.add_argument("--model2_train_dir", default="")
    p.add_argument("--aligner", default="sw", choices=["sw", "graphmap"])
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--test_mode", action="store_true", default=False)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda trains on the card; cpu on the CPU")
    p.add_argument("-v", "--virsion", action="store_true")
    args = p.parse_args(argv)
    if args.virsion:
        print("The virsion of NanoReviser : 1.0 (nanoreviser-torch)")
        sys.exit(0)
    args.model_dir = os.path.join(str(args.model_dir), str(args.species)) + "/"
    args.train_input_dir = os.path.join(args.model_dir, "training_input") + "/"
    args.train_model_dir = os.path.join(args.model_dir, "training_model") + "/"
    return args


def _test_mode_pseudo_genome(args) -> str:
    """Test-mode fallback when the training genome is absent: a genome made
    of the first read's decoded bases, so that ``--test_mode`` still runs
    decode -> align -> label -> window -> train end to end (self-alignment
    gives all-match labels)."""
    from ..io import get_read_data, list_fast5_files
    from ..utils import check_path

    fns = list_fast5_files(args.fast5_base_dir)
    if not fns:
        raise RuntimeError(f"no fast5 files in {args.fast5_base_dir}")
    rd = get_read_data(
        os.path.join(args.fast5_base_dir, fns[0]),
        args.basecall_group,
        args.basecall_subgroup,
    )
    check_path(args.temp_dir)
    genome_fn = os.path.join(args.temp_dir, "pseudo_reference.fasta")
    with open(genome_fn, "w") as fp:
        fp.write(">pseudo_ref\n" + rd.bases + "\n")
    return genome_fn


def _preprocess(args, rank: int = 0, world: int = 1) -> int:
    """Label reads -> per-read .npz cache, on ``--thread`` threads; over N
    processes, this process's shard of the reads. Returns the number of
    reads labelled; failures go to ``-f`` (suffixed ``.rank<k>`` over N
    processes, so that shards never overwrite each other's)."""
    import concurrent.futures as cf

    from ..io import list_fast5_files, parse_fasta
    from ..train.data import label_read, save_read_npz
    from ..utils import check_path

    if args.test_mode and not os.path.exists(args.genome_fn):
        args.genome_fn = _test_mode_pseudo_genome(args)
    genome = parse_fasta(args.genome_fn)
    kmer_index = None
    if args.aligner == "sw":
        from ..align.sw import KmerIndex

        kmer_index = KmerIndex(genome)
    fast5_fns = list_fast5_files(args.fast5_base_dir)
    if args.read_counts and args.read_counts < len(fast5_fns):
        fast5_fns = fast5_fns[: args.read_counts]
    if world > 1:
        from ..dist import shard_files

        fast5_fns = shard_files(fast5_fns, rank, world)
    check_path(args.train_input_dir)

    def one(fn: str):
        labeled = label_read(
            os.path.join(args.fast5_base_dir, fn),
            genome,
            engine=args.aligner,
            kmer_index=kmer_index,
            genome_fn=args.genome_fn,
            graphmap_exe=args.graphmap_exe,
            tmp_dir=args.temp_dir,
            basecall_group=args.basecall_group,
            basecall_subgroup=args.basecall_subgroup,
        )
        save_read_npz(labeled, os.path.join(args.train_input_dir, fn.split(".")[0]))
        return fn

    failed = []
    n_ok = 0
    with cf.ThreadPoolExecutor(max_workers=max(1, args.thread)) as pool:
        futures = {pool.submit(one, fn): fn for fn in fast5_fns}
        for fut in cf.as_completed(futures):
            fn = futures[fut]
            try:
                fut.result()
                n_ok += 1
                if not args.test_mode:
                    print(f"[s:::] {fn.split('.')[0]}.npz has been saved......")
            except Exception as exc:  # noqa: BLE001 — a bad read fails alone
                failed.append((fn, str(exc)))
                if not args.test_mode:
                    print(f"！！！[Error] {fn.split('.')[0]}: {exc}")
    if failed and args.failed_reads_filename:
        path = args.failed_reads_filename
        if world > 1:
            path += f".rank{rank}"
        with open(path, "w") as fp:
            for fn, err in sorted(failed):
                fp.write(f"{fn}\t{err}\n")
    return n_ok


def main(argv=None) -> int:
    args = get_args(argv)
    from ..train.loop import resolve_device

    resolve_device(args.device)   # no card: raise before any work
    from .. import dist

    is_dist = dist.initialize(args.coordinator_address, args.num_processes,
                              args.process_id)
    rc = 1
    try:
        rc = _run(args, *(dist.process_info() if is_dist else (0, 1)))
        return rc
    finally:
        # a process that failed leaves at once: its peers' collectives
        # then fail instead of waiting for it
        if is_dist:
            dist.shutdown(wait=rc == 0)


def _run(args, rank: int, world: int) -> int:
    from ..dist import barrier
    from ..models import load_keras_weights, save_keras_weights
    from ..parallel import make_mesh
    from ..train.data import load_training_corpus
    from ..train.loop import save_params_npz, train_model
    from ..utils import check_path, logger_config, model_fn_generate
    from ..utils.files import summary_generate, write_summary_file

    mesh = make_mesh(args.device)   # process k: cuda:(k % device count)
    logger = None
    if args.test_mode:
        logger = logger_config("./unitest/unitest_log.txt", "unitest")
        args.epochs = 2
        args.read_counts = 1
        args.window_size = 5

    start_time = time.time()
    try:
        check_path(args.temp_dir)
        check_path(args.output_dir)
        check_path(args.train_input_dir)
        n_ok = _preprocess(args, rank, world)
        # every process labels its shard into the shared cache; all shards
        # must be there before any process builds the (global) corpus
        barrier()
        if world == 1 and n_ok == 0:
            raise RuntimeError("no reads could be labeled")
        check_path(args.train_model_dir)

        corpus = load_training_corpus(args.train_input_dir, args.window_size)
        if corpus.y.size == 0:
            raise RuntimeError("no reads could be labeled")
        # global batches divide evenly across the processes
        if args.batch_size % world:
            args.batch_size += world - args.batch_size % world

        jobs = []
        if args.model_type in ("both", "model1"):
            jobs.append(("model1", corpus.y, 6, args.model1_train_dir))
        if args.model_type in ("both", "model2"):
            jobs.append(("model2", corpus.y2, 5, args.model2_train_dir))

        for tag, y, n_classes, init_dir in jobs:
            t0 = time.time()
            init_params = None
            if init_dir:
                init_params, _, _ = load_keras_weights(init_dir)
            pre_fn, train_fn, hist_fn, summary_fn = model_fn_generate(
                args.model_dir, args.train_model_dir, args.output_dir,
                args.species, args.window_size, args.epochs, tag,
            )
            params, history = train_model(
                corpus.feats, corpus.signal, y,
                n_classes=n_classes,
                window=args.window_size,
                epochs=args.epochs,
                batch_size=args.batch_size,
                validation_split=args.validation_split,
                init_params=init_params,
                checkpoint_path=os.path.join(
                    args.train_model_dir, f"{tag}_checkpoint.pt"
                ),
                resume=args.resume,
                verbose=not args.test_mode and rank == 0,
                mesh=mesh,
            )
            if rank == 0:
                # the params are equal on every process; one writes them
                save_params_npz(params, pre_fn.replace(".h5", ".npz"))
                save_keras_weights(params, pre_fn, window=args.window_size,
                                   n_classes=n_classes)
                save_params_npz(params, train_fn.replace(".h5", ".npz"))
                write_summary_file(history, summary_generate(args, t0), hist_fn,
                                   summary_fn)
            if not args.test_mode:
                print(f"[p:::] {tag} completed......")

        barrier()   # no process removes what another may still read
        if args.test_mode and logger:
            logger.info("Congratulations, NanoReviser_train is installed properly")
            if rank == 0:
                for path in (args.output_dir, args.model_dir):
                    if os.path.exists(path):
                        shutil.rmtree(path)
        else:
            print(
                "[s:::] The training time of NanoReviser_train is :%.2f seconds"
                % (time.time() - start_time)
            )
        if rank == 0 and os.path.exists(args.temp_dir):
            shutil.rmtree(args.temp_dir)
        return 0
    except Exception as exc:  # noqa: BLE001 — the reference's exit contract
        if args.test_mode and logger:
            logger.error(str(exc))
        else:
            print(exc)
        return 1


if __name__ == "__main__":
    sys.exit(main())
