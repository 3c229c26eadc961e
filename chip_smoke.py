"""Chip smoke for the PyTorch/CUDA port: model-path revision on one GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --gather-only   # phases device, build and gather
    python3 chip_smoke.py --cli-only      # device, build, gather, e2e's CLI runs
    python3 chip_smoke.py --train-only    # device, build, train
    python3 chip_smoke.py --stack-only    # device, build, gather, stack, windows
    python3 chip_smoke.py --crf-only      # device, build, lstm, crf

(``--dp-step`` runs one worker process of phase train's data-parallel
step; the script starts those itself.)

``--gather-only`` times the window gather, ``--cli-only`` the CLI runs of
phase e2e, ``--train-only`` the training path, ``--crf-only`` the LSTM
and CRF decode kernels and the basecaller's main path, and ``--stack-only`` the two
stack kernels (with the sha256 of their outputs), of whatever package sits
beside this file, so a copy of it in an older checkout times that checkout
the same way (fields a package lacks, such as the stack's cluster size,
are read with getattr and reported as for no clusters).

Phases, each printing one JSON line:

1. device  - a CUDA card is required (exit 2 without one); prints
             nvidia-smi's name and power limit.
2. build   - compiles csrc/*.cu with nvcc (one process per source, in
             parallel) and the host library native/src/nanorev.cpp with
             g++ beside them, and reports what ptxas says and the count of
             HGMMA (wgmma) and HMMA (mma.sync) instructions in the stack
             library's SASS (cuobjdump -sass).
3. gather  - packs one full-tier batch (196,608 windows) from synthetic
             reads, decodes it on the card, and holds the window-gather
             kernel bit-exact against its plain version on the card and on
             the CPU; times it per eager call with CUDA events (``ms``,
             wrapper included, against the 0.019 ms target, 50% of the
             kernel's bound) and by replaying a CUDA graph of 100 launches
             (``graph_ms``, the device's time alone), and the plain version
             per eager call.
4. stack   - on the same batch, holds stack_full against the bf16 plain
             chain (argmax agreement >= 0.995, max |dlogit| <= 0.05) and
             against the f32 plain chain with TF32 off (agreement >= 0.99
             over windows whose f32 top-2 margin exceeds 1e-3, atol 0.15);
             times kernel and plain chain (clocks.sm sampled beside the
             window); reports the bound, the cluster size and the clusters
             the card holds, the weight bytes the kernel's schedule takes
             from L2 and those each SM receives, the bytes copied between
             a cluster's shared memories, their rates, the sha256 of the
             logits and probs, and ptxas's registers and spills.
5. windows - the pre-gathered-window path on the same synthetic reads:
             windowed host prep (prep_read_numpy) of reads until there are
             >= 16,384 windows, then on the card device_preprocess_batch,
             the conv branch and stack_logits_multi for both models, plus
             one stack_logits_single launch, from kernel_weights; launch
             counts are zeroed just before and read just after. Holds the
             stack_windows kernel against its bf16 plain version (max
             |dlogit| <= 0.05, argmax agreement >= 0.995) and the f32 model
             with TF32 off (atol 0.15, agreement >= 0.99 over windows whose
             f32 top-2 margin exceeds 1e-3), the single-model launch equal
             to model 1 of the pair, and each read's model-1 labels against
             the main path's (window_gather + stack_full) labels (agreement
             >= 0.98); merges each read and checks the sequences'
             plausibility; times kernel and plain version; reports the
             schedule's bytes and rates as phase stack does, the sha256 of
             the logits and probs and ptxas's registers and spills. Then
             one T = 13 launch (a 1-slot weight ring) on 500 seeded random
             windows against the bf16 plain version (the same bars, and
             its sha256), and its time on as many windows as the T = 11
             run.
6. host    - the host side on the card's host, on the 40 synthetic reads
             of the gather phase and on gzip copies of them (written from
             the same seed: chunked, shuffled, deflated): the usable CPUs,
             /dev/shm's size and free bytes, whether libz loaded; for each
             layout, per-read ms in one process of fast5 decode,
             compact_read_numpy, the host library's compaction, the
             library's one-call ingest (compact_fast5: decode and
             compaction), numpy encode_read, the library's encode and merge
             (random labels from the seed); then a PrepPool at 1 worker and
             at the CLI's worker count (min(8, CPUs)): its start-up seconds
             and its reads/s over the 40 files listed 4 times (no device
             work). Every ingest result must equal
             compact_read(get_read_data(...)), every WireRead (the ingest's
             and the pool's, on both layouts) be byte-identical to
             encode_read(compact_read_numpy(get_read_data(...))) of the
             contiguous file, and no read may fall back from the library to
             the Python path.
7. e2e     - writes 40 synthetic fast5 reads of ~10k bases, random weights
             (the port's init + save_keras_weights), and runs the CLI in model
             mode (prep pool of 8 workers) for fastq and fasta: one output
             file per read, no failed read, exactly one window_gather and
             one stack_full launch per batch (engine device step) and no
             other; prints the pool's start-up seconds beside reads/s, and
             the CLI process's seconds waiting for prepared reads,
             packing them into batches, submitting batches, waiting for
             the device, merging and writing reads.
             Launch counts are zeroed just before and read just after. A few
             reads are also revised with emit="labels" on the card and on
             the CPU (plain f32 path) and must agree. A third CLI run
             (fasta) revises each read 10 times (400 links to the 40 files)
             for a steady-state rate, and a fourth the same over 400 links
             to the gzip copies: its output byte-identical to the third's.
             Last, the CLI as two
             processes on the one card (--num_processes 2, --merged_output,
             --align center): the merged fasta must be byte-identical to a
             one-process --merged_output run's.
8. basecaller - the reviser CLI's --revise_mode basecaller over the 40
             reads in fastq: with a stub basecaller that this script writes,
             every read is rebasecalled and its file must hold the stub's
             fastq trimmed 13/13; without the binary, every read degrades to
             the embedded fastq trimmed 7/7, is listed in -e, and rc is 1.
   lstm    - the LSTM kernel (csrc/lstm_layer.cu) at the basecaller
             engine's batch (1,024 chunks x 800 steps, features 384): ptxas'
             registers and spills, the clusters the card holds at once,
             one layer in both directions against lstm_layer_plain (within
             2^-9, two launches bit-identical), and ms of one layer and of
             the five-layer stack beside the bound, the plain version and
             cuDNN's nn.LSTM (library_ms).
   crf     - the CRF decode kernel (csrc/crf_decode.cu) at the basecaller
             engine's batch (1,024 chunks x 800 steps x 256 states, seeded
             fp16 scores of the encoder's form) against crf_decode_plain on
             the card: labels and the moves' qualities equal, a second launch
             bit-identical; kernel and plain ms by CUDA events and
             the bound (scores' and labels' bytes at the memory rate, the
             decode's float32 operations at the float32 peak). Then the
             main path: --revise_mode basecaller --basecaller_model over
             the 40 reads in fastq (HAC widths, seeded random weights)
             under torch.profiler: every read written, rc 0, one
             crf_decode launch and five lstm_layer launches on the card per
             batch (and per eager warm-up batch before the engine's graph
             capture), the counter basecall.lstm_kernel_layers five a
             batch, and no cuDNN RNN kernel.
9. train   - the training path at the model's full width and the CLI's
             defaults (batch 512, T = 13): 8 synthetic reads of ~10k bases
             and a genome of their bases with ~2% substitutions and short
             indels; ``python -m nanoreviser_torch.cli.train`` on the card
             (2 epochs, both models, 8 labelling threads, 8 steps per
             CUDA-graph replay, its default): rc 0, every
             artifact, finite losses, labels beyond the match class;
             labelling ms per read; one train step on the card against the
             CPU from the trained params and one batch, dropout and TF32
             off, in f64 (every bar per element: loss rtol 1e-5, gradients
             rtol 1e-4 / atol 1e-6, BN batch moments 1e-5, moving
             statistics 1e-6, params within 2*lr and >= 99% within 1e-5)
             and in f32 (the same, the gradient bar on each tensor's
             largest element); data parallel on the one card: one step
             (dropout on, the batch's last fifth of rows pads, all in process 1's
             half) as two processes (``--dp-step`` workers, gloo) against
             one, in f64 per element (rtol 1e-4, atol 1e-6) and in f32 at
             the f32 one-step bars above, then ``cli.train -c 2 -e 1`` (both
             models, batch 512) as two processes against one with identical
             flags, and the one-process run again: equal label caches, each
             artifact written once and by process 0, the epoch's loss within
             1e-3 relative, params within 2*lr per step; val_loss and the
             params' differences reported beside the repeated one-process
             run's (f32 drift), and steps/s of each;
             K steps per dispatch: replays of the 8-step and the 1-step
             CUDA graph (make_multi_step) against eager steps from the
             same params and generator seed, dropout on (one warm-up call
             of 8, two replays of each graph: each step's loss within rtol
             1e-5, accuracy 1e-6, params within 2*lr and >= 99% within
             1e-5, moving statistics 1e-6; bit-identity reported);
             forward, backward and optimizer ms per eager step from CUDA
             events, and for each of eager, the 1-step graph and the
             8-step graph (the graphs timed in turns): steps/s,
             windows/s, the device's busy share (torch.profiler), peak
             memory and capture seconds; the host's batch gather, stack
             and pin per batch alone; one timed epoch of train_model per
             model (steps/s, windows/s), its graph captures and replays
             counted (zeroed just before, read just after: every step
             after the first call's 8 a replay); the torch DP on
             the card against nr_banded_sw on one read (identical ops,
             both times); the exported .h5 loaded into the serving engine,
             stack_full against its bf16 plain version on them (B2's
             bars); and the 8 reads revised through the CLI with them (no
             failed read, one window_gather and one stack_full per batch).

Then the kernel table line, nvidia-smi's line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises and the script exits
non-zero without that line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 20261016
N_READS = 40
READ_BASES = (9000, 11000)
WINDOW = 11
WINDOWS_BATCH = 16384           # the JAX engine's batch on its non-Pallas path
H100_BF16_FLOPS = 989e12        # dense bf16 tensor-core peak (SXM, 700 W)
H100_BYTES_PER_S = 3.35e12      # HBM3
GATHER_TARGET_MS = 0.019        # the full-tier gather at 50% of its bound
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores (SXM, 700 W)
# the basecaller engine's device batch at the HAC widths (models.crf.CrfConfig)
CRF_CHUNKS, CRF_STEPS, CRF_STATE_LEN, CRF_BLANK = 1024, 800, 4, 2.0
# the random weights' gains, as tests/test_torch_crf_decode.py scales its models
CRF_GAINS = {"weight_gain": 3.0, "linear_gain": 8.0, "linear_bias": -1.0}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so that the
    host's rate of calls through the Python wrapper, which bounds
    back-to-back eager calls of a short kernel, does not enter."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class SmClocks:
    """nvidia-smi's clocks.sm (MHz) and power.draw (W), sampled every 50 ms
    by a background nvidia-smi while the block runs; ``during(t0, t1)``
    gives the samples taken in a window of time.time()."""

    def __enter__(self):
        import threading

        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

        def read():
            for ln in self.proc.stdout:
                try:
                    mhz, watts = (float(x) for x in ln.split(",")[:2])
                except ValueError:
                    continue
                self.samples.append((time.time(), mhz, watts))

        self.reader = threading.Thread(target=read, daemon=True)
        self.reader.start()
        t0 = time.time()
        while not self.samples and time.time() - t0 < 15:
            time.sleep(0.02)
        return self

    def during(self, t0: float, t1: float) -> dict:
        """median clocks.sm and power.draw of the samples in [t0, t1] (the
        nearest sample if none fell inside)"""
        inside = [s for s in self.samples if t0 <= s[0] <= t1]
        if not inside and self.samples:
            inside = [min(self.samples, key=lambda s: abs(s[0] - (t0 + t1) / 2))]
        if not inside:
            return {"sm_mhz": None, "power_w": None, "samples": 0}
        mhz = sorted(s[1] for s in inside)
        watts = sorted(s[2] for s in inside)
        return {"sm_mhz": mhz[len(mhz) // 2], "power_w": watts[len(watts) // 2],
                "samples": len(inside)}

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(timeout=5)
        return False


def timed_window(fn, reps: int, clocks: "SmClocks") -> tuple[float, dict]:
    """(ms per call of ``fn`` by CUDA events over ``reps`` calls after one
    warm-up call, the clocks sampled beside that window)"""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.time()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    t1 = time.time()
    return start.elapsed_time(end) / reps, clocks.during(t0, t1)


def make_weights(out_dir: str) -> tuple[str, str]:
    import torch

    from nanoreviser_torch.models import (
        ReviserConfig, init_reviser_params, save_keras_weights)
    from nanoreviser_torch.models.reviser import randomize_inference_stats

    paths = []
    for k, n_cls in enumerate((6, 5)):
        gen = torch.Generator().manual_seed(SEED + k)
        p = init_reviser_params(gen, ReviserConfig(window=WINDOW, n_classes=n_cls))
        p = randomize_inference_stats(p, gen)
        path = os.path.join(out_dir, f"model{k + 1}.h5")
        save_keras_weights(p, path, WINDOW, n_cls)
        paths.append(path)
    return paths[0], paths[1]


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "capability": list(torch.cuda.get_device_capability(0))}
    emit(info)
    return info


def phase_build() -> dict:
    import concurrent.futures as cf

    from nanoreviser_torch.ops import build

    try:
        from nanoreviser_torch.native import build as native_build
    except ImportError:      # a checkout from before the host library
        native_build = None
    t0 = time.time()
    with cf.ThreadPoolExecutor(1) as pool:   # g++ beside the nvcc processes
        host_lib = pool.submit(native_build.build) if native_build else None
        logs = build.build_all()
        if host_lib is not None:
            host_lib.result()
    ptxas = {src: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
             for src, log in logs.items()}
    seconds = round(time.time() - t0, 3)
    from nanoreviser_torch import native

    zlib_available = getattr(native, "zlib_available", None)
    emit({"phase": "build", "seconds": seconds, "nvcc": build.nvcc_path(),
          "ptxas": ptxas, "stack_sass": sass_counts(str(build._lib_path("reviser_stack"))),
          "zlib_loaded": zlib_available() if zlib_available else None})
    return logs


def sass_counts(lib: str) -> dict:
    """The tensor-core instructions of a built library's SASS (cuobjdump
    -sass): HGMMA (wgmma) and HMMA (mma.sync)."""
    import shutil

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([exe, "-sass", lib], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    return {"HGMMA": out.count("HGMMA"), "HMMA": out.count("HMMA")}


def phase_gather(tmp: str, weights):
    import torch

    from nanoreviser_torch.infer import StreamingReviser
    from nanoreviser_torch.infer.wire import decode_wire, encode_read, wire_to_tensors
    from nanoreviser_torch.io import get_read_data
    from nanoreviser_torch.io.synthetic import write_synthetic_dir
    from nanoreviser_torch.ops.window_gather import (
        WINDOW_GATHER, window_gather, window_gather_plain)
    from nanoreviser_torch.signal import compact_read_numpy

    fast5_dir = os.path.join(tmp, "fast5")
    t0 = time.time()
    names = write_synthetic_dir(fast5_dir, N_READS, READ_BASES, seed=SEED)
    write_s = time.time() - t0
    eng = StreamingReviser(*weights, device="cuda")
    wires = [(n, encode_read(compact_read_numpy(get_read_data(
        os.path.join(fast5_dir, n))))) for n in names]
    packed, tier, n_packed = eng.pack_batch(wires)
    check(tier is eng.top, "the gather batch is not a full-tier batch")
    w_valid = int(packed["wvalid"][0])
    rows_valid = int(packed["nv"][0]) * 128

    dec = decode_wire(wire_to_tensors(packed, eng.device), s_cap=tier.s_cap,
                      n_rows=tier.n_rows, n_rows_g=tier.n_rows_g)
    dec_cpu = decode_wire(wire_to_tensors(packed, "cpu"), s_cap=tier.s_cap,
                          n_rows=tier.n_rows, n_rows_g=tier.n_rows_g)
    for field in ("sig", "pos0", "vlen", "read_id", "shift", "scale", "feats"):
        check(torch.equal(getattr(dec, field).cpu(), getattr(dec_cpu, field)),
              f"decode_wire differs between card and CPU in {field}")
    args = (dec.sig, dec.pos0, dec.vlen, dec.read_id, dec.shift, dec.scale,
            rows_valid)
    out = window_gather(*args)
    plain = window_gather_plain(*args)
    plain_cpu = window_gather_plain(dec_cpu.sig, dec_cpu.pos0, dec_cpu.vlen,
                                    dec_cpu.read_id, dec_cpu.shift,
                                    dec_cpu.scale, rows_valid)
    torch.cuda.synchronize()
    check(torch.equal(out, plain), "gather kernel != plain version on the card")
    check(torch.equal(out.cpu(), plain_cpu), "gather kernel != plain on the CPU")
    check(bool(out[:rows_valid].float().abs().sum() > 0), "gather output is all zero")
    max_err = float((out.float() - plain.float()).abs().max())

    ms = cuda_ms(lambda: window_gather(*args), reps=100)
    device_ms = graph_ms(lambda: window_gather(*args), reps=100)
    plain_ms = cuda_ms(lambda: window_gather_plain(*args), reps=20)
    n_rows_g = tier.n_rows_g
    sig_bytes = 2 * int(dec.sig.shape[0])
    bytes_moved = (sig_bytes + 3 * 4 * n_rows_g + 2 * 4 * 256
                   + n_rows_g * out.shape[1] * 2)
    ops = 2 * rows_valid * 50
    bound_ms, bound_by = bound(ops, bytes_moved)
    emit({"phase": "gather", "reads_written": N_READS,
          "write_seconds": round(write_s, 3), "reads_in_batch": n_packed,
          "windows": w_valid, "rows": n_rows_g, "rows_valid": rows_valid,
          "bit_exact_card": True, "bit_exact_cpu": True, "ms": ms,
          "graph_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
          "target_ms": GATHER_TARGET_MS, "meets_target": ms <= GATHER_TARGET_MS})
    row = {"name": "window_gather", "route": "cuda",
           "source": "nanoreviser_torch/csrc/window_gather.cu",
           "replaces": WINDOW_GATHER.replaces, "max_abs_err": max_err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None}
    return eng, dec, out, tier, w_valid, fast5_dir, names, row


def bound(ops: float, nbytes: float):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    operations over the bf16 peak."""
    tb, to = nbytes / H100_BYTES_PER_S, ops / H100_BF16_FLOPS
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def sha256_of(*tensors) -> str:
    """sha256 of the tensors' bytes in turn (on the host)"""
    import hashlib

    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def stack_schedule(rk, kernel: str, t: int, blocks_per_model: int,
                   n_models: int, ms: float, clk: dict) -> dict:
    """The stack kernel's launch by its schedule: the cluster size and the
    clusters the card holds, the CTAs of the padded grid, the weight bytes
    the L2 serves and the SMs receive, the bytes taken from peers' shared
    memory, and their rates over ``ms`` (per SM in bytes per SM clock, at
    the clocks.sm sampled beside the window). A package from before the
    clusters (no stack_cluster_size) counts as cluster 1 on every SM."""
    import torch

    size_fn = getattr(rk, "stack_cluster_size", None)
    c = size_fn() if size_fn else 1
    fetch_fn = (rk.stack_full_fetch_bytes if kernel == "stack_full"
                else rk.stack_windows_fetch_bytes)
    per = fetch_fn(t, c) if size_fn else fetch_fn(t)
    if not isinstance(per, dict):
        per = {"l2": per, "sm": per, "peer": 0}
    ctas = n_models * -(-blocks_per_model // c) * c
    active = rk.stack_active_clusters(kernel, t) if size_fn else None
    sms = (active * c if active
           else torch.cuda.get_device_properties(0).multi_processor_count)
    sec = ms * 1e-3
    l2, sm, peer = (ctas * per[k] for k in ("l2", "sm", "peer"))
    return {"cluster": c, "active_clusters": active, "sms_busy": sms,
            "ctas": ctas, "l2_weight_bytes": l2, "sm_weight_bytes": sm,
            "peer_bytes": peer, "l2_tb_per_s": l2 / sec / 1e12,
            "per_sm_weight_bytes_per_clk": (sm / sms / sec / (clk["sm_mhz"] * 1e6)
                                            if clk.get("sm_mhz") else None),
            "per_sm_peer_bytes_per_clk": (peer / sms / sec / (clk["sm_mhz"] * 1e6)
                                          if clk.get("sm_mhz") else None),
            "clocks": clk}


def _agreement(a, b, margin_ref=None, min_margin=0.0):
    import torch

    same = a.argmax(-1) == b.argmax(-1)
    if margin_ref is None:
        return float(same.float().mean()), 0
    top2 = torch.topk(margin_ref, 2, dim=-1).values
    ok = (top2[..., 0] - top2[..., 1]) > min_margin
    return float(same[ok].float().mean()), int((~ok).sum())


def _f32_weights(weights, t_len: int, device) -> dict:
    """The unrounded f32 stack weights (the engine on the card holds bf16)."""
    import torch

    from nanoreviser_torch.models import load_keras_weights
    from nanoreviser_torch.models.fused import fold_inference_params
    from nanoreviser_torch.ops import reviser_kernel as rk

    per_model = [rk.pack_stack_weights(
        fold_inference_params(load_keras_weights(p)[0]), t_len) for p in weights]
    return rk.weights_to_device(rk.stack_models(per_model), device, torch.float32)


def ptxas_of(log: str, kernel: str) -> list:
    """ptxas's register and spill lines for the entry functions whose
    (mangled) name contains ``kernel``."""
    out, cur = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = ln
        elif kernel in cur and ("registers" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def phase_stack(eng, dec, sig, tier, w_valid, weights, build_logs):
    import torch

    from nanoreviser_torch.ops import reviser_kernel as rk
    from nanoreviser_torch.ops.window_gather import Q, window_gather_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = eng.window
    ws = eng._ws
    n_p = w_valid + t - 1
    n_win = tier.w_max
    feats = dec.feats
    v = slice(0, w_valid)

    def dmax(a, b):
        """max |a - b| over the valid windows and each model's classes"""
        return max(float((a[m, v, :nc] - b[m, v, :nc]).abs().max())
                   for m, nc in enumerate(eng.n_classes))

    logits, probs = rk.stack_logits_full(ws, sig, feats, t_len=t,
                                         w_valid=w_valid, n_windows=n_win,
                                         want_probs=True)
    # the whole plain bf16 chain, for the B2 bars
    lp, pp = rk.stack_logits_plain(ws, sig, feats, t_len=t, w_valid=w_valid,
                                   n_windows=n_win, want_probs=True, bf16=True)
    torch.cuda.synchronize()
    for name, x in (("logits", logits), ("probs", probs)):
        check(bool(torch.isfinite(x).all()), f"{name} has non-finite values")
    check(not logits[:, w_valid:].any() and not probs[:, w_valid:].any(),
          "stack_full wrote windows >= w_valid")
    b2_err = dmax(logits, lp)
    b2_perr = float((probs[:, v] - pp[:, v]).abs().max())
    agree_bf16 = [_agreement(logits[m, v], lp[m, v])[0] for m in range(2)]
    check(b2_err <= 0.05, f"stack_full vs bf16 plain: max |dlogit| {b2_err}")
    check(min(agree_bf16) >= 0.995, f"stack_full vs bf16 plain agreement {agree_bf16}")

    win_f32 = window_gather_plain(dec.sig, dec.pos0, dec.vlen, dec.read_id,
                                  dec.shift, dec.scale, w_valid + t,
                                  out_dtype=torch.float32, width=Q)
    ws32 = _f32_weights(weights, t, sig.device)
    lf, pf = rk.stack_logits_plain(ws32, win_f32, feats, t_len=t,
                                   w_valid=w_valid, n_windows=n_win,
                                   want_probs=True, bf16=False)
    del ws32
    f32_err = dmax(logits, lf)
    agree_f32, near_ties = [], []
    for m in range(2):
        nc = eng.n_classes[m]
        a, ties = _agreement(logits[m, v, :nc], lf[m, v, :nc], lf[m, v, :nc], 1e-3)
        agree_f32.append(a)
        near_ties.append(ties)
    check(min(agree_f32) >= 0.99, f"stack_full vs f32 plain agreement {agree_f32}")
    check(f32_err <= 0.15, f"stack_full vs f32 plain max |dlogit| {f32_err}")
    classes = [torch.bincount(logits[m, v].argmax(-1), minlength=6).tolist()
               for m in range(2)]
    check(sum(c > 0 for c in classes[0]) >= 2, f"model1 labels degenerate {classes[0]}")
    del lf, pf, win_f32

    accuracy = {
        "b2_vs_bf16_plain": {"max_abs_dlogit": b2_err, "max_abs_dprob": b2_perr,
                             "argmax_agreement": agree_bf16},
        "b2_vs_f32_plain": {"max_abs_dlogit": f32_err, "argmax_agreement": agree_f32,
                            "near_ties_margin_1e-3": near_ties}}

    with SmClocks() as clocks:
        ms, clk = timed_window(lambda: rk.stack_logits_full(
            ws, sig, feats, t_len=t, w_valid=w_valid, n_windows=n_win,
            want_probs=True), 10, clocks)
    plain_ms = cuda_ms(lambda: rk.stack_logits_plain(
        ws, sig, feats, t_len=t, w_valid=w_valid, n_windows=n_win,
        want_probs=True, bf16=True), reps=2)

    # the bound: the JAX package's algorithmic count (conv branch and both
    # projections once per row, the rest per window), not this design's
    macs = rk.executed_mac_counts(t)
    ops = 2 * 2 * (n_p * macs["per_base"] + w_valid * macs["per_window"])
    w_bytes = sum(ws[k].numel() * ws[k].element_size() for k in rk.FULL_ORDER)
    nbytes = (n_p * (sig.shape[1] * 2 + 6 * 4) + w_bytes
              + (logits.numel() + probs.numel()) * 4)
    bms, bby = bound(ops, nbytes)
    sched = stack_schedule(rk, "stack_full", t, -(-w_valid // 16), 2, ms, clk)
    emit({"phase": "stack", "windows": w_valid, "rows": n_p, **accuracy,
          "label_counts": classes,
          "launches_per_batch": {"window_gather": 1, "stack_full": 1},
          "stack_full_ms": ms, "stack_full_plain_ms": plain_ms,
          "stack_full_bound_ms": bms, "bound_by": bby, "flop": ops,
          "bytes": nbytes, "schedule": sched,
          "sha256_logits": sha256_of(logits), "sha256_probs": sha256_of(probs),
          "ptxas": ptxas_of(build_logs.get("reviser_stack", ""), "stack_full")})
    return [{"name": "stack_full", "route": "cuda",
             "source": "nanoreviser_torch/csrc/reviser_stack.cu",
             "replaces": rk.STACK_FULL.replaces, "max_abs_err": b2_err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
             "bound_by": bby, "library_ms": None}]


def windows_t13(dev, n_time: int) -> dict:
    """stack_windows at T = 13 (a 1-slot ring): one launch on 500 seeded
    random windows held to the bf16 plain version's bars, then its time on
    n_time windows."""
    import numpy as np
    import torch

    from nanoreviser_torch.models import ReviserConfig, init_reviser_params
    from nanoreviser_torch.models.fused import fold_inference_params
    from nanoreviser_torch.models.reviser import randomize_inference_stats
    from nanoreviser_torch.ops import reviser_kernel as rk

    t = 13
    per_model = []
    for k, n_cls in enumerate((6, 5)):
        gen = torch.Generator().manual_seed(SEED + 13 + k)
        p = randomize_inference_stats(
            init_reviser_params(gen, ReviserConfig(window=t, n_classes=n_cls)), gen)
        per_model.append(rk.pack_stack_weights(fold_inference_params(p), t))
    ws = rk.kernel_weights(rk.stack_models(per_model), dev)
    rng = np.random.default_rng(SEED + 13)

    def inputs(n):
        return (torch.tensor(rng.normal(0.5, 0.3, (n, t, 6)), dtype=torch.float32,
                             device=dev),
                torch.tensor(rng.normal(0, 1, (2, n, t, 64)), dtype=torch.float32,
                             device=dev))

    feats, sig = inputs(500)
    lg, pr = rk.stack_logits_multi(ws, feats, sig, t_len=t, want_probs=True)
    lp, pp = rk.stack_windows_plain(ws, feats, sig, t_len=t, want_probs=True,
                                    bf16=True)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lg).all()), "T=13 logits non-finite")
    err = max(float((lg[m, :, :nc] - lp[m, :, :nc]).abs().max())
              for m, nc in enumerate((6, 5)))
    agree = [_agreement(lg[m], lp[m])[0] for m in range(2)]
    check(err <= 0.05, f"stack_windows T=13 vs bf16 plain: max |dlogit| {err}")
    check(min(agree) >= 0.995, f"stack_windows T=13 vs bf16 plain agreement {agree}")
    check(float(lg[0].std(0).min()) > 1e-3, "T=13 logits do not vary")
    sha = {"sha256_logits": sha256_of(lg), "sha256_probs": sha256_of(pr)}
    feats, sig = inputs(n_time)
    with SmClocks() as clocks:
        ms, clk = timed_window(lambda: rk.stack_logits_multi(
            ws, feats, sig, t_len=t, want_probs=True), 20, clocks)
    return {"windows_checked": 500, "max_abs_dlogit_vs_bf16_plain": err,
            "max_abs_dprob_vs_bf16_plain": float((pr - pp).abs().max()),
            "agreement_vs_bf16_plain": agree, **sha,
            "ring_slots": rk.windows_ring_slots(t),
            "windows_timed": n_time, "ms": ms,
            "schedule": stack_schedule(rk, "stack_windows", t, -(-n_time // 16), 2,
                                       ms, clk)}


def phase_windows(weights, fast5_dir: str, names: list, build_logs):
    import numpy as np
    import torch

    from nanoreviser_torch.infer import StreamingReviser
    from nanoreviser_torch.infer.merge import calibrate_center_offset, merge_revision
    from nanoreviser_torch.io import get_read_data
    from nanoreviser_torch.models import (
        ReviserConfig, load_keras_weights, params_from_numpy)
    from nanoreviser_torch.models.fused import fold_inference_params, signal_branch_apply
    from nanoreviser_torch.ops import reviser_kernel as rk
    from nanoreviser_torch.ops.window_gather import WINDOW_GATHER
    from nanoreviser_torch.signal import device_preprocess_batch, prep_read_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    loaded = [load_keras_weights(p) for p in weights]
    t = loaded[0][1]
    n_classes = [nc for _, _, nc in loaded]
    fused = [fold_inference_params(p) for p, _, _ in loaded]
    fused_t = [params_from_numpy(f, dev) for f in fused]
    ws = rk.kernel_weights(
        rk.stack_models([rk.pack_stack_weights(f, t) for f in fused]), dev)
    cfg = ReviserConfig(window=t)

    t0 = time.time()
    reads, prepped, n_win = [], [], 0
    for n in names:
        rd = get_read_data(os.path.join(fast5_dir, n))
        reads.append((n, rd))
        prepped.append(prep_read_numpy(rd))
        n_win += max(rd.n_bases - t, 0)
        if n_win >= WINDOWS_BATCH:
            break
    check(n_win >= WINDOWS_BATCH, f"only {n_win} windows in {len(reads)} reads")
    prep_s = time.time() - t0
    row0 = np.cumsum([0] + [p.n_bases for p in prepped])
    win0 = np.cumsum([0] + [p.n_bases - t for p in prepped])
    idx = np.concatenate([
        (row0[k] + np.arange(p.n_bases - t))[:, None] + np.arange(t)[None, :]
        for k, p in enumerate(prepped)])
    host = {
        "win": np.concatenate([p.win for p in prepped]),
        "vlen": np.concatenate([p.vlen for p in prepped]),
        "feats": np.concatenate([p.feats for p in prepped]),
        "shift": np.concatenate([np.full(p.n_bases, p.shift, np.float32) for p in prepped]),
        "scale": np.concatenate([np.full(p.n_bases, p.scale, np.float32) for p in prepped]),
        "idx": idx,
    }
    d = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    kernels = (WINDOW_GATHER, rk.STACK_FULL, rk.STACK_WINDOWS)

    # the pre-gathered-window path, once, with the launch counts zeroed
    for k in kernels:
        k.launches = 0
    windows, feats = device_preprocess_batch(d["win"], d["vlen"], d["feats"],
                                             d["shift"], d["scale"])
    featw = feats[d["idx"]]
    sigw = windows[d["idx"]]
    sig_outs = torch.stack([signal_branch_apply(f, sigw, cfg) for f in fused_t])
    del sigw
    logits, probs = rk.stack_logits_multi(ws, featw, sig_outs, t_len=t,
                                          want_probs=True)
    one_l, one_p = rk.stack_logits_single(
        {k: v[0] for k, v in ws.items()}, featw, sig_outs[0], t_len=t,
        want_probs=True)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    check(launches["stack_windows"] == 2, f"windowed path launches {launches}")

    for name, x in (("logits", logits), ("probs", probs), ("sig_outs", sig_outs)):
        check(bool(torch.isfinite(x).all()), f"windows: {name} has non-finite values")
    check(torch.equal(one_l, logits[0]) and torch.equal(one_p, probs[0]),
          "stack_logits_single != model 1 of stack_logits_multi")

    def dmax(a, b):
        return max(float((a[m, :, :nc] - b[m, :, :nc]).abs().max())
                   for m, nc in enumerate(n_classes))

    lp, pp = rk.stack_windows_plain(ws, featw, sig_outs, t_len=t,
                                    want_probs=True, bf16=True)
    err = dmax(logits, lp)
    perr = float((probs - pp).abs().max())
    agree_bf16 = [_agreement(logits[m], lp[m])[0] for m in range(2)]
    check(err <= 0.05, f"stack_windows vs bf16 plain: max |dlogit| {err}")
    check(min(agree_bf16) >= 0.995, f"stack_windows vs bf16 plain agreement {agree_bf16}")
    del lp, pp
    f32_err, agree_f32, near_ties = 0.0, [], []
    for m, nc in enumerate(n_classes):
        lf = rk.stack_logits_reference(fused_t[m], featw, sig_outs[m])
        f32_err = max(f32_err, float((logits[m, :, :nc] - lf).abs().max()))
        a, ties = _agreement(logits[m, :, :nc], lf, lf, 1e-3)
        agree_f32.append(a)
        near_ties.append(ties)
    check(f32_err <= 0.15, f"stack_windows vs f32 model max |dlogit| {f32_err}")
    check(min(agree_f32) >= 0.99, f"stack_windows vs f32 model agreement {agree_f32}")

    # per read: model-1 labels against the main path's, then merge
    y1 = logits[0].argmax(-1).cpu().numpy()
    y2 = logits[1, :, : n_classes[1]].argmax(-1).cpu().numpy()
    main = {n: y for n, _, y, _ in StreamingReviser(
        *weights, device="cuda").revise_stream(reads, emit="labels")}
    per_read, lengths = [], []
    for k, (n, rd) in enumerate(reads):
        a, b = y1[win0[k] : win0[k + 1]], y2[win0[k] : win0[k + 1]]
        per_read.append(float(np.mean(a == main[n])))
        off, _ = calibrate_center_offset(rd.bases, a, t)
        seq = merge_revision(rd.bases, a, b, align="center", window=t,
                             center_offset=off)
        check(set(seq) <= set("ACGTN") and abs(len(seq) - len(rd.bases))
              < 0.2 * len(seq), "windows: revised sequence implausible")
        lengths.append(len(seq))
    check(min(per_read) >= 0.98, f"windows vs main path labels per read {per_read}")

    with SmClocks() as clocks:
        ms, clk = timed_window(lambda: rk.stack_logits_multi(
            ws, featw, sig_outs, t_len=t, want_probs=True), 20, clocks)
    plain_ms = cuda_ms(lambda: rk.stack_windows_plain(
        ws, featw, sig_outs, t_len=t, want_probs=True, bf16=True), reps=2)
    macs = rk.executed_mac_counts(t)["per_window_pregathered"]
    n_models = sig_outs.shape[0]
    ops = 2 * n_models * n_win * macs
    w_bytes = sum(ws[k].numel() * ws[k].element_size() for k in rk.CORE_ORDER)
    nbytes = ((featw.numel() + sig_outs.numel()) * 4 + w_bytes
              + (logits.numel() + probs.numel()) * 4)
    bms, bby = bound(ops, nbytes)
    sched = stack_schedule(rk, "stack_windows", t, -(-n_win // 16), n_models, ms,
                           clk)
    t13 = windows_t13(dev, n_win)
    emit({"phase": "windows", "reads": len(reads), "windows": n_win,
          "prep_seconds": round(prep_s, 3), "launches": launches,
          "max_abs_dlogit_vs_bf16_plain": err, "max_abs_dprob_vs_bf16_plain": perr,
          "agreement_vs_bf16_plain": agree_bf16,
          "vs_f32_model": {"max_abs_dlogit": f32_err, "argmax_agreement": agree_f32,
                           "near_ties_margin_1e-3": near_ties},
          "single_equals_model1": True,
          "labels_vs_main_path_per_read": per_read, "merged_lengths": lengths,
          "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
          "macs_per_window_per_model": macs, "schedule": sched,
          "sha256_logits": sha256_of(logits), "sha256_probs": sha256_of(probs),
          "ring_slots": rk.windows_ring_slots(t),
          "ptxas": ptxas_of(build_logs.get("reviser_stack", ""), "stack_windows"),
          "t13": t13})
    return {"name": "stack_windows", "route": "cuda",
            "source": "nanoreviser_torch/csrc/reviser_stack.cu",
            "replaces": rk.STACK_WINDOWS.replaces, "launches": launches["stack_windows"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": bby, "library_ms": None}


def _wire_identical(a, b) -> bool:
    import dataclasses

    import numpy as np

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
                return False
        elif x != y:
            return False
    return True


def phase_host(tmp: str, fast5_dir: str, names: list) -> str:
    """The host side of the serving path on the card's host, on the
    contiguous files and on gzip copies of them (written here from the same
    seed): per-read stage times in one process, and the prep pool's start-up
    and rate. Returns the copies' directory."""
    import numpy as np

    from nanoreviser_torch import native
    from nanoreviser_torch.infer.hostpipe import PrepPool
    from nanoreviser_torch.infer.merge import merge_revision
    from nanoreviser_torch.infer.wire import encode_read
    from nanoreviser_torch.io import get_read_data
    from nanoreviser_torch.io.synthetic import write_synthetic_dir
    from nanoreviser_torch.signal import host_prep

    gz_dir = os.path.join(tmp, "fast5_gz")
    t0 = time.time()
    check(write_synthetic_dir(gz_dir, N_READS, READ_BASES, seed=SEED,
                              compression="gzip") == names, "gzip copies: names differ")
    gz_write_s = time.time() - t0
    cpus = len(os.sched_getaffinity(0))
    shm = os.statvfs("/dev/shm")
    fb0 = host_prep.native_fallbacks()
    per_read_ms, pools, ref = {}, {}, None
    for layout, src in (("contiguous", fast5_dir), ("gzip", gz_dir)):
        # per-read stage times, one process, each stage on every read in turn
        paths = [os.path.join(src, n) for n in names]
        rng = np.random.default_rng(SEED)
        stages = dict.fromkeys(("decode", "compact_numpy", "compact_native",
                                "ingest_native", "encode_numpy", "encode_native",
                                "merge"), 0.0)
        wires = []
        for p in paths:
            t = time.perf_counter()
            rd = get_read_data(p)
            t1 = time.perf_counter()
            c_np = host_prep.compact_read_numpy(rd)
            t2 = time.perf_counter()
            c = host_prep.compact_read(rd)
            t3 = time.perf_counter()
            ing = host_prep.compact_fast5(p)
            t4 = time.perf_counter()
            w = encode_read(c)
            t5 = time.perf_counter()
            n, m = c.n_bases, c.n_samples
            rows = {"sig8": m, "posd": n, "evf": n, "codes": n, "sig_esc_idx": m,
                    "sig_esc_delta": m, "dur_esc_idx": n, "dur_esc_f32": n}
            out = {k: np.empty((rows.get(k, n), 4) if w else rows.get(k, n), dt)
                   for k, (dt, w) in native.ENCODE_OUT.items()}
            t6 = time.perf_counter()
            native.encode_wire_native(c, out)
            t7 = time.perf_counter()
            y1 = rng.choice(6, n - WINDOW, p=[0.85, 0.03, 0.03, 0.03, 0.03, 0.03])
            y2 = rng.integers(0, 5, n - WINDOW)
            t8 = time.perf_counter()
            merge_revision(rd.bases, y1, y2, align="center", window=WINDOW,
                           center_offset=(WINDOW - 1) // 2)
            t9 = time.perf_counter()
            for k, dt in zip(stages, (t1 - t, t2 - t1, t3 - t2, t4 - t3, t5 - t4,
                                      t7 - t6, t9 - t8)):
                stages[k] += dt
            check(_wire_identical(ing, c), f"{layout}: ingest != compact_read(get_read_data)")
            check(_wire_identical(w, encode_read(c_np)), f"{layout}: native compaction != numpy")
            check(_wire_identical(encode_read(ing), w), f"{layout}: ingest's wire != numpy's")
            wires.append(w)
        per_read_ms[layout] = {k: v * 1e3 / len(paths) for k, v in stages.items()}
        check(host_prep.native_fallbacks() == fb0, f"{layout}: host library refused a read")
        if ref is None:
            ref = wires
        check(all(_wire_identical(a, b) for a, b in zip(wires, ref)),
              f"{layout}: reads differ from the contiguous files'")

        # the pool: start-up, then the 40 files listed 4 times, no device work
        items = names * 4
        pools[layout] = {}
        for n_workers in sorted({1, min(8, cpus)}):
            with PrepPool(n_workers) as pool:
                start_s = pool.ready()
                t0 = time.perf_counter()
                n_items = 0
                for k, (fn, wire, err) in enumerate(pool.stream(src, items)):
                    check(err is None and fn == items[k], f"pool: {fn} failed: {err}")
                    check(_wire_identical(wire, ref[k % len(names)]),
                          f"pool WireRead of {fn} != encode_read(compact_read_numpy)")
                    n_items += 1
                secs = time.perf_counter() - t0
                check(n_items == len(items), f"pool yielded {n_items} of {len(items)}")
                check(pool.native_fallbacks == 0,
                      f"{pool.native_fallbacks} native fallbacks in the pool")
            pools[layout][n_workers] = {"start_seconds": start_s, "seconds": secs,
                                        "reads_per_s": len(items) / secs}
    sizes = {layout: sum(os.path.getsize(os.path.join(src, n)) for n in names)
             for layout, src in (("contiguous", fast5_dir), ("gzip", gz_dir))}
    info = {"phase": "host", "cpus": cpus, "dev_shm_bytes": shm.f_blocks * shm.f_frsize,
            "dev_shm_free_bytes": shm.f_bavail * shm.f_frsize,
            "reads": len(names), "gzip_write_seconds": gz_write_s,
            "file_bytes": sizes, "zlib_loaded": native.zlib_available(),
            "per_read_ms": per_read_ms, "pool_items": 4 * len(names),
            "pool": pools, "native_fallbacks": 0, "wire_identical": True}
    emit(info)
    return gz_dir


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def two_process_merged(tmp: str, weights, fast5_dir: str) -> dict:
    """Two CLI processes on the one card (--num_processes 2, --merged_output,
    --align center); their merged fasta must equal one process's."""
    from nanoreviser_torch.cli.reviser import main as cli_main

    common = ["-d", fast5_dir, "-F", "fasta", "--revise_mode", "model",
              "--device", "cuda", "--align", "center",
              "--model1_predict_dir", weights[0], "--model2_predict_dir", weights[1]]
    one = os.path.join(tmp, "merged_one")
    rc = cli_main(common + ["-o", one, "--merged_output", os.path.join(one, "m.fasta"),
                            "-e", os.path.join(tmp, "failed_one.txt")])
    check(rc == 0, f"one-process merged run returned {rc}")
    two = os.path.join(tmp, "merged_two")
    coord = f"127.0.0.1:{_free_port()}"
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nanoreviser_torch.cli.reviser", *common,
         "-o", two, "--merged_output", os.path.join(two, "m.fasta"),
         "-e", os.path.join(tmp, f"failed_two{k}.txt"), "--thread", "4",
         "--coordinator_address", coord, "--num_processes", "2",
         "--process_id", str(k)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.time() - t0
    for k, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"process {k} returned {p.returncode}:\n{out[-3000:]}")
    a = open(os.path.join(one, "m.fasta"), "rb").read()
    b = open(os.path.join(two, "m.fasta"), "rb").read()
    check(a == b, "two-process merged output != one-process merged output")
    return {"merged_identical": True, "records": a.count(b">"), "seconds": secs}


def phase_e2e(tmp: str, weights, fast5_dir: str, names: list, full: bool = True,
              gz_dir: str | None = None):
    """The CLI runs (with ``gz_dir``, also 400 links to the gzip copies,
    whose output must equal the contiguous 400-link run's); with ``full``,
    also the card-vs-CPU label check and the two-process run. An older
    checkout without the prep pool runs the CLI runs alone."""
    import concurrent.futures as cf
    import multiprocessing.pool as mp_pool

    import numpy as np
    import torch

    import nanoreviser_torch.io as nanoreviser_io
    from nanoreviser_torch import infer
    from nanoreviser_torch.cli.reviser import main as cli_main
    from nanoreviser_torch.infer import StreamingReviser
    from nanoreviser_torch.io import get_read_data
    from nanoreviser_torch.ops.reviser_kernel import STACK_FULL, STACK_WINDOWS
    from nanoreviser_torch.ops.window_gather import WINDOW_GATHER

    kernels = (WINDOW_GATHER, STACK_FULL, STACK_WINDOWS)
    n_bases = sum(get_read_data(os.path.join(fast5_dir, n)).n_bases for n in names)
    # count the engine's device steps (batches) beside the launches, and
    # keep the prep pool's start-up time
    steps, pool_start = [0], [None]
    device_step = StreamingReviser._device_step
    PrepPool = getattr(infer, "PrepPool", None)

    def counted_step(self, *args):
        steps[0] += 1
        return device_step(self, *args)

    StreamingReviser._device_step = counted_step
    if PrepPool is not None:
        ready = PrepPool.ready

        def timed_ready(self, *args):
            pool_start.append(ready(self, *args))
            return pool_start[-1]

        PrepPool.ready = timed_ready
    # where the CLI's process spends its time: waiting for prepared reads
    # (a pool's result, or a thread pool's future in an older checkout),
    # packing reads into batches, submitting a batch, waiting for the
    # device, merging reads, writing them
    spent: dict = {}
    timed = [(mp_pool.ApplyResult, "get", "prep_wait"),
             (cf.Future, "result", "prep_wait"),
             (StreamingReviser, "_add_read", "pack"),
             (StreamingReviser, "_submit", "submit"),
             (StreamingReviser, "_fetch", "device_wait"),
             (StreamingReviser, "_merge_one", "merge"),
             (nanoreviser_io, "write_read_fasta", "write"),
             (nanoreviser_io, "write_read_fastq", "write")]
    originals = [getattr(cls, name) for cls, name, _ in timed]

    def timer(fn, key):
        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t
        return wrapper

    for (cls, name, key), fn in zip(timed, originals):
        setattr(cls, name, timer(fn, key))
    for k in kernels:
        k.launches = 0
    runs = {}
    # steady-state runs: each read 10 times, as links under new names, to
    # the contiguous files and to their gzip copies
    plan = [("fastq", "fastq", fast5_dir, 1), ("fasta", "fasta", fast5_dir, 1)]
    for tag, files in (("fasta_x10", fast5_dir), ("fasta_x10_gzip", gz_dir)):
        if files is None:
            continue
        many = os.path.join(tmp, tag)
        os.makedirs(many)
        for k in range(10):
            for n in names:
                os.symlink(os.path.join(files, n), os.path.join(many, f"x{k}_{n}"))
        plan.append((tag, "fasta", many, 10))
    for tag, fmt, src, copies in plan:
        out_dir = os.path.join(tmp, f"out_{tag}")
        failed_fn = os.path.join(tmp, f"failed_{tag}.txt")
        steps0 = steps[0]
        spent.clear()
        torch.cuda.synchronize()
        t0 = time.time()
        rc = cli_main(["-d", src, "-o", out_dir, "-F", fmt,
                       "--revise_mode", "model", "--device", "cuda",
                       "--model1_predict_dir", weights[0],
                       "--model2_predict_dir", weights[1],
                       "-e", failed_fn, "--thread", "8"])
        secs = time.time() - t0
        check(rc == 0, f"CLI {tag} returned {rc}")
        check(not os.path.exists(failed_fn), f"CLI {tag} recorded failed reads")
        n_reads = copies * len(names)
        outs = sorted(os.listdir(out_dir))
        check(len(outs) == n_reads, f"{tag}: {len(outs)} files for {n_reads} reads")
        for n in sorted(os.listdir(src))[:5]:
            text = open(os.path.join(out_dir, n.split(".")[0] + f"_out.{fmt}")).read()
            lines = text.split("\n")
            check(lines[0] == (">" if fmt == "fasta" else "@") + n, "bad header")
            seq = lines[1].split("+")[0]
            check(set(seq) <= set("ACGTN") and abs(len(seq) - len(
                get_read_data(os.path.join(src, n)).bases)) < 0.2 * len(seq),
                "revised sequence implausible")
            if fmt == "fastq":
                check(len(lines[2]) == len(seq), "quality length != sequence length")
        runs[tag] = {"reads": n_reads, "seconds": secs, "reads_per_s": n_reads / secs,
                     "bases_per_s": copies * n_bases / secs,
                     "pool_start_seconds": pool_start[-1],
                     "batches": steps[0] - steps0,
                     "process_seconds": dict(spent)}
    if gz_dir is not None:
        a, b = (os.path.join(tmp, f"out_{t}") for t in ("fasta_x10", "fasta_x10_gzip"))
        outs = sorted(os.listdir(a))
        check(outs == sorted(os.listdir(b)), "gzip run: output files differ")
        check(all(open(os.path.join(a, n), "rb").read() == open(os.path.join(b, n), "rb").read()
                  for n in outs), "gzip run's output != the contiguous run's")
        runs["fasta_x10_gzip"]["identical_to_fasta_x10"] = True
    launches = {k.name: k.launches for k in kernels}
    StreamingReviser._device_step = device_step
    for (cls, name, _), fn in zip(timed, originals):
        setattr(cls, name, fn)
    if PrepPool is not None:
        PrepPool.ready = ready
    check(steps[0] > 0 and launches == {"window_gather": steps[0],
                                        "stack_full": steps[0],
                                        "stack_windows": 0},
          f"main path launches {launches} for {steps[0]} batches")
    if not full:
        emit({"phase": "e2e", "reads": len(names), "bases": n_bases, "runs": runs,
              "batches": steps[0], "launches": launches, "failed": 0})
        return launches

    # model1 labels on the card (bf16 kernels) vs the CPU engine's plain f32
    # path on three reads, one batch each, all three in flight at once;
    # bf16 rounding flips ~0.5% of windows (measured on the CPU against the
    # bf16 plain version), so the bar is 0.98 for every read
    few = [(n, get_read_data(os.path.join(fast5_dir, n))) for n in names[:3]]
    gpu = StreamingReviser(*weights, device="cuda", batch_windows=12288)
    cpu = StreamingReviser(*weights, device="cpu", batch_windows=12288)
    got = {n: y for n, _, y, _ in gpu.revise_stream(few, emit="labels")}
    want = {n: y for n, _, y, _ in cpu.revise_stream(few, emit="labels")}
    check(gpu.stats["batches"] == len(few), f"label check batches {gpu.stats}")
    per_read = [float(np.mean(got[n] == want[n])) for n, _ in few]
    agree = min(per_read)
    check(agree >= 0.98, f"card vs CPU f32 label agreement per read {per_read}")
    two = two_process_merged(tmp, weights, fast5_dir)
    emit({"phase": "e2e", "reads": len(names), "bases": n_bases,
          "runs": runs, "batches": steps[0], "launches": launches, "failed": 0,
          "labels_card_vs_cpu_f32_agreement": agree, "two_processes": two})
    return launches


TRAIN_READS = 8
TRAIN_WINDOW = 13               # the training CLI's defaults: -w 13 -b 512
TRAIN_BATCH = 512
TRAIN_LR = 1e-3


def write_training_data(tmp: str):
    """8 synthetic reads of ~10k bases and a genome of their bases with ~2%
    substitutions and a short indel every ~400 bases, every other read's
    segment reverse-complemented, so that labels cover more than matches
    and the aligner sees both strands."""
    import numpy as np

    from nanoreviser_torch.align.sam import rev_comp
    from nanoreviser_torch.io import get_read_data
    from nanoreviser_torch.io.synthetic import write_synthetic_dir

    fast5_dir = os.path.join(tmp, "train_fast5")
    names = write_synthetic_dir(fast5_dir, TRAIN_READS, READ_BASES, seed=SEED + 6)
    rng = np.random.default_rng(SEED + 6)
    records = []
    for k, n in enumerate(names):
        seq = list(get_read_data(os.path.join(fast5_dir, n)).bases)
        for i in np.flatnonzero(rng.random(len(seq)) < 0.02):
            seq[i] = "ACGT"[rng.integers(4)]
        for i in sorted(rng.choice(len(seq), len(seq) // 400, replace=False))[::-1]:
            ln = int(rng.integers(1, 4))
            if rng.random() < 0.5:
                del seq[i : i + ln]
            else:
                seq[i:i] = list(rng.choice(list("ACGT"), ln))
        g = "".join(seq)
        records.append(f">chr{k}\n{rev_comp(g) if k % 2 else g}\n")
    genome_fn = os.path.join(tmp, "train_genome.fasta")
    with open(genome_fn, "w") as fp:
        fp.write("".join(records))
    return fast5_dir, names, genome_fn


def _step_parity(p_np: dict, batch_np: dict, n_classes: int, dtype) -> dict:
    """One train step on the card and on the CPU from the same params and
    batch, dropout off, TF32 off; the worst ratio of each difference to its
    bar (a ratio <= 1 passes). Gradients: per element in f64; in f32 on
    each tensor's largest element (``elementwise_f32`` is the per-element
    ratio, reported only), because f32 rounding alone moves near-zero
    elements of the LSTM gradients past the per-element bar."""
    import numpy as np
    import torch

    from nanoreviser_torch.models import ReviserConfig
    from nanoreviser_torch.train.step import (
        BN_KEYS, is_trained, keras_adam, make_train_step, param_leaves, params_to_torch)

    cfg = ReviserConfig(window=TRAIN_WINDOW, n_classes=n_classes, dropout_rate=0.0)
    out = {}
    for dev in ("cpu", "cuda"):
        params = params_to_torch(p_np, dev, dtype)
        opt = keras_adam(params, TRAIN_LR)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        batch = {k: v.to(dtype) if v.is_floating_point() else v.long()
                 for k, v in batch.items()}
        metrics, stats = make_train_step(cfg)(params, opt, batch)
        out[dev] = (float(metrics["loss"]),
                    {p: (l.detach().cpu().double().numpy(),
                         None if l.grad is None else l.grad.cpu().double().numpy())
                     for p, l in param_leaves(params)},
                    {(k, m): stats[k][m].cpu().double().numpy()
                     for k in BN_KEYS for m in ("mean", "var")})
    (lc, pc, sc), (lg, pg, sg) = out["cpu"], out["cuda"]
    r = {"loss": abs(lg - lc) / (1e-5 * abs(lc)), "grads": 0.0, "elementwise_f32": 0.0,
         "bn_batch_stats": 0.0, "moving_stats": 0.0, "params_2lr": 0.0}
    n_el = n_close = 0
    for path, (vc, gc) in pc.items():
        vg, gg = pg[path]
        if not is_trained(path):
            r["moving_stats"] = max(r["moving_stats"], float(
                (np.abs(vg - vc) / (1e-6 + 1e-6 * np.abs(vc))).max()))
            continue
        d = np.abs(gg - gc)
        per_el = float((d / (1e-6 + 1e-4 * np.abs(gc))).max())
        if dtype == torch.float64:
            r["grads"] = max(r["grads"], per_el)
        else:
            r["elementwise_f32"] = max(r["elementwise_f32"], per_el)
            r["grads"] = max(r["grads"], float(d.max()) / (
                1e-6 + 1e-4 * float(np.abs(gc).max())))
        dp = np.abs(vg - vc)
        r["params_2lr"] = max(r["params_2lr"], float(dp.max()) / (2 * TRAIN_LR))
        n_el += dp.size
        n_close += int((dp <= 1e-5).sum())
    for k, vc in sc.items():
        r["bn_batch_stats"] = max(r["bn_batch_stats"], float(
            (np.abs(sg[k] - vc) / (1e-5 + 1e-5 * np.abs(vc))).max()))
    r["params_within_1e-5"] = n_close / n_el
    gated = {k: v for k, v in r.items() if k not in ("elementwise_f32", "params_within_1e-5")}
    r["ok"] = all(v <= 1.0 for v in gated.values()) and r["params_within_1e-5"] >= 0.99
    return r


def _time_steps(p_np: dict, corpus, n_classes: int, n_steps: int = 20) -> dict:
    """Eager steps at batch 512: forward, backward and optimizer ms per
    step from CUDA events over ``n_steps`` steps (after 3 to warm up), the
    steps' wall rate, the peak device memory above what was allocated
    before, the forward alone eagerly and as a CUDA-graph replay, and the
    busy share over 5 steps. Then ``_time_graphs``; ``modes`` puts the
    three side by side: eager, the 1-step graph and the 8-step graph."""
    import torch

    from nanoreviser_torch.models import ReviserConfig, reviser_apply
    from nanoreviser_torch.train.data import BatchIterator
    from nanoreviser_torch.train.loop import _uploader
    from nanoreviser_torch.train.loss import reviser_loss
    from nanoreviser_torch.train.step import (
        default_class_weights, keras_adam, make_train_step, params_to_torch,
        update_moving_stats)

    dev = torch.device("cuda", 0)
    cfg = ReviserConfig(window=TRAIN_WINDOW, n_classes=n_classes)
    step = make_train_step(cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = params_to_torch(p_np, dev)
    opt = keras_adam(params, TRAIN_LR)
    cw = torch.as_tensor(default_class_weights(n_classes), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    y = corpus.y if n_classes == 6 else corpus.y2
    it = BatchIterator(corpus.feats, corpus.signal, y, TRAIN_BATCH, 0.01, SEED,
                       window=TRAIN_WINDOW)
    up = _uploader(dev)
    batches = [up(b) for _, b in zip(range(n_steps + 3), it.epoch())]
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = 0.0
    for k, b in enumerate(batches):
        if k == 3:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        e = ev[k]
        e[0].record()
        opt.zero_grad(set_to_none=True)
        probs, feature, stats = reviser_apply(params, b["signal"], b["feats"], cfg,
                                              train=True, generator=gen)
        loss, _ = reviser_loss(probs, feature, params["centers"], b["y"], cw,
                               sample_weight=b["weight"])
        e[1].record()
        loss.backward()
        e[2].record()
        opt.step()
        update_moving_stats(params, {k2: {m: v.detach() for m, v in s.items()}
                                     for k2, s in stats.items()})
        e[3].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    ms = [[e[i].elapsed_time(e[i + 1]) for i in range(3)] for e in ev[3:]]
    mean = [sum(m[i] for m in ms) / len(ms) for i in range(3)]

    # how much of a step is the host's launching: the forward and loss
    # (no grad, dropout off) per eager call and replayed as one CUDA graph
    b = batches[-1]
    cfg0 = ReviserConfig(window=TRAIN_WINDOW, n_classes=n_classes, dropout_rate=0.0)

    @torch.no_grad()
    def forward():
        probs, feature, _ = reviser_apply(params, b["signal"], b["feats"], cfg0,
                                          train=True)
        return reviser_loss(probs, feature, params["centers"], b["y"], cw,
                            sample_weight=b["weight"])[0]

    eager = {"steps": n_steps, "forward_ms": mean[0], "backward_ms": mean[1],
             "optimizer_ms": mean[2], "step_ms_wall": wall * 1e3 / n_steps,
             "steps_per_s": n_steps / wall, "windows_per_s": n_steps * TRAIN_BATCH / wall,
             "peak_mem_bytes": peak,
             "forward_nograd_eager_ms": cuda_ms(forward, reps=10),
             "forward_nograd_graph_ms": graph_ms(forward, reps=1, replays=10),
             "profiled": _profile_steps(lambda: [step(params, opt, b, gen)
                                                 for b in batches[:5]], 5)}
    del params, opt, batches, b
    torch.cuda.empty_cache()
    graphs = _time_graphs(p_np, corpus, n_classes)
    keys = ("steps_per_s", "windows_per_s", "peak_mem_bytes")
    modes = {}
    for name, row, cap in ((("eager", eager, None),)
                           + tuple((n, r, r["capture_seconds"]) for n, r in graphs.items())):
        prof = row["profiled"]
        # the profiler lengthens the wall clock (twice over for a replay):
        # the device's busy ms per step under it over the unprofiled step
        est = (None if prof["busy_share"] is None else
               prof["device_busy_ms"] / prof["steps"] * row["steps_per_s"] / 1e3)
        modes[name] = dict({k: row[k] for k in keys}, capture_seconds=cap,
                           busy_share=prof["busy_share"], busy_share_unprofiled=est)
    return dict(eager, graphs=graphs, modes=modes)


def _profile_steps(run, n_steps: int) -> dict:
    """Device activity of ``run()``, ``n_steps`` train steps, under
    ``torch.profiler``: the device's busy share of the wall clock (the sum
    of its kernel and copy times; one stream at a time, so they do not
    overlap), and the device events per step. The profiler's own cost
    lengthens the wall clock, so the share is a lower bound of the share
    without it. Not measured (None, with the error) where the profiler
    records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    except Exception as exc:  # noqa: BLE001 — a measurement, reported as missing
        return {"busy_share": None, "error": repr(exc)[:300]}
    if not dev:
        return {"busy_share": None, "error": "no device events recorded"}
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    return {"steps": n_steps, "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "busy_share": busy_us / wall_us, "device_events_per_step": len(dev) / n_steps}


GRAPH_K = 8                     # train_model's default steps_per_dispatch


def _host_stacks(corpus, y, k: int, n: int, seed: int) -> list:
    """The first ``n`` dispatches of an epoch as ``train_model`` makes them
    (``chunked`` stacks of ``k``, pinned)."""
    from nanoreviser_torch.train.data import BatchIterator
    from nanoreviser_torch.train.loop import _host_tensors, chunked

    it = BatchIterator(corpus.feats, corpus.signal, y, TRAIN_BATCH, 0.01, seed,
                       window=TRAIN_WINDOW)
    return [_host_tensors(c, pin=True) for _, c in zip(range(n), (
        stack for _, stack in chunked(it.epoch(), k)))]


def _time_graphs(p_np: dict, corpus, n_classes: int, rounds: int = 2,
                 steps_per_round: int = 48) -> dict:
    """``make_multi_step`` on the card at K = 1 (a 1-step graph replayed
    once per call) and K = 8 (one 8-step graph per call), from the same
    params: per mode its own params and capturable Adam, the warm-up call
    (eager) and the first graphed call (capture and one replay) with the
    capture's seconds and the mode's peak memory above what was allocated
    before it; then timed rounds of ``steps_per_round`` steps from pinned
    stacks, the two modes in turns (1, 8, 8, 1, ...): steps/s and windows/s
    by host clock per round; and the device's busy share over 16 steps
    under the profiler."""
    import torch

    from nanoreviser_torch.models import ReviserConfig
    from nanoreviser_torch.train.step import (
        GRAPHS, keras_adam, make_multi_step, params_to_torch)

    dev = torch.device("cuda", 0)
    cfg = ReviserConfig(window=TRAIN_WINDOW, n_classes=n_classes)
    y = corpus.y if n_classes == 6 else corpus.y2
    modes = {}
    for k in (1, GRAPH_K):
        n_calls = 2 + steps_per_round // k + 16 // k
        stacks = _host_stacks(corpus, y, k, n_calls, SEED + k)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params = params_to_torch(p_np, dev)
        opt = keras_adam(params, TRAIN_LR, capturable=True)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        multi = make_multi_step(cfg, device=dev)
        t0 = time.perf_counter()
        multi(params, opt, stacks[0], gen)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        cap0 = GRAPHS.capture_seconds
        t0 = time.perf_counter()
        out = multi(params, opt, stacks[1], gen)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        check(bool(torch.isfinite(out["loss"]).all()), f"K = {k} graph: loss {out}")
        modes[k] = {"multi": multi, "params": params, "opt": opt, "gen": gen,
                    "stacks": stacks[2:], "k": k, "row": {
                        "k": k, "warm_up_seconds": warm_s,
                        "capture_seconds": GRAPHS.capture_seconds - cap0,
                        "first_graphed_call_seconds": first_s,
                        "peak_mem_bytes": torch.cuda.max_memory_allocated() - base,
                        "rounds_steps_per_s": []}}

    def run(m, stacks):
        for st in stacks:
            m["multi"](m["params"], m["opt"], st, m["gen"])

    order = [1, GRAPH_K, GRAPH_K, 1] * rounds
    for r, k in enumerate(order):
        m = modes[k]
        n = steps_per_round // k
        stacks = m["stacks"][:n]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(m, stacks)
        torch.cuda.synchronize()
        m["row"]["rounds_steps_per_s"].append(steps_per_round / (time.perf_counter() - t0))
    out = {}
    for k, m in modes.items():
        row = m["row"]
        rates = row["rounds_steps_per_s"]
        row["steps_per_s"] = sum(rates) / len(rates)
        row["windows_per_s"] = row["steps_per_s"] * TRAIN_BATCH
        row["profiled"] = _profile_steps(
            lambda m=m: run(m, m["stacks"][-(16 // m["k"]):]), 16)
        out[f"graph_{k}"] = row
    del modes
    torch.cuda.empty_cache()
    return out


def _graph_parity(p_np: dict, corpus, n_classes: int) -> dict:
    """Graph replays against eager steps from the same params and
    generator seed, dropout on, TF32 off, both with capturable Adam: one
    warm-up call of 8 steps (eager), two replays of the 8-step graph and two
    of the 1-step graph, against 26 eager steps. The worst ratio of each
    difference to its bar (the f32 one-step bars: loss rtol 1e-5, accuracy
    1e-6, params within 2*lr and >= 99% within 1e-5 after each call, moving
    statistics 1e-6), and whether every step was bit-identical."""
    import numpy as np
    import torch

    from nanoreviser_torch.models import ReviserConfig
    from nanoreviser_torch.train.step import (
        GRAPHS, is_trained, keras_adam, make_multi_step, make_train_step,
        param_leaves, params_to_torch)

    dev = torch.device("cuda", 0)
    cfg = ReviserConfig(window=TRAIN_WINDOW, n_classes=n_classes)
    y = corpus.y if n_classes == 6 else corpus.y2
    stacks = (_host_stacks(corpus, y, GRAPH_K, 3, SEED + 20)
              + _host_stacks(corpus, y, 1, 2, SEED + 21))
    pe, pg = params_to_torch(p_np, dev), params_to_torch(p_np, dev)
    oe = keras_adam(pe, TRAIN_LR, capturable=True)
    og = keras_adam(pg, TRAIN_LR, capturable=True)
    ge = torch.Generator(device=dev).manual_seed(SEED)
    gg = torch.Generator(device=dev).manual_seed(SEED)
    step, multi = make_train_step(cfg), make_multi_step(cfg, device=dev)
    counts = (GRAPHS.captures, GRAPHS.replays)
    r = {"loss": 0.0, "accuracy": 0.0, "params_2lr": 0.0, "moving_stats": 0.0,
         "params_within_1e-5": 1.0, "bit_identical": True, "steps": 0}
    for stack in stacks:
        got = multi(pg, og, stack, gg)
        want = [step(pe, oe, {k: v[i].to(dev) for k, v in stack.items()}, ge)[0]
                for i in range(len(stack["y"]))]
        for m, tol in (("loss", None), ("accuracy", 1e-6)):
            g = got[m].double().cpu().numpy()
            w = torch.stack([x[m] for x in want]).double().cpu().numpy()
            r["bit_identical"] &= bool(np.array_equal(g, w))
            bar = 1e-5 * np.abs(w) if tol is None else tol
            r[m] = max(r[m], float((np.abs(g - w) / bar).max()))
        n_el = n_close = 0
        for (path, a), (_, b) in zip(param_leaves(pg), param_leaves(pe)):
            a, b = a.detach().double().cpu().numpy(), b.detach().double().cpu().numpy()
            r["bit_identical"] &= bool(np.array_equal(a, b))
            d = np.abs(a - b)
            if not is_trained(path):
                r["moving_stats"] = max(r["moving_stats"], float(
                    (d / (1e-6 + 1e-6 * np.abs(b))).max()))
                continue
            r["params_2lr"] = max(r["params_2lr"], float(d.max()) / (2 * TRAIN_LR))
            n_el += d.size
            n_close += int((d <= 1e-5).sum())
        r["params_within_1e-5"] = min(r["params_within_1e-5"], n_close / n_el)
        r["steps"] += len(stack["y"])
    r["captures"] = GRAPHS.captures - counts[0]
    r["replays"] = GRAPHS.replays - counts[1]
    gated = ("loss", "accuracy", "params_2lr", "moving_stats")
    r["ok"] = (all(r[k] <= 1.0 for k in gated) and r["params_within_1e-5"] >= 0.99
               and (r["captures"], r["replays"]) == (2, 4))
    del multi
    torch.cuda.empty_cache()
    return r


def _host_batch_ms(corpus, n: int = 64) -> dict:
    """The host's batch work per step, alone (no device work): the gather of
    a batch (``BatchIterator``), and the gather with the stacking by 8 and
    the pinning that ``train_model``'s prefetch thread does."""
    from nanoreviser_torch.train.data import BatchIterator
    from nanoreviser_torch.train.loop import _host_tensors, chunked

    def epoch():
        it = BatchIterator(corpus.feats, corpus.signal, corpus.y, TRAIN_BATCH, 0.01,
                           SEED, window=TRAIN_WINDOW)
        return (b for _, b in zip(range(n), it.epoch()))

    t0 = time.perf_counter()
    for _ in epoch():
        pass
    gather = (time.perf_counter() - t0) * 1e3 / n
    t0 = time.perf_counter()
    for _, stack in chunked(epoch(), GRAPH_K):
        _host_tensors(stack, pin=True)
    full = (time.perf_counter() - t0) * 1e3 / n
    return {"batches": n, "gather_ms": gather, "gather_stack_pin_ms": full}


STUB_BASECALLER = """#!{python}
import argparse, os
p = argparse.ArgumentParser()
p.add_argument("--input_path", required=True)
p.add_argument("--save_path", required=True)
p.add_argument("--config", required=True)
a = p.parse_args()
fast5s = [f for f in os.listdir(a.input_path) if f.endswith(".fast5")]
assert len(fast5s) == 1, fast5s
stem = fast5s[0].split(".")[0]
seq = "".join("ACGT"[(ord(c) + i) % 4] for i, c in enumerate(stem * 20))
qual = "".join(chr(33 + (7 * i + ord(c)) % 40) for i, c in enumerate(seq))
with open(os.path.join(a.save_path, "stub.fastq"), "w") as fp:
    fp.write("@stub\\n" + "N" * 13 + seq + "N" * 12 + "\\n+\\n"
             + "!" * 13 + qual + "!" * 12 + "\\n")
"""


def stub_fastq(stem: str) -> tuple[str, str]:
    """What the stub basecaller's fastq holds once trimmed 13/13."""
    seq = "".join("ACGT"[(ord(c) + i) % 4] for i, c in enumerate(stem * 20))
    qual = "".join(chr(33 + (7 * i + ord(c)) % 40) for i, c in enumerate(seq))
    return seq, qual


def phase_basecaller(tmp: str, fast5_dir: str, names: list) -> dict:
    """The reviser CLI's basecaller mode over the 40 reads in fastq: with a
    stub basecaller written here, every read is rebasecalled and its file
    holds the stub's trimmed fastq; without the binary, every read
    degrades to the embedded fastq trimmed 7/7, is listed in -e, and rc is
    1."""
    from nanoreviser_torch.cli.reviser import main as cli_main
    from nanoreviser_torch.io import extract_fastq
    from nanoreviser_torch.io.writers import format_read_fastq

    exe = os.path.join(tmp, "bc_bin", "basecaller")
    os.makedirs(os.path.dirname(exe))
    with open(exe, "w") as fp:
        fp.write(STUB_BASECALLER.replace("{python}", sys.executable))
    os.chmod(exe, 0o755)
    runs = {}
    for tag, path in (("stub", exe), ("no_binary", os.path.join(tmp, "bc_none", "basecaller"))):
        out, failed = os.path.join(tmp, f"bc_out_{tag}"), os.path.join(tmp, f"bc_failed_{tag}.txt")
        t0 = time.time()
        rc = cli_main(["-d", fast5_dir, "-o", out, "-F", "fastq", "--revise_mode", "basecaller",
                       "--basecaller_exe", path, "-t", os.path.join(tmp, f"bc_tmp_{tag}"),
                       "-e", failed, "--thread", "8"])
        secs = time.time() - t0
        check(sorted(os.listdir(out)) == sorted(n.split(".")[0] + "_out.fastq" for n in names),
              f"basecaller {tag}: one file per read")
        for n in names:
            stem = n.split(".")[0]
            want = stub_fastq(stem) if tag == "stub" else extract_fastq(os.path.join(fast5_dir, n))
            got = open(os.path.join(out, stem + "_out.fastq")).read()
            check(got == format_read_fastq(n, *want), f"basecaller {tag}: {n} output")
        if tag == "stub":
            check(rc == 0 and not os.path.exists(failed), f"basecaller with the stub: rc {rc}")
        else:
            listed = sorted(ln.split("\t")[0] for ln in open(failed).read().splitlines())
            check(rc == 1 and listed == sorted(names),
                  f"basecaller without a binary: rc {rc}, {len(listed)} reads in -e")
        runs[tag] = {"rc": rc, "seconds": secs, "reads_per_s": len(names) / secs}
    info = {"phase": "basecaller", "reads": len(names), "runs": runs,
            "stub_output_identical": True, "degraded_output_identical": True}
    emit(info)
    return info


def crf_model_dir(tmp: str) -> str:
    """A Bonito model directory at the published HAC widths
    (``models.crf.CrfConfig``'s defaults) with seeded random weights:
    PyTorch's initialisation, scaled by ``CRF_GAINS`` so that the decode
    emits moves."""
    import torch

    from nanoreviser_torch.models import crf

    torch.manual_seed(SEED)
    m = crf.CrfEncoder(crf.CrfConfig()).eval()
    with torch.no_grad():
        for p in list(m.convs.parameters()) + list(m.rnns.parameters()):
            p.mul_(CRF_GAINS["weight_gain"])
        m.linear.weight.mul_(CRF_GAINS["linear_gain"])
        m.linear.bias.mul_(CRF_GAINS["linear_gain"]).add_(CRF_GAINS["linear_bias"])
    path = os.path.join(tmp, "crf_model")
    crf.save_bonito_model(m, path)
    return path


def lstm_seeded(features: int, seed: int):
    """An nn.LSTM(features, features) on the card in fp16 with PyTorch's
    initialisation from ``seed`` scaled by CRF_GAINS' weight gain."""
    import torch

    torch.manual_seed(seed)
    rnn = torch.nn.LSTM(features, features)
    with torch.no_grad():
        for w in rnn.parameters():
            w.mul_(CRF_GAINS["weight_gain"])
    return rnn.eval().cuda().half()


def phase_lstm(logs: dict) -> dict:
    """The LSTM kernel (csrc/lstm_layer.cu) at the basecaller engine's batch
    (1,024 chunks x 800 steps, features 384): what ptxas reports for it,
    the clusters the card holds at once for each chunks-a-cluster and the
    one taken; one layer in both directions against lstm_layer_plain on the
    card (max and mean |difference|, the share of elements that differ) and
    two launches bit-identical; ms by CUDA events of one layer (its input
    projection included; the projection alone beside it) and of the
    five-layer stack with the encoder's directions, against the bound (the
    LSTMs' FLOPs at the fp16 peak; the bytes of x, W and y are far below),
    the plain version and cuDNN's nn.LSTM (``library_ms``, a yardstick the
    port does not call; the stack as CrfEncoder.lstms runs it, flips
    included)."""
    import torch

    from nanoreviser_torch.models import crf
    from nanoreviser_torch.ops import lstm

    cfg = crf.CrfConfig()
    t_len, n, h = CRF_STEPS, CRF_CHUNKS, cfg.features
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = (torch.rand(t_len, n, h, device="cuda", generator=g) * 2 - 1).half()
    rnns = [lstm_seeded(h, SEED + i) for i in range(cfg.n_layers)]
    packed = [lstm.pack_lstm(r) for r in rnns]
    p = packed[0]
    check(lstm.lstm_route(h, "cuda") == "kernel", "features 384 must take the kernel")
    agree = {}
    for reverse in (False, True):
        got = lstm.lstm_layer(x, p, reverse)
        again = lstm.lstm_layer(x, p, reverse)
        want = lstm.lstm_layer_plain(x, p, reverse)
        torch.cuda.synchronize()
        check(torch.equal(got, again), "lstm_layer: two launches differ")
        diff = (got.float() - want.float()).abs()
        agree["reverse" if reverse else "forward"] = {
            "max_abs": diff.max().item(), "mean_abs": diff.mean().item(),
            "share_differing": (diff > 0).float().mean().item()}
        check(diff.max().item() <= 2 ** -9,
              f"lstm_layer against plain: max |diff| {diff.max().item()}")
        del got, again, want, diff

    def stack_kernel():
        y = x
        for i, q in enumerate(packed):
            y = lstm.lstm_layer(y, q, cfg.reverse(i))
        return y

    def stack_plain():
        y = x
        for i, q in enumerate(packed):
            y = lstm.lstm_layer_plain(y, q, cfg.reverse(i))
        return y

    def stack_cudnn():
        y = x
        with torch.inference_mode():
            for i, r in enumerate(rnns):
                y = r(y.flip(0))[0].flip(0) if cfg.reverse(i) else r(y)[0]
        return y

    x_stem = x.permute(1, 2, 0).contiguous().permute(2, 0, 1)   # the stem's layout
    layer_flops = 2.0 * t_len * n * 4 * h * 2 * h
    layer_bound = layer_flops / H100_BF16_FLOPS * 1e3
    with torch.inference_mode():
        layer = {"ms": cuda_ms(lambda: lstm.lstm_layer(x, p, False), reps=5),
                 "projection_ms": cuda_ms(lambda: lstm.input_projection(x, p), reps=5),
                 "projection_stem_layout_ms": cuda_ms(
                     lambda: lstm.input_projection(x_stem, p), reps=5),
                 "bound_ms": layer_bound, "bound_by": "operations",
                 "plain_ms": cuda_ms(lambda: lstm.lstm_layer_plain(x, p, False),
                                     reps=1, warmup=0),
                 "library_ms": cuda_ms(lambda: rnns[0](x), reps=3)}
        stack = {"ms": cuda_ms(stack_kernel, reps=3),
                 "bound_ms": layer_bound * cfg.n_layers, "bound_by": "operations",
                 "plain_ms": cuda_ms(stack_plain, reps=1, warmup=0),
                 "library_ms": cuda_ms(stack_cudnn, reps=3)}
    ptxas = [ln.strip() for ln in logs.get("lstm_layer", "").splitlines()
             if "lstm_layer_kernel" in ln or "registers" in ln or "spill" in ln]
    info = {"phase": "lstm", "chunks": n, "steps": t_len, "features": h,
            "ptxas": ptxas,
            "active_clusters": {nc: lstm.active_clusters(nc) for nc in lstm.CLUSTER_CHUNKS},
            "cluster_chunks": lstm.cluster_chunks(n), "against_plain": agree,
            "layer": layer, "stack": stack}
    emit(info)
    del x, x_stem
    torch.cuda.empty_cache()
    return {"name": "lstm_layer", "route": "cuda",
            "source": "nanoreviser_torch/csrc/lstm_layer.cu",
            "replaces": lstm.LSTM_LAYER.replaces, "launches": None,
            "max_abs_err": max(a["max_abs"] for a in agree.values()),
            "ms": stack["ms"], "plain_ms": stack["plain_ms"],
            "bound_ms": stack["bound_ms"], "bound_by": "operations",
            "library_ms": stack["library_ms"]}


def phase_crf(tmp: str, fast5_dir: str, names: list) -> dict:
    """The CRF decode kernel (csrc/crf_decode.cu) at the basecaller engine's
    batch: fp16 move scores of 1,024 chunks x 800 steps x 256 states (the
    HAC widths), seeded, of the encoder's form (tanh x 5). Holds the
    kernel's labels and its moves' qualities (the fastq's) equal to
    crf_decode_plain's on the same scores on the card (the counts that
    differ are reported on failure; tests/test_torch_crf_decode.py allows
    0.1 % of labels on its small shapes, since the kernel's exp, log and
    sums round otherwise than torch's and a near-tie could go the other
    way) and a second launch bit-identical to the first; times kernel
    (wrapper included, CUDA events) and plain version; the bound is the
    larger of
    the scores' and outputs' bytes at the memory rate and the decode's
    float32 operations (portbench/crf_yardstick.py's count) at the float32
    peak. Then the main path: the reviser CLI in --revise_mode basecaller
    --basecaller_model (fastq) over the 40 reads, under torch.profiler:
    every read written, no failed read, and one crf_decode launch on the
    card per batch beside the engine's eager warm-up batches before its
    capture (the engine replays CUDA graphs, so launches are counted on the
    device; the wrapper's own count, zeroed just before, is the warm-up
    batches and the capture)."""
    import torch

    from nanoreviser_torch.cli.reviser import main as cli_main
    from nanoreviser_torch.infer.basecall import WARMUP_BATCHES
    from nanoreviser_torch.models import crf
    from nanoreviser_torch.ops import crf_decode as dec
    from nanoreviser_torch.utils import trace

    t_len, n, n_states = CRF_STEPS, CRF_CHUNKS, 4 ** CRF_STATE_LEN
    g = torch.Generator(device="cuda").manual_seed(SEED)
    scores = (torch.tanh(torch.randn(t_len, n, 4 * n_states, device="cuda",
                                     generator=g) * 2 - 0.5) * 5.0).half()
    got = dec.crf_decode(scores, CRF_BLANK, CRF_STATE_LEN, True)
    again = dec.crf_decode(scores, CRF_BLANK, CRF_STATE_LEN, True)
    want = dec.crf_decode_plain(scores, CRF_BLANK, CRF_STATE_LEN, True)
    torch.cuda.synchronize()
    agree = got[0] == want[0]
    moved = agree & (got[0] != 0)
    qdiff = (got[1][moved].int() - want[1][moved].int()).abs()
    share = float(agree.float().mean())
    n_diff = int((~agree).sum())
    q_max = int(qdiff.max()) if qdiff.numel() else 0
    check(torch.equal(again[0], got[0]) and torch.equal(again[1], got[1]),
          "crf_decode: two launches on the same scores differ")
    check(n_diff == 0 and q_max == 0,
          f"crf_decode against plain: {n_diff} labels differ (agreement "
          f"{share:.6f}), the moves' qualities by up to {q_max}")
    ms = cuda_ms(lambda: dec.crf_decode(scores, CRF_BLANK, CRF_STATE_LEN), reps=5)
    plain_ms = cuda_ms(lambda: dec.crf_decode_plain(scores, CRF_BLANK, CRF_STATE_LEN),
                       reps=1, warmup=0)
    nbytes = scores.numel() * 2 + n * t_len        # scores in, labels out
    ops = 12.0 * t_len * n_states * 5 * n
    tb, to = nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOPS
    bound_ms, bound_by = max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")
    del scores, got, again, want, agree, moved
    torch.cuda.empty_cache()

    model_dir = crf_model_dir(tmp)
    out, failed = os.path.join(tmp, "crf_out"), os.path.join(tmp, "crf_failed.txt")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    was = trace.enable(True)
    trace.take()
    dec.CRF_DECODE.launches = 0
    t0 = time.time()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            rc = cli_main(["-d", fast5_dir, "-o", out, "-F", "fastq",
                           "--revise_mode", "basecaller", "--basecaller_model",
                           model_dir, "--device", "cuda", "-e", failed,
                           "--thread", "8"])
            torch.cuda.synchronize()
    finally:
        took = trace.take()
        trace.enable(was)
    secs = time.time() - t0
    wrapper_launches = dec.CRF_DECODE.launches
    batches = took["counters"].get("basecall.batches", 0)
    from torch.autograd import DeviceType

    device_names = [e.name() for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA]
    device_launches = sum("crf_decode" in nm for nm in device_names)
    lstm_launches = sum("lstm_layer_kernel" in nm for nm in device_names)
    cudnn_rnn = sum("rnn" in nm.lower() for nm in device_names)
    check(rc == 0 and not os.path.exists(failed), f"basecaller model mode: rc {rc}")
    check(sorted(os.listdir(out)) == sorted(nm.split(".")[0] + "_out.fastq" for nm in names),
          "basecaller model mode: one file per read")
    check(batches > 0 and device_launches == batches + WARMUP_BATCHES,
          f"crf_decode launched {device_launches} times on the card for {batches} "
          f"batches and {WARMUP_BATCHES} eager warm-up batches")
    n_layers = crf.CrfConfig().n_layers
    check(lstm_launches == n_layers * (batches + WARMUP_BATCHES) and cudnn_rnn == 0
          and took["counters"].get("basecall.lstm_kernel_layers") == n_layers * batches,
          f"lstm_layer launched {lstm_launches} times on the card for {batches} batches "
          f"and {WARMUP_BATCHES} warm-up batches (counter "
          f"{took['counters'].get('basecall.lstm_kernel_layers')}), cuDNN RNN kernels "
          f"{cudnn_rnn}")
    info = {"phase": "crf", "chunks": n, "steps": t_len, "states": n_states,
            "label_agreement": share,
            "labels_differing": n_diff,
            "quality_max_diff": q_max, "quality_differing": int((qdiff > 0).sum()),
            "repeat_identical": True, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "main_path": {"reads": len(names), "seconds": secs, "batches": batches,
                          "device_launches": device_launches,
                          "wrapper_launches": wrapper_launches,
                          "lstm_device_launches": lstm_launches,
                          "lstm_kernel_layers": took["counters"].get(
                              "basecall.lstm_kernel_layers"),
                          "samples": took["counters"].get("basecall.samples", 0),
                          "chunks": took["counters"].get("basecall.chunks", 0)}}
    emit(info)
    row = {"name": "crf_decode", "route": "cuda",
           "source": "nanoreviser_torch/csrc/crf_decode.cu",
           "replaces": dec.CRF_DECODE.replaces, "launches": device_launches,
           "max_abs_err": q_max, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    return row


# runs the training CLI with its artifact writers logging (process, path)
WRITE_LOGGER = """
import os, sys
import nanoreviser_torch.models as models
import nanoreviser_torch.train.loop as loop
import nanoreviser_torch.utils.files as files
rank = sys.argv[sys.argv.index("--process_id") + 1]

def logged(fn, *positions):
    def write(*args, **kwargs):
        with open(os.environ["WRITE_LOG"], "a") as fp:
            for i in positions:
                fp.write(rank + "\\t" + str(args[i]) + "\\n")
        return fn(*args, **kwargs)
    return write

models.save_keras_weights = logged(models.save_keras_weights, 1)
loop.save_params_npz = logged(loop.save_params_npz, 1)
loop.save_checkpoint = logged(loop.save_checkpoint, 0)
files.write_summary_file = logged(files.write_summary_file, 2, 3)
from nanoreviser_torch.cli.train import main
sys.exit(main(sys.argv[1:]))
"""


def _run_all(procs: list, timeout: int) -> list:
    """Each process's output; every process is ended before this returns."""
    try:
        return [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _epoch_seconds(stdout: str) -> list:
    return [float(ln.rsplit("(", 1)[1].rstrip("s)")) for ln in stdout.splitlines()
            if ln.startswith("[p:::] epoch")]


def _dp_step(species: str, mesh, dtype) -> dict:
    """One train step in ``dtype`` on the card, dropout on, batch 512 at
    T = 13, from model1's trained params on the first batch of the corpus
    with its last fifth of rows made pads (all in process 1's half over two
    processes)."""
    import numpy as np
    import torch

    from nanoreviser_torch.dist import local_batch_slice
    from nanoreviser_torch.models import ReviserConfig
    from nanoreviser_torch.train.data import BatchIterator, load_training_corpus
    from nanoreviser_torch.train.loop import load_params_npz
    from nanoreviser_torch.train.step import (
        is_trained, keras_adam, make_train_step, param_leaves, params_to_torch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    corpus = load_training_corpus(os.path.join(species, "training_input"), TRAIN_WINDOW)
    p1 = load_params_npz(os.path.join(species, f"smoke_win{TRAIN_WINDOW}_2ep_model1.npz"))
    batch = next(BatchIterator(corpus.feats, corpus.signal, corpus.y, TRAIN_BATCH, 0.01,
                               SEED, window=TRAIN_WINDOW).epoch())
    batch["weight"][-(TRAIN_BATCH // 5):] = 0.0
    denom = max(float(batch["weight"].sum()), 1.0)
    if mesh is not None:
        batch = local_batch_slice(batch, mesh.rank, mesh.world)
    dev = torch.device("cuda", torch.cuda.current_device())
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}
    batch = {k: v.to(dtype) if v.is_floating_point() else v.long() for k, v in batch.items()}
    params = params_to_torch(p1, dev, dtype)
    opt = keras_adam(params, TRAIN_LR)
    cfg = ReviserConfig(window=TRAIN_WINDOW, n_classes=6)
    metrics, stats = make_train_step(cfg, mesh=mesh)(
        params, opt, batch, torch.Generator(device=dev).manual_seed(SEED),
        denominator=denom if mesh is not None else None)
    out = {"loss": metrics["loss"].cpu().numpy()}
    for key, st in stats.items():
        for m, v in st.items():
            out[f"stats/{key}/{m}"] = v.cpu().numpy()
    for path, leaf in param_leaves(params):
        out["param/" + "/".join(path)] = leaf.detach().cpu().numpy()
        if is_trained(path):
            out["grad/" + "/".join(path)] = leaf.grad.cpu().numpy()
    return out


def dp_step_worker(argv: list) -> int:
    """``chip_smoke.py --dp-step <coordinator> <rank> <species dir> <out.npz>``:
    one of two processes of ``_dp_step`` on the card, in f64 and in f32."""
    import numpy as np
    import torch

    from nanoreviser_torch import dist
    from nanoreviser_torch.parallel import make_mesh

    coord, rank, species, out = argv[0], int(argv[1]), argv[2], argv[3]
    dist.initialize(coord, 2, rank)
    mesh = make_mesh("cuda")
    check(mesh.backend == "gloo", f"two processes on one card chose {mesh.backend}")
    res = {}
    for tag, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        res.update({f"{tag}/{k}": v for k, v in _dp_step(species, mesh, dtype).items()})
    np.savez(out, **res)
    dist.shutdown()
    return 0


def _dp_step_ratios(r0: dict, r1: dict, one: dict, tag: str) -> dict:
    """Worst ratio of each difference (two processes' step against one
    process's) to its bar; a ratio <= 1 passes. f64: every loss, moment,
    gradient and param per element (rtol 1e-4, atol 1e-6). f32: the
    one-step f32 bars (``_step_parity``): loss 1e-5 relative, BN moments
    1e-5, moving statistics 1e-6, each gradient tensor on its largest
    element, params within 2*lr and >= 99% within 1e-5."""
    import numpy as np

    r = {"loss": 0.0, "bn_batch_stats": 0.0, "grads": 0.0, "moving_stats": 0.0,
         "params_2lr": 0.0}
    n_el = n_close = 0
    for key, want in one.items():
        key2 = f"{tag}/{key}"
        check(np.array_equal(r0[key2], r1[key2]), f"dp step {tag}: {key} differs "
              "between the processes")
        d = np.abs(r0[key2] - want)
        if tag == "f64":
            r["grads"] = max(r["grads"], float((d / (1e-6 + 1e-4 * np.abs(want))).max()))
        elif key == "loss":
            r["loss"] = max(r["loss"], float(d.max()) / (1e-5 * abs(float(want))))
        elif key.startswith("stats/"):
            r["bn_batch_stats"] = max(r["bn_batch_stats"], float(
                (d / (1e-5 + 1e-5 * np.abs(want))).max()))
        elif key.startswith("grad/"):
            r["grads"] = max(r["grads"], float(d.max()) / (
                1e-6 + 1e-4 * float(np.abs(want).max())))
        elif "grad/" + key[len("param/"):] in one:
            r["params_2lr"] = max(r["params_2lr"], float(d.max()) / (2 * TRAIN_LR))
            n_el += d.size
            n_close += int((d <= 1e-5).sum())
        else:
            r["moving_stats"] = max(r["moving_stats"], float(
                (d / (1e-6 + 1e-6 * np.abs(want))).max()))
    if tag == "f64":
        return {"per_element": r["grads"]}
    r["params_within_1e-5"] = n_close / n_el
    return r


def _params_diff(a: dict, b: dict) -> dict:
    import numpy as np

    diffs = []

    def walk(x, y):
        for k in x:
            if isinstance(x[k], dict):
                walk(x[k], y[k])
            else:
                diffs.append(np.abs(y[k] - x[k]).ravel())
    walk(a, b)
    d = np.concatenate(diffs)
    return {"max_abs": float(d.max()), "within_1e-5": float((d <= 1e-5).mean()),
            "within_1e-4": float((d <= 1e-4).mean())}


def two_process_training(tmp: str, fast5_dir: str, genome_fn: str, species: str) -> dict:
    """Data-parallel training on the one card: one step as two processes
    against one, in f64 per element and in f32 at ``_step_parity``'s
    one-step f32 bars; then ``cli.train`` as two processes against one,
    identical flags, on 2 reads for 1 epoch, both models, and the
    one-process run repeated (the card's run-to-run spread in f32)."""
    import numpy as np
    import torch

    from nanoreviser_torch.train.data import load_training_corpus
    from nanoreviser_torch.train.loop import load_params_npz

    # 1. one step, dropout on, pad rows all in process 1's half
    coord = f"127.0.0.1:{_free_port()}"
    outs = [os.path.join(tmp, f"dp_step{k}.npz") for k in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--dp-step", coord, str(k),
         species, outs[k]], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for k in range(2)]
    logs = _run_all(procs, 600)
    for k, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"dp step process {k} returned {p.returncode}:\n{log[-3000:]}")
    r0, r1 = (dict(np.load(o)) for o in outs)
    step = {}
    for tag, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        step[tag] = _dp_step_ratios(r0, r1, _dp_step(species, None, dtype), tag)
        gated = {k: v for k, v in step[tag].items() if k != "params_within_1e-5"}
        check(all(v <= 1.0 for v in gated.values())
              and step[tag].get("params_within_1e-5", 1.0) >= 0.99,
              f"dp step {tag}: two processes vs one misses a bar: {step[tag]}")

    # 2. the CLI: one process, the same again, then two on the one card
    flags = ["-d", fast5_dir, "-r", genome_fn, "--model_type", "both", "-c", "2", "-e", "1",
             "-b", str(TRAIN_BATCH), "-w", str(TRAIN_WINDOW), "--thread", "8", "-S", "dp"]

    def dirs(tag):
        return ["-o", os.path.join(tmp, tag, "out"), "-M", os.path.join(tmp, tag, "m"),
                "-t", os.path.join(tmp, tag, "tmp"), "-f", os.path.join(tmp, tag, "failed.txt")]

    secs, stdout = {}, {}
    for tag in ("dp_one", "dp_again"):
        t0 = time.time()
        res = subprocess.run([sys.executable, "-m", "nanoreviser_torch.cli.train", *flags,
                              *dirs(tag)], cwd=ROOT, capture_output=True, text=True,
                             timeout=900)
        secs[tag] = time.time() - t0
        check(res.returncode == 0, f"one-process CLI ({tag}) returned {res.returncode}:\n"
              f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        stdout[tag] = res.stdout
    log = os.path.join(tmp, "dp_writes.log")
    coord = f"127.0.0.1:{_free_port()}"
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WRITE_LOGGER, *flags, *dirs("dp_two"),
         "--coordinator_address", coord, "--num_processes", "2", "--process_id", str(k)],
        cwd=ROOT, env=dict(os.environ, WRITE_LOG=log, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for k in range(2)]
    logs = _run_all(procs, 900)
    secs["dp_two"] = time.time() - t0
    stdout["dp_two"] = logs[0]
    for k, (p, out) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"two-process CLI process {k} returned {p.returncode}:\n"
              f"{out[-3000:]}")
    runs = {tag: os.path.join(tmp, tag) for tag in ("dp_one", "dp_again", "dp_two")}
    for d in runs.values():
        check(not [f for f in os.listdir(d) if f.startswith("failed")], f"failed reads in {d}")
    caches = sorted(os.listdir(os.path.join(runs["dp_one"], "m", "dp", "training_input")))
    check(len(caches) == 2 and caches == sorted(os.listdir(
        os.path.join(runs["dp_two"], "m", "dp", "training_input"))), f"label caches {caches}")
    for c in caches:
        a, b = (np.load(os.path.join(runs[t], "m", "dp", "training_input", c))
                for t in ("dp_one", "dp_two"))
        check(sorted(a.files) == sorted(b.files)
              and all(np.array_equal(a[k], b[k]) for k in a.files), f"label cache {c} differs")
    writes = [ln.split("\t") for ln in open(log).read().splitlines()]
    paths = [w[1] for w in writes]
    check({w[0] for w in writes} == {"0"} and len(paths) == len(set(paths)) == 12,
          f"artifact writes {writes}")
    corpus = load_training_corpus(os.path.join(runs["dp_one"], "m", "dp", "training_input"),
                                  TRAIN_WINDOW)
    n_steps = -(-(corpus.n_windows - int(corpus.n_windows * 0.01)) // TRAIN_BATCH)
    ep = {tag: _epoch_seconds(out) for tag, out in stdout.items()}
    check(all(len(v) == 2 for v in ep.values()), f"epoch lines {ep}")
    models = {}
    for i, tag in enumerate(("model1", "model2")):
        stem = f"dp_win{TRAIN_WINDOW}_1ep_{tag}"
        two_dir = runs["dp_two"]
        for path in (os.path.join(two_dir, "m", "dp", f"{stem}.npz"),
                     os.path.join(two_dir, "m", "dp", f"{stem}.h5"),
                     os.path.join(two_dir, "m", "dp", "training_model", f"train_{stem}.npz"),
                     os.path.join(two_dir, "m", "dp", "training_model", f"{tag}_checkpoint.pt"),
                     os.path.join(two_dir, "out", f"{stem}_hisroty.csv"),
                     os.path.join(two_dir, "out", f"{stem}_parameters.json")):
            check(path in paths and os.path.getsize(path) > 0, f"artifact {path}")
        hist = {t: [float(v) for v in open(os.path.join(d, "out", f"{stem}_hisroty.csv"))
                    .read().split()[1].split(",")] for t, d in runs.items()}
        params = {t: load_params_npz(os.path.join(d, "m", "dp", f"{stem}.npz"))
                  for t, d in runs.items()}
        a, b = hist["dp_one"][0], hist["dp_two"][0]
        check(abs(b - a) <= 1e-3 * abs(a), f"{tag} loss: two processes {b}, one {a}")
        diff = {t: _params_diff(params["dp_one"], params[t]) for t in ("dp_again", "dp_two")}
        check(diff["dp_two"]["max_abs"] <= 2 * TRAIN_LR * n_steps,
              f"{tag}: params differ by {diff['dp_two']} after {n_steps} steps")
        models[tag] = {
            "loss": {t: h[0] for t, h in hist.items()},
            "val_loss": {t: h[2] for t, h in hist.items()},
            "params_vs_one": diff,
            "steps_per_s": {t: n_steps / v[i] for t, v in ep.items()}}
    return {"step": step, "windows": int(corpus.n_windows), "steps_per_epoch": n_steps,
            "cli_seconds": secs, "epoch_seconds": ep, "artifact_writes": len(paths),
            "models": models}


def phase_train(tmp: str) -> dict:
    """The training path on the card: labelling, the training CLI, one step
    held against the CPU, speed, the torch DP against the host library, and
    the trained weights through the serving kernels."""
    import numpy as np
    import torch

    from nanoreviser_torch.align import sw
    from nanoreviser_torch.align.sam import rev_comp
    from nanoreviser_torch.cli.reviser import main as reviser_main
    from nanoreviser_torch.infer import StreamingReviser
    from nanoreviser_torch.infer.wire import decode_wire, encode_read, wire_to_tensors
    from nanoreviser_torch.io import get_read_data, parse_fasta
    from nanoreviser_torch.ops import reviser_kernel as rk
    from nanoreviser_torch.ops.window_gather import WINDOW_GATHER, window_gather
    from nanoreviser_torch.signal import compact_read_numpy
    from nanoreviser_torch.train.data import (
        BatchIterator, label_read, load_training_corpus)
    from nanoreviser_torch.train.loop import load_params_npz, train_model
    from nanoreviser_torch.train.step import GRAPHS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    fast5_dir, names, genome_fn = write_training_data(tmp)
    data_s = time.time() - t0

    # 1. the training CLI, as a user runs it
    out, root, work = (os.path.join(tmp, d) for d in ("train_out", "train_model", "train_tmp"))
    failed_fn = os.path.join(tmp, "train_failed.txt")
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "nanoreviser_torch.cli.train", "-d", fast5_dir,
         "-r", genome_fn, "--model_type", "both", "-e", "2", "-b", str(TRAIN_BATCH),
         "-w", str(TRAIN_WINDOW), "--thread", "8", "-o", out, "-M", root, "-t", work,
         "-S", "smoke", "-f", failed_fn],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    cli_s = time.time() - t0
    check(res.returncode == 0, f"training CLI returned {res.returncode}:\n"
          f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    check(not os.path.exists(failed_fn), "training CLI recorded failed reads")
    species = os.path.join(root, "smoke")
    inputs = sorted(os.listdir(os.path.join(species, "training_input")))
    check(inputs == [n.split(".")[0] + ".npz" for n in names],
          f"label caches {inputs}")
    history, weights = {}, {}
    for tag in ("model1", "model2"):
        stem = f"smoke_win{TRAIN_WINDOW}_2ep_{tag}"
        for path in (os.path.join(species, stem + ".h5"),
                     os.path.join(species, stem + ".npz"),
                     os.path.join(species, "training_model", f"train_{stem}.npz"),
                     os.path.join(out, stem + "_hisroty.csv"),
                     os.path.join(out, stem + "_parameters.json")):
            check(os.path.getsize(path) > 0, f"missing artifact {path}")
        rows = open(os.path.join(out, stem + "_hisroty.csv")).read().split()
        check(rows[0] == "loss,accuracy,val_loss,val_accuracy" and len(rows) == 3,
              f"{tag} history {rows}")
        vals = [[float(v) for v in r.split(",")] for r in rows[1:]]
        check(all(math.isfinite(v) for r in vals for v in r), f"{tag} history {vals}")
        history[tag] = dict(zip(rows[0].split(","), zip(*vals)))
        weights[tag] = os.path.join(species, stem + ".h5")
    epoch_s = [float(ln.rsplit("(", 1)[1].rstrip("s)")) for ln in res.stdout.splitlines()
               if ln.startswith("[p:::] epoch")]

    # data parallel: two processes on the one card against one
    dp = two_process_training(tmp, fast5_dir, genome_fn, species)

    # labels beyond the match class
    mapvals = np.concatenate([np.load(os.path.join(species, "training_input", f))["mapvals"]
                              for f in inputs])
    label_mix = {c: int((mapvals == c).sum()) for c in "MXID"}
    check(label_mix["X"] > 0 and label_mix["D"] + label_mix["I"] > 0,
          f"labels are matches only {label_mix}")

    # labelling ms per read, one thread, in this process
    genome = parse_fasta(genome_fn)
    index = sw.KmerIndex(genome)
    t0 = time.perf_counter()
    for n in names:
        label_read(os.path.join(fast5_dir, n), genome, kmer_index=index)
    label_ms = (time.perf_counter() - t0) * 1e3 / len(names)

    # 2. one step on the card against the CPU, from model1's trained params
    corpus = load_training_corpus(os.path.join(species, "training_input"), TRAIN_WINDOW)
    p1 = load_params_npz(os.path.join(species, f"smoke_win{TRAIN_WINDOW}_2ep_model1.npz"))
    b = next(BatchIterator(corpus.feats, corpus.signal, corpus.y, TRAIN_BATCH, 0.01,
                           SEED, window=TRAIN_WINDOW).epoch())
    parity = {str(dt).split(".")[1]: _step_parity(p1, b, 6, dt)
              for dt in (torch.float64, torch.float32)}
    for dt, r in parity.items():
        check(r["ok"], f"train step card vs CPU ({dt}) misses a bar: {r}")
    graph_parity = _graph_parity(p1, corpus, 6)
    check(graph_parity["ok"], f"graph replays vs eager steps miss a bar: {graph_parity}")

    # 3. speed: per-step phases by mode, the host's batch work, and one
    # epoch of train_model per model (through graphs: counts zeroed just
    # before it and read just after)
    speed = {"host_batch": _host_batch_ms(corpus)}
    for tag, nc in (("model1", 6), ("model2", 5)):
        p = load_params_npz(os.path.join(species, f"smoke_win{TRAIN_WINDOW}_2ep_{tag}.npz"))
        steps = _time_steps(p, corpus, nc)
        y = corpus.y if nc == 6 else corpus.y2
        torch.cuda.synchronize()
        GRAPHS.reset()
        t0 = time.perf_counter()
        _, h = train_model(corpus.feats, corpus.signal, y, n_classes=nc,
                           window=TRAIN_WINDOW, epochs=1, batch_size=TRAIN_BATCH,
                           verbose=False, device="cuda")
        secs = time.perf_counter() - t0
        graphs = dict(vars(GRAPHS))
        n_steps = -(-(len(y) - int(len(y) * 0.01)) // TRAIN_BATCH)
        check(math.isfinite(h["loss"][0]), f"{tag} epoch loss {h}")
        # the first call (8 steps) is the eager warm-up; every later step
        # is a replay, of the 8-step graph or, for the steps left over, the
        # 1-step graph
        want = (n_steps - GRAPH_K, n_steps // GRAPH_K - 1 + n_steps % GRAPH_K,
                1 + (n_steps % GRAPH_K > 0))
        check(n_steps > 2 * GRAPH_K and (graphs["replayed_steps"], graphs["replays"],
                                         graphs["captures"]) == want,
              f"{tag} epoch of {n_steps} steps: graphs {graphs}, want {want}")
        speed[tag] = dict(steps, epoch_seconds=secs, epoch_steps=n_steps,
                          epoch_steps_per_s=n_steps / secs,
                          epoch_windows_per_s=n_steps * TRAIN_BATCH / secs,
                          epoch_graphs=graphs)

    # 4. the torch DP on the card against the host library, on read 0
    read = get_read_data(os.path.join(fast5_dir, names[0])).bases
    hit = index.seed(sw.encode_seq(read))
    check(hit is not None, "read 0 did not seed")
    q = read if hit.strand == "+" else rev_comp(read)
    lead, tail = ((hit.margin_lead, hit.margin_tail) if hit.strand == "+"
                  else (hit.margin_tail, hit.margin_lead))
    target = genome[hit.chrom][hit.t_start : hit.t_end]
    sw.align_banded(q[:300], target[:700], t_lead=lead, backend="torch",
                    device="cuda")                                   # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dp_card = sw.align_banded(q, target, t_lead=lead, t_tail=tail, backend="torch",
                              device="cuda")
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp_host = sw.align_banded(q, target, t_lead=lead, t_tail=tail, backend="native")
    host_s = time.perf_counter() - t0
    check(np.array_equal(dp_card[0], dp_host[0]) and dp_card[1:] == dp_host[1:],
          f"torch DP on the card != nr_banded_sw {dp_card[1:]} {dp_host[1:]}")

    # 5. the trained weights through the serving kernels
    eng = StreamingReviser(weights["model1"], weights["model2"], device="cuda")
    check(eng.window == TRAIN_WINDOW, f"engine window {eng.window}")
    wires = [(n, encode_read(compact_read_numpy(get_read_data(os.path.join(fast5_dir, n)))))
             for n in names]
    packed, tier, n_packed = eng.pack_batch(wires)
    check(n_packed == len(names), f"packed {n_packed} of {len(names)} reads")
    w_valid = int(packed["wvalid"][0])
    dec = decode_wire(wire_to_tensors(packed, eng.device), s_cap=tier.s_cap,
                      n_rows=tier.n_rows, n_rows_g=tier.n_rows_g)
    sig = window_gather(dec.sig, dec.pos0, dec.vlen, dec.read_id, dec.shift,
                        dec.scale, int(packed["nv"][0]) * 128)
    kw = dict(t_len=eng.window, w_valid=w_valid, n_windows=tier.w_max, want_probs=True)
    logits, _ = rk.stack_logits_full(eng._ws, sig, dec.feats, **kw)
    lp, _ = rk.stack_logits_plain(eng._ws, sig, dec.feats, bf16=True, **kw)
    torch.cuda.synchronize()
    v = slice(0, w_valid)
    b2_err = max(float((logits[m, v, :nc] - lp[m, v, :nc]).abs().max())
                 for m, nc in enumerate(eng.n_classes))
    agree = [_agreement(logits[m, v, :nc], lp[m, v, :nc])[0]
             for m, nc in enumerate(eng.n_classes)]
    check(bool(torch.isfinite(logits).all()), "trained weights: non-finite logits")
    check(b2_err <= 0.05, f"stack_full on trained weights: max |dlogit| {b2_err}")
    check(min(agree) >= 0.995, f"stack_full on trained weights: agreement {agree}")
    del eng, dec, sig, logits, lp
    torch.cuda.empty_cache()

    # 6. the training reads revised through the CLI with the trained weights
    kernels = (WINDOW_GATHER, rk.STACK_FULL, rk.STACK_WINDOWS)
    for k in kernels:
        k.launches = 0
    rev_out = os.path.join(tmp, "train_revised")
    rev_failed = os.path.join(tmp, "train_revised_failed.txt")
    t0 = time.time()
    rc = reviser_main(["-d", fast5_dir, "-o", rev_out, "-F", "fasta",
                       "--revise_mode", "model", "--device", "cuda",
                       "--model1_predict_dir", weights["model1"],
                       "--model2_predict_dir", weights["model2"],
                       "-e", rev_failed, "--thread", "8"])
    rev_s = time.time() - t0
    launches = {k.name: k.launches for k in kernels}
    check(rc == 0 and not os.path.exists(rev_failed), f"revision of training reads rc {rc}")
    check(len(os.listdir(rev_out)) == len(names), "revision: one file per read")
    check(launches["window_gather"] == launches["stack_full"] > 0
          and launches["stack_windows"] == 0, f"revision launches {launches}")

    info = {"phase": "train", "reads": len(names), "data_seconds": round(data_s, 3),
            "windows": int(corpus.n_windows), "label_mix": label_mix,
            "label_ms_per_read": label_ms, "cli_seconds": cli_s,
            "cli_epoch_seconds": epoch_s, "history": history,
            "step_parity_card_vs_cpu": parity, "graph_vs_eager": graph_parity,
            "speed_batch512_t13": speed,
            "dp_read_bases": len(q), "dp_card_seconds": card_s,
            "dp_native_seconds": host_s, "dp_identical": True,
            "trained_stack_full": {"windows": w_valid, "max_abs_dlogit_vs_bf16_plain": b2_err,
                                   "argmax_agreement": agree},
            "revision": {"reads": len(names), "seconds": rev_s, "launches": launches,
                         "failed": 0},
            "two_processes": dp,
            "nvidia_smi": nvidia_smi_line()}
    emit(info)
    return info


def main(argv: list) -> int:
    import torch

    import nanoreviser_torch  # noqa: F401 — fail before any output without it

    if argv[:1] == ["--dp-step"]:
        return dp_step_worker(argv[1:])
    only = argv[0] if argv else None
    check(argv in ([], ["--gather-only"], ["--cli-only"], ["--train-only"],
                   ["--stack-only"], ["--crf-only"]),
          f"unknown arguments {argv}")
    info = phase_device()
    logs = phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        if only == "--train-only":
            phase_train(tmp)
            print(nvidia_smi_line(), flush=True)
            return 0
        if only == "--crf-only":
            from nanoreviser_torch.io.synthetic import write_synthetic_dir

            fast5_dir = os.path.join(tmp, "fast5")
            names = write_synthetic_dir(fast5_dir, N_READS, READ_BASES, seed=SEED)
            lrow = phase_lstm(logs)
            crow = phase_crf(tmp, fast5_dir, names)
            emit({"kernels": [crow, lrow]})
            print(nvidia_smi_line(), flush=True)
            return 0
        weights = make_weights(tmp)
        eng, dec, sig, tier, w_valid, fast5_dir, names, grow = phase_gather(tmp, weights)
        if only == "--cli-only":
            del eng, dec, sig
            torch.cuda.empty_cache()
            phase_e2e(tmp, weights, fast5_dir, names, full=False)
        if only not in (None, "--stack-only"):
            print(nvidia_smi_line(), flush=True)
            return 0
        srows = phase_stack(eng, dec, sig, tier, w_valid, weights, logs)
        del eng, dec, sig
        torch.cuda.empty_cache()
        wrow = phase_windows(weights, fast5_dir, names, logs)
        torch.cuda.empty_cache()
        if only == "--stack-only":
            print(nvidia_smi_line(), flush=True)
            return 0
        gz_dir = phase_host(tmp, fast5_dir, names)
        launches = phase_e2e(tmp, weights, fast5_dir, names, gz_dir=gz_dir)
        torch.cuda.empty_cache()
        phase_basecaller(tmp, fast5_dir, names)
        torch.cuda.empty_cache()
        lrow = phase_lstm(logs)
        crow = phase_crf(tmp, fast5_dir, names)
        torch.cuda.empty_cache()
        phase_train(tmp)
    rows = [grow] + srows
    for r in rows:
        r["launches"] = launches[r["name"]]
    rows += [wrow, crow, lrow]
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: r[k] for k in order} for r in rows]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
