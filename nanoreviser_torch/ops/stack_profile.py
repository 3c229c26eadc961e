"""Where the time of a ``stack_full`` launch goes, phase by phase, on the card.

A measurement, not a kernel of the port: it copies ``csrc/reviser_stack.cu``
with ``clock64()`` marks added (thread 0 of every block records the start,
the end of staging and the conv branch, of each Bi-LSTM layer and of the
heads, and in the split layers the cycles of each step's copy of the
peer's rows and of its products), builds that copy with nvcc, launches it on
a full-tier batch at T = 11 from seeded random weights, and prints the mean
microseconds per block of each phase at the SM clock that nvidia-smi
reports, and each split layer's weight stream in bytes per SM clock (the
ring's fills of the layer over its time). Two variants test what bounds
the split layers: ``NO_MMA`` replaces each ``mma.sync`` by four dependent
f32 adds, ``NO_STREAM`` stops the weight streams after their first fills
(layer 1's ring and the producer's, whose later fills complete at once
with the tiles already there). Their results are wrong by design; only
their times count.

    python -m nanoreviser_torch.ops.stack_profile [--windows N]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys

from . import build

# (phase, first mark, last mark); marks 8 and 9 accumulate the split layers'
# copy and product cycles per block, 11-14 the products' parts
PHASES = (("stage+conv", 0, 1), ("layer 1", 1, 10), ("layer 1 cluster barrier", 10, 2),
          ("layer 2", 2, 3), ("layer 3", 3, 4), ("layer 4", 4, 5),
          ("heads", 5, 6), ("total", 0, 6))
VARIANTS = ("", "NO_MMA", "NO_STREAM")
N_MARKS = 16
PARTS = ((8, "copies of the peer's rows"), (9, "products and gates"),
         (11, "x chains and biases"), (12, "s chains"), (13, "h chains"),
         (14, "gates and stores"))

_PROLOGUE = """__device__ long long* g_prof = nullptr;
extern "C" int nr_set_prof(long long* p) {
  return (int)cudaMemcpyToSymbol(g_prof, &p, sizeof(p));
}
#define PROF_AT(k) g_prof[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 16 + (k)]
#define PROF_MARK(k) do { if (threadIdx.x == 0 && g_prof) PROF_AT(k) = clock64(); } while (0)
#define PROF_ADD(k, v) do { if (threadIdx.x == 0 && g_prof) PROF_AT(k) += (v); } while (0)
"""

_NO_MMA = """#ifdef NO_MMA
  d[0] += __uint_as_float(b0 & 0x3f000000u); d[1] += __uint_as_float(a[1] & 0x3f000000u);
  d[2] += __uint_as_float(b1 & 0x3f000000u); d[3] += __uint_as_float(a[3] & 0x3f000000u);
  return;
#endif
"""

# (anchor, text put before it, text put after it); each anchor occurs once
# in csrc/reviser_stack.cu
_PATCHES = (
    ("namespace {\n\ntypedef __nv_bfloat16 bf16;\n", _PROLOGUE, ""),
    ('  asm volatile(\n      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "',
     _NO_MMA, ""),
    ("  __device__ __forceinline__ void request() {\n", "",
     "#ifdef NO_STREAM\n    if (requested >= S - 1) total = 0;\n#endif\n"),
    ("      if (k > 0) mbar_wait(bars + 8 * (S + s), (k - 1) & 1);\n", "",
     "#ifdef NO_STREAM\n      if (k > 0) {\n        mbar_arrive(full);\n        ++n;\n"
     "        return;\n      }\n#endif\n"),
    ("    const int tp = st == 0 ? t : (dir ? t + 1 : t - 1);\n    for (int e = tid;",
     "    const long long c0 = clock64();\n", ""),
    ("      reinterpret_cast<uint4*>(P + r * LDP)[q] = *src;\n    }\n    consumer_sync();\n",
     "", "    const long long c1 = clock64();\n    PROF_ADD(8, c1 - c0);\n"),
    ("          put_bf16x2(out_peer + o + 8 * out_ld, hv[2], hv[3]);\n"
     "        }\n      }\n    }\n    consumer_sync();\n", "",
     "    PROF_ADD(9, clock64() - c1);\n"),
    ("  lstm_layer<kH1, 1, 0, 1, 2 * S>(\n", "  PROF_MARK(1);\n", ""),
    ("  fence_proxy_async();   // layer 1's copies and reads before the bulk fills\n",
     "  PROF_MARK(10);\n", ""),
    ("  layer1_done_arrive();\n  cluster_sync();\n", "", "  PROF_MARK(2);\n"),
    ("PM, w.b2, T, ring, dir);\n", "", "  PROF_MARK(3);\n"),
    ("PM, w.b3, T, ring, dir);\n", "", "  PROF_MARK(4);\n"),
    ("PM, w.b4, T, ring, dir);\n", "", "  PROF_MARK(5);\n"),
    ("  logits_out(FE, w.fow, w.fob, m, w0, w_valid, n_windows, logits, probs);\n",
     "", "  PROF_MARK(6);\n"),
    ("  const FullWeights& w = wp.m[m];\n  const int w0 = blockIdx.x * kG;\n", "",
     "  PROF_MARK(0);\n  if (threadIdx.x == 0 && g_prof)\n"
     "    PROF_AT(8) = PROF_AT(9) = PROF_AT(11) = PROF_AT(12) = PROF_AT(13) = PROF_AT(14) = 0;\n"),
    ("      zero_acc(acc);\n      gate_chain<KX>(xa, pa, false, ring, acc);\n",
     "      const long long q0 = clock64();\n", ""),
    ("      if constexpr (KS > 0) {\n        zero_acc(part);\n",
     "      const long long q1 = clock64();\n      PROF_ADD(11, q1 - q0);\n", ""),
    ("      zero_acc(part);\n      gate_chain<KH>(ha, ma, st == 0, ring, part);\n",
     "      const long long q2 = clock64();\n      PROF_ADD(12, q2 - q1);\n",
     "      const long long q3 = clock64();\n      PROF_ADD(13, q3 - q2);\n"),
    ("          put_bf16x2(out_peer + o + 8 * out_ld, hv[2], hv[3]);\n        }\n      }\n",
     "", "      PROF_ADD(14, clock64() - q3);\n"),
)


def instrumented_source(text: str) -> str:
    """reviser_stack.cu with the profile's marks; raises if an anchor is
    missing or not unique (the kernel changed under the profile)."""
    for anchor, before, after in _PATCHES:
        if text.count(anchor) != 1:
            raise ValueError(f"stack_profile: anchor not found once: {anchor[:60]!r}")
        text = text.replace(anchor, before + anchor + after)
    return text


def _sm_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.split()[0])


def _build(variants) -> dict:
    src = build.BUILD_DIR / "reviser_stack_profile.cu"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(instrumented_source((build.CSRC / "reviser_stack.cu").read_text()))
    procs = {}
    for v in variants:
        lib = build.BUILD_DIR / f"libreviser_stack_profile{v}.so"
        procs[v] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *([f"-D{v}"] if v else []),
             "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise build.KernelBuildError(f"nvcc failed for the profile ({v}):\n{log}")
        libs[v] = ctypes.CDLL(str(lib))
    return libs


def main(argv=None) -> int:
    import numpy as np
    import torch

    from ..models import ReviserConfig, init_reviser_params
    from ..models.fused import fold_inference_params
    from ..models.reviser import randomize_inference_stats
    from . import reviser_kernel as rk

    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=191232)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stack_profile: no CUDA device available", file=sys.stderr)
        return 2
    t, n_win = 11, args.windows
    libs = _build(VARIANTS)
    dev = torch.device("cuda", 0)
    per_model = []
    for k, nc in enumerate((6, 5)):
        gen = torch.Generator().manual_seed(20261016 + k)
        p = randomize_inference_stats(
            init_reviser_params(gen, ReviserConfig(window=t, n_classes=nc)), gen)
        per_model.append(rk.pack_stack_weights(fold_inference_params(p), t))
    ws = rk.kernel_weights(rk.stack_models(per_model), dev)
    rng = np.random.default_rng(1)
    sig = torch.tensor(rng.normal(0, 1, (n_win + t, 64)), dtype=torch.float32)
    sig[:, 50:] = 0
    sig = sig.to(torch.bfloat16).to(dev)
    feats = torch.tensor(rng.normal(0.5, 0.3, (n_win + t, 6)), dtype=torch.float32,
                         device=dev)
    c = rk.stack_cluster_size()
    blocks = -(-(-(-n_win // 16)) // c) * c
    ptrs = rk._weight_ptrs(ws, rk.FULL_ORDER, t, per_model=True)
    logits = torch.zeros((2, n_win, 6), device=dev)
    probs = torch.zeros((2, n_win), device=dev)
    report = {"windows": n_win, "t": t, "cluster": c,
              "device": torch.cuda.get_device_name(0), "variants": {}}
    for v, lib in libs.items():
        prof = torch.zeros(2 * blocks * N_MARKS, dtype=torch.int64, device=dev)
        lib.nr_set_prof.argtypes = [ctypes.c_void_p]
        if lib.nr_set_prof(ctypes.c_void_p(prof.data_ptr())) != 0:
            raise build.KernelLaunchError("stack_profile: cannot set the buffer")
        fn = lib.nr_stack_full
        call = [build.ptr_array(ptrs), build.c_ptr(sig), build.c_ptr(feats),
                build.c_int(n_win + t - 1), build.c_int(t), build.c_int(n_win),
                build.c_int(n_win), build.c_ptr(logits), build.c_ptr(probs),
                build.stream_of(dev)]
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p)] + [type(a) for a in call[1:]]
        fn.restype = ctypes.c_int
        for _ in range(2):                       # warm-up
            if fn(*call) != 0:
                raise build.KernelLaunchError(f"stack_profile ({v}): launch refused")
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*call)
        end.record()
        torch.cuda.synchronize()
        mhz = _sm_mhz()
        marks = prof.view(-1, N_MARKS).cpu().numpy().astype(np.float64) / mhz
        row = {"ms": start.elapsed_time(end), "sm_mhz": mhz}
        for name, a, b in PHASES:
            row[name] = float((marks[:, b] - marks[:, a]).mean())
        for k, what in PARTS:
            row[f"split layers: {what}"] = float(marks[:, k].mean())
        for layer, key in (("layer 2", "l2_r"), ("layer 3", "l3_r"), ("layer 4", "l4_r")):
            fill_bytes = math.prod(rk.FULL_SHAPES[key][1:]) * 2   # a direction's step
            row[f"{layer}: weight stream B/clk"] = t * fill_bytes / (row[layer] * mhz)
        report["variants"][v or "kernel"] = row
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
