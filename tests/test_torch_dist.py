"""Port multi-process inference vs the JAX package (CPU).

* ``shard_files`` equals the JAX package's for every file count 0..40 and
  process count 1..5.
* ``write_merged_part`` / ``merge_parts`` merge in shard order, whatever
  order the parts were written in, and remove the parts.
* Two port CLI processes (gloo over TCP on localhost, ``--device cpu``,
  ``--align center``, ``--merged_output``) write a merged fasta
  byte-identical to one process's.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

from nanoreviser_torch.dist import merge_parts, shard_files, write_merged_part
from nanoreviser_torch.io.synthetic import write_synthetic_dir
from nanoreviser_torch.models import ReviserConfig, init_reviser_params, save_keras_weights
from nanoreviser_torch.models.reviser import randomize_inference_stats
from nanoreviser_tpu.dist import shard_files as jax_shard_files
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [1, 2, 3, 4, 5])
def test_shard_files_matches_jax(world):
    for n in range(41):
        fns = [f"read_{(7 * i) % 41:03d}.fast5" for i in range(n)]
        shards = [shard_files(fns, k, world) for k in range(world)]
        assert shards == [jax_shard_files(fns, k, world) for k in range(world)]
        assert sum(shards, []) == sorted(fns)


def test_merged_parts_shard_ordered(tmp_path):
    out = str(tmp_path)
    write_merged_part(out, 1, [(">b", "CCC")])
    write_merged_part(out, 0, [(">a", "AAA"), (">c", "TTT")])
    merged = merge_parts(out, os.path.join(out, "merged.fasta"), 2, timeout_s=5)
    with open(merged) as fp:
        assert fp.read() == ">a\nAAA\n>c\nTTT\n>b\nCCC\n"
    assert not [f for f in os.listdir(out) if f.startswith("merged.part")]


def test_two_process_cli_merged_output_matches_one_process(tmp_path):
    from nanoreviser_torch.cli.reviser import main

    fast5 = str(tmp_path / "fast5")
    names = write_synthetic_dir(fast5, 5, (150, 380), seed=33)
    paths = []
    for k, nc in enumerate((6, 5)):
        gen = torch.Generator().manual_seed(300 + k)
        p = randomize_inference_stats(
            init_reviser_params(gen, ReviserConfig(window=11, n_classes=nc)), gen)
        paths.append(str(tmp_path / f"m{k + 1}.h5"))
        save_keras_weights(p, paths[-1], 11, nc)
    common = ["-d", fast5, "-F", "fasta", "--revise_mode", "model",
              "--device", "cpu", "--align", "center", "--thread", "1",
              "--model1_predict_dir", paths[0], "--model2_predict_dir", paths[1]]

    one, two = tmp_path / "one", tmp_path / "two"
    assert main(common + ["-o", str(one), "--merged_output", str(one / "m.fasta"),
                          "-e", str(tmp_path / "failed_one.txt")]) == 0

    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nanoreviser_torch.cli.reviser", *common,
         "-o", str(two), "--merged_output", str(two / "m.fasta"),
         "-e", str(tmp_path / f"failed_two{k}.txt"),
         "--coordinator_address", coord, "--num_processes", "2",
         "--process_id", str(k)],
        cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "process 0/2: 3 reads" in outs[0] and "process 1/2: 2 reads" in outs[1]
    merged = (two / "m.fasta").read_bytes()
    assert merged == (one / "m.fasta").read_bytes()
    assert merged.count(b">") == len(names)
    assert sorted(os.listdir(two)) == sorted(
        [n.split(".")[0] + "_out.fasta" for n in names] + ["m.fasta"])
