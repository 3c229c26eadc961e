"""NanoReviser on PyTorch and CUDA: revision and training on an NVIDIA H100.

A second implementation of ``nanoreviser_tpu``, written for PyTorch with
hand-written CUDA kernels for Hopper (``csrc/``). Module names mirror the
JAX package so each counterpart is easy to find:

- ``io``      fast5 ingestion, fasta/fastq writers, a synthetic fast5 writer
- ``signal``  MAD normalizers, per-base features, per-read signal compaction
- ``models``  Keras ``.h5`` import/export, eager reviser, BN folding
- ``ops``     the window-gather and reviser-stack kernels, their plain
              PyTorch versions, and the nvcc build
- ``infer``   wire encode/decode, revision merge, the streaming engine,
              the external-basecaller hook
- ``align``   SAM parsing, labels, the banded Smith-Waterman aligner
- ``train``   the loss, the Adam step, the windowed corpus, the epoch loop
- ``parallel`` the data-parallel mesh: one process per card
- ``dist``    process groups, file sharding, batch slices
- ``native``  the host library (compaction, wire encode, the aligner's DP)
- ``cli``     the reviser and training command lines

The package imports torch and numpy only (HDF5 files are read and written
by its own ``io.hdf5``). Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
