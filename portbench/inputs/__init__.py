"""The inputs the benchmark makes from a seed: reads, their fast5 files, weights."""
