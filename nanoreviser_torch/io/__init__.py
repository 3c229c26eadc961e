from .fast5 import ReadData, extract_fastq, get_read_data, list_fast5_files
from .fasta import parse_fasta
from .writers import (
    format_read_fasta,
    format_read_fastq,
    format_train_fasta,
    write_read_fasta,
    write_read_fastq,
)

__all__ = [
    "ReadData",
    "get_read_data",
    "extract_fastq",
    "list_fast5_files",
    "format_read_fasta",
    "format_read_fastq",
    "format_train_fasta",
    "write_read_fasta",
    "write_read_fastq",
    "parse_fasta",
]
