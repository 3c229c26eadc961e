"""Seconds from the start of the run to the start of the window: imports,
the program's first build where there is none, inputs and weights from the
seed, and the warm pass. By the host's clock."""

UNIT = "s"


def read(rec):
    return rec.get("setup_s")
