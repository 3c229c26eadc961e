from .files import model_fn_generate, summary_generate, write_summary_file
from .logging import logger_config


def check_path(path: str) -> None:
    """Create ``path`` (and its parents) if it does not exist."""
    import os

    os.makedirs(str(path), exist_ok=True)


__all__ = ["logger_config", "check_path", "model_fn_generate", "summary_generate",
           "write_summary_file"]
