"""Logging in the reference's exact format (the unitest checker parses it).

Parity: reference nanolog.py:14-25 — DEBUG logger, INFO file handler, DEBUG
stream handler, format '%(asctime)s - %(name)s - %(levelname)s - %(message)s'.
"""

from __future__ import annotations

import logging
import os


def logger_config(log_path: str, logging_name: str) -> logging.Logger:
    logger = logging.getLogger(logging_name)
    logger.setLevel(level=logging.DEBUG)
    parent = os.path.dirname(log_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if not logger.handlers:
        handler = logging.FileHandler(log_path, encoding="UTF-8")
        handler.setLevel(logging.INFO)
        handler.setFormatter(fmt)
        logger.addHandler(handler)
        console = logging.StreamHandler()
        console.setLevel(logging.DEBUG)
        console.setFormatter(fmt)
        logger.addHandler(console)
    return logger
