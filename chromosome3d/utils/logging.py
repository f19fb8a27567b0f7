"""Logging / observability.

The reference's observability is stdout banners with localtime brackets
(chromosome3D.pl:48-53, 100-108) plus per-job log files (test.sh:5,10).
Here: standard logging with a stdout handler, wall-clock bracketing via
`timed`, and an optional jax.profiler trace context for device
profiling (something the reference has none of, SURVEY.md section 5).
"""

from __future__ import annotations

import contextlib
import logging
import sys
import time


def get_logger(name: str = "chromosome3d") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers and not logging.getLogger().handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("[%(asctime)s] %(message)s", "%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def banner(logger: logging.Logger, message: str) -> None:
    logger.info(message)


@contextlib.contextmanager
def timed(logger: logging.Logger, label: str):
    t0 = time.time()
    logger.info(f"Start: {label}")
    try:
        yield
    finally:
        logger.info(f"Done : {label} [{time.time() - t0:.2f}s]")


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """jax.profiler trace context; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
