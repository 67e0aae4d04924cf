"""Structured logging for the SfM pipeline.

Parity: the reference logs per phase through glog (`LOG(INFO)`/`VLOG`, e.g.
`global_reconstruction_estimator.cc:157-167`, per-stage counts in
`incremental_reconstruction_estimator.cc:298`) with verbosity flags. Here a
stdlib logger named "pytheiasfm_tpu_torch" carries the same observability:

    from pytheiasfm_tpu_torch.utils.log import logger, set_verbosity, phase
    set_verbosity(1)           # glog-style: 0=WARNING, 1=INFO, 2+=DEBUG
    with phase("rotation estimation"):   # logs entry + wall time
        ...
    logger.info("%d view pairs verified", n)

Libraries must not configure the root logger; `set_verbosity` attaches a
stderr handler to the package logger only (and only once).
"""

from __future__ import annotations

import contextlib
import logging
import time

__all__ = ["logger", "set_verbosity", "phase", "vlog"]

logger = logging.getLogger("pytheiasfm_tpu_torch")
logger.addHandler(logging.NullHandler())

_LEVELS = {0: logging.WARNING, 1: logging.INFO}
_configured = False


def set_verbosity(level: int = 1) -> None:
    """glog-style verbosity: 0 -> WARNING, 1 -> INFO, >=2 -> DEBUG."""
    global _configured
    if not _configured:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter(
                "%(levelname).1s %(asctime)s %(name)s] %(message)s",
                datefmt="%H:%M:%S",
            )
        )
        logger.addHandler(handler)
        _configured = True
    logger.setLevel(_LEVELS.get(level, logging.DEBUG))


def vlog(level: int, msg: str, *args) -> None:
    """glog VLOG(level): level 1 -> INFO, deeper -> DEBUG."""
    logger.log(logging.INFO if level <= 1 else logging.DEBUG, msg, *args)


@contextlib.contextmanager
def phase(name: str, **context):
    """Log a pipeline phase with its wall-clock time on exit.

    Yields a dict the body may fill with result stats; they are appended to
    the completion line (mirrors the reference's per-phase summary logs).
    """
    extra = dict(context)
    logger.info("%s ...", name)
    t0 = time.perf_counter()
    try:
        yield extra
    finally:
        dt = time.perf_counter() - t0
        stats = " ".join(f"{k}={v}" for k, v in extra.items())
        logger.info("%s done in %.3fs%s", name, dt, f" ({stats})" if stats else "")
