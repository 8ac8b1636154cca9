"""Leveled, env-configured logging.

Port of `eetq_tpu/utils/logging.py`: the level comes from EETQ_LOG_LEVEL
(DEBUG/INFO/WARNING/ERROR), and EETQ_LOG_FIRST_RANK_ONLY=ON silences every
process but rank 0 of an initialised `torch.distributed` group (where the
JAX package asks `jax.process_index()`).
"""

from __future__ import annotations

import logging
import os
import sys

ROOT = "eetq_tpu_torch"
_CONFIGURED = False


def _configure() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    level_name = os.environ.get("EETQ_LOG_LEVEL", "INFO").upper()
    level = getattr(logging, level_name, logging.INFO)
    if os.environ.get("EETQ_LOG_FIRST_RANK_ONLY", "").upper() in ("ON", "1", "TRUE"):
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
            level = logging.ERROR
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter("[EETQ][%(levelname)s][%(name)s] %(message)s"))
    root = logging.getLogger(ROOT)
    root.setLevel(level)
    root.addHandler(handler)
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    _configure()
    if not name.startswith(ROOT):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)
