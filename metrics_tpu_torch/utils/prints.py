"""Process-0-gated logging helpers (port of ``metrics_tpu/utils/prints.py``).

Keyed on ``torch.distributed``'s rank when a process group is initialised,
else on the ``LOCAL_RANK`` environment variable.
"""
import logging
import os
import warnings
from functools import partial, wraps
from typing import Any, Callable

import torch

log = logging.getLogger("metrics_tpu_torch")


def _process_index() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return int(os.environ.get("LOCAL_RANK", 0))


def rank_zero_only(fn: Callable) -> Callable:
    """Run ``fn`` only on process 0."""

    @wraps(fn)
    def wrapped(*args: Any, **kwargs: Any) -> Any:
        if _process_index() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped


@rank_zero_only
def _warn(*args: Any, **kwargs: Any) -> None:
    warnings.warn(*args, **kwargs)


@rank_zero_only
def _info(*args: Any, **kwargs: Any) -> None:
    log.info(*args, **kwargs)


@rank_zero_only
def _debug(*args: Any, **kwargs: Any) -> None:
    log.debug(*args, **kwargs)


rank_zero_warn = partial(_warn)
rank_zero_info = partial(_info)
rank_zero_debug = partial(_debug)
