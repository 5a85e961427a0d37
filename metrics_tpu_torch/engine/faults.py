"""The engine's failure types (port of part of ``metrics_tpu/engine/faults.py``).

Only the two a producer or reader meets on the dispatcher path are here:
:class:`EngineDispatchError`, the sticky dispatcher failure surfaced by
``flush``/``result``/``state``/``submit``, and :class:`BackpressureTimeout`,
raised by ``submit(timeout=)`` on a queue that stays full. The fault
injector, screening and quarantine are not ported yet (ROADMAP §A).
"""
from typing import Any, Dict, Optional

__all__ = ["BackpressureTimeout", "EngineDispatchError"]


class EngineDispatchError(RuntimeError):
    """The sticky dispatcher failure, surfaced to producers/readers.

    Chains the original exception (``raise ... from cause``) and carries the
    failure context the dispatcher recorded: ``cursor`` (the replay cursor of
    the failing batch), ``step``, ``bucket``, and ``stream_ids`` for
    multi-stream engines.
    """

    def __init__(self, message: str, context: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.context = dict(context or {})
        self.cursor = self.context.get("cursor")
        self.bucket = self.context.get("bucket")
        self.stream_ids = self.context.get("stream_ids")


class BackpressureTimeout(TimeoutError):
    """``submit(timeout=...)`` gave up: the bounded queue stayed full for the
    whole window. Raised only when no sticky dispatcher error exists (that
    error is surfaced instead: a dead dispatcher behind a full queue must
    never read as mere backpressure)."""
