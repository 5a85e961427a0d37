"""The streaming engine of the port (``metrics_tpu/engine``, serving core):
bucketed steps of one stream (:class:`StreamingEngine`) or many
(:class:`MultiStreamEngine`, unsharded or paged), over per-dtype arenas, with
the whole-arena megastep kernels under ``kernel_backend="megastep"``, run on
a dispatcher thread that coalesces queued batches, as CUDA graphs captured
once per step signature (:class:`AotCache`) on the card."""
from metrics_tpu_torch.engine.aot import AotCache, metric_fingerprint
from metrics_tpu_torch.engine.arena import ArenaLayout
from metrics_tpu_torch.engine.bucketing import BucketPolicy
from metrics_tpu_torch.engine.faults import BackpressureTimeout, EngineDispatchError
from metrics_tpu_torch.engine.megastep import MegastepPlan, flat_reductions
from metrics_tpu_torch.engine.multistream import MultiStreamEngine
from metrics_tpu_torch.engine.paging import PageOp, StreamPager
from metrics_tpu_torch.engine.pipeline import EngineConfig, EngineStats, StreamingEngine
from metrics_tpu_torch.engine.quantize import ArenaRowCodec

__all__ = [
    "AotCache",
    "ArenaLayout",
    "ArenaRowCodec",
    "BackpressureTimeout",
    "BucketPolicy",
    "EngineConfig",
    "EngineDispatchError",
    "EngineStats",
    "MegastepPlan",
    "MultiStreamEngine",
    "PageOp",
    "StreamPager",
    "StreamingEngine",
    "flat_reductions",
    "metric_fingerprint",
]
