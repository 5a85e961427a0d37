"""The streaming engine of the port (``metrics_tpu/engine``, serving core):
bucketed steps of one stream (:class:`StreamingEngine`) or many
(:class:`MultiStreamEngine`, unsharded or paged), over per-dtype arenas, with
the whole-arena megastep kernels under ``kernel_backend="megastep"``, run on
a dispatcher thread that coalesces queued batches, as CUDA graphs captured
once per step signature (:class:`AotCache`) on the card; crash-safe
snapshots and the restore matrix (``engine/snapshot.py``), in a format the
JAX package reads and writes, with the fault layer they stand on
(``engine/faults.py``)."""
from metrics_tpu_torch.engine.aot import AotCache, metric_fingerprint
from metrics_tpu_torch.engine.arena import ArenaLayout
from metrics_tpu_torch.engine.bucketing import BucketPolicy
from metrics_tpu_torch.engine.faults import (
    BackpressureTimeout,
    BoundaryMergeError,
    EngineDispatchError,
    FaultInjector,
    FaultSpec,
    InjectedFault,
    QuarantineRecord,
    ScreenPolicy,
    SnapshotCorruptError,
    StepTimeoutError,
)
from metrics_tpu_torch.engine.megastep import MegastepPlan, flat_reductions
from metrics_tpu_torch.engine.multistream import MultiStreamEngine
from metrics_tpu_torch.engine.paging import PageOp, StreamPager
from metrics_tpu_torch.engine.pipeline import EngineConfig, EngineStats, StreamingEngine
from metrics_tpu_torch.engine.quantize import (
    ArenaRowCodec,
    decode_state_tree,
    encode_state_tree,
    q8_decode_array,
    q8_encode_array,
)
from metrics_tpu_torch.engine.snapshot import generations, latest_snapshot, load_snapshot, save_snapshot

__all__ = [
    "AotCache",
    "ArenaLayout",
    "ArenaRowCodec",
    "BackpressureTimeout",
    "BoundaryMergeError",
    "BucketPolicy",
    "EngineConfig",
    "EngineDispatchError",
    "EngineStats",
    "FaultInjector",
    "FaultSpec",
    "InjectedFault",
    "MegastepPlan",
    "MultiStreamEngine",
    "PageOp",
    "QuarantineRecord",
    "ScreenPolicy",
    "SnapshotCorruptError",
    "StepTimeoutError",
    "StreamPager",
    "StreamingEngine",
    "decode_state_tree",
    "encode_state_tree",
    "flat_reductions",
    "generations",
    "latest_snapshot",
    "load_snapshot",
    "metric_fingerprint",
    "q8_decode_array",
    "q8_encode_array",
    "save_snapshot",
]
