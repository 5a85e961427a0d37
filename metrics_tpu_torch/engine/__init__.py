"""The streaming engine of the port (``metrics_tpu/engine``, serving core):
bucketed steps of one stream (:class:`StreamingEngine`) or many
(:class:`MultiStreamEngine`, unsharded or paged), over per-dtype arenas, with
the whole-arena megastep kernels under ``kernel_backend="megastep"``, run on
a dispatcher thread that coalesces queued batches, as CUDA graphs captured
once per step signature (:class:`AotCache`) on the card; crash-safe
snapshots and the restore matrix (``engine/snapshot.py``), in a format the
JAX package reads and writes, with the fault layer they stand on
(``engine/faults.py``); the telemetry ring (``engine/stats.py``), the flight
recorder and its OpenMetrics view (``engine/trace.py``), admission control
and the degradation ladder (``engine/admission.py``), windowed serving
(tumbling, sliding and EWMA pane rings, ``engine/windows.py``) with drift
alarms over the closed panes (``engine/tracker.py``), ragged serving of
group-keyed metrics (:class:`RaggedEngine`, ``engine/ragged.py``), the
multi-host fleet over ``torch.distributed`` (:class:`FleetEngine`,
``engine/fleet/``), and the seeded Zipf traffic the serving checks share
(``engine/traffic.py``)."""
from metrics_tpu_torch.engine.admission import (
    LADDER_RUNGS,
    AdmissionPolicy,
    AdmissionRejected,
    DegradationLadder,
    OverloadDetector,
    TokenBucket,
)
from metrics_tpu_torch.engine.aot import AotCache, metric_fingerprint
from metrics_tpu_torch.engine.arena import ArenaLayout
from metrics_tpu_torch.engine.bucketing import BucketPolicy
from metrics_tpu_torch.engine.fleet import (
    FleetBarrierError,
    FleetConfig,
    FleetEngine,
    FleetHostLostError,
    FleetTopologyError,
    fleet_mesh,
    last_consistent_cut,
    restore_fleet_into,
)
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
from metrics_tpu_torch.engine.pipeline import EngineConfig, StreamingEngine
from metrics_tpu_torch.engine.ragged import GroupedStateMetric, RaggedEngine
from metrics_tpu_torch.engine.quantize import (
    ArenaRowCodec,
    decode_state_tree,
    encode_state_tree,
    q8_decode_array,
    q8_encode_array,
)
from metrics_tpu_torch.engine.snapshot import generations, latest_snapshot, load_snapshot, save_snapshot
from metrics_tpu_torch.engine.stats import EngineStats
from metrics_tpu_torch.engine.trace import (
    DEFAULT_LATENCY_BUCKETS_US,
    FixedBucketHistogram,
    TraceRecorder,
    device_trace_session,
    render_openmetrics,
)
from metrics_tpu_torch.engine.tracker import DriftAlarm, DriftAlarmError, DriftDetector
from metrics_tpu_torch.engine.traffic import zipf_stream_ids, zipf_traffic
from metrics_tpu_torch.engine.windows import WINDOW_KINDS, WindowPolicy

__all__ = [
    "AdmissionPolicy",
    "AdmissionRejected",
    "AotCache",
    "ArenaLayout",
    "ArenaRowCodec",
    "BackpressureTimeout",
    "BoundaryMergeError",
    "BucketPolicy",
    "DEFAULT_LATENCY_BUCKETS_US",
    "DegradationLadder",
    "DriftAlarm",
    "DriftAlarmError",
    "DriftDetector",
    "EngineConfig",
    "EngineDispatchError",
    "EngineStats",
    "FaultInjector",
    "FaultSpec",
    "FixedBucketHistogram",
    "FleetBarrierError",
    "FleetConfig",
    "FleetEngine",
    "FleetHostLostError",
    "FleetTopologyError",
    "GroupedStateMetric",
    "InjectedFault",
    "LADDER_RUNGS",
    "MegastepPlan",
    "MultiStreamEngine",
    "OverloadDetector",
    "PageOp",
    "QuarantineRecord",
    "RaggedEngine",
    "ScreenPolicy",
    "SnapshotCorruptError",
    "StepTimeoutError",
    "StreamPager",
    "StreamingEngine",
    "TokenBucket",
    "TraceRecorder",
    "WINDOW_KINDS",
    "WindowPolicy",
    "decode_state_tree",
    "device_trace_session",
    "encode_state_tree",
    "flat_reductions",
    "fleet_mesh",
    "generations",
    "last_consistent_cut",
    "latest_snapshot",
    "load_snapshot",
    "metric_fingerprint",
    "q8_decode_array",
    "q8_encode_array",
    "render_openmetrics",
    "restore_fleet_into",
    "save_snapshot",
    "zipf_stream_ids",
    "zipf_traffic",
]
