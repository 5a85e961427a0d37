"""Fleet runtime: H processes over ``torch.distributed``, each serving its own
traffic through an ordinary local engine. Port of
``metrics_tpu/engine/fleet/runtime.py``.

* **Per-host ingestion.** Every host runs one local engine: a
  :class:`~metrics_tpu_torch.engine.multistream.MultiStreamEngine` when
  ``FleetConfig.num_streams`` is set (stream ``sid`` homes on host
  ``sid % num_processes``), else a
  :class:`~metrics_tpu_torch.engine.pipeline.StreamingEngine` (batches home
  by their position in the shared plan). A host folds only its own rows, in
  plan order, so its steady state never crosses hosts: a local mesh must be
  ``mesh_sync="deferred"``.
* **Boundary folds.** ``fleet_state()``, ``result()`` and ``results()`` are
  collective boundaries every host enters at the same plan position: the
  host's logical state rides ONE ``Metric.sync_states`` bundle over the
  fleet's process group, then ``compute_from`` (batched over the streams
  with ``torch.func.vmap``, as the port's ``results()``). A non-home host
  holds the reduction identity for a foreign stream, so the fold is exact.
* **The cut barrier and snapshots.** Cuts sit at shared-plan positions
  (``snapshot_every`` global batches through :meth:`FleetEngine.ingest`, or
  explicit :meth:`FleetEngine.fleet_snapshot` calls), never at a clock: the
  hosts ``all_gather`` their int32 cut cursors and must agree, then each
  writes its piece under ``host_<pid>/`` through its engine's crash-safe
  snapshot, stamped with the host topology, and an fsynced
  ``fleet_cut_<k>`` marker. A cut is consistent once every host's marker
  lands; restore takes the newest consistent one.
* **The restore matrix.** A same-size fleet restores each host's piece
  (:meth:`FleetEngine.restore`); :func:`restore_fleet_into` folds every
  piece into one single-process engine through ``merge_stacked_states``;
  :meth:`FleetEngine.adopt_single` seats a single-process snapshot on host
  0. Every mismatch of host counts, host ids or cuts raises a typed error.

The fleet's group is ``torch.distributed``'s default group, which
:class:`FleetEngine` initialises from ``coordinator_address`` (rank =
``process_id``) unless the caller already has: NCCL when every host's
representative device (the device its engine serves on) is a card of its
own, gloo when it is the CPU or when hosts share a card (NCCL refuses two
ranks on one device). The hosts agree on the layout through the
rendezvous store before the group starts, and a failed start raises. The
degenerate fleet (one host) runs the same fold and barrier over a world-1
mesh axis on its device and initialises nothing.
"""
import os
import re
import socket
import time
from dataclasses import dataclass, replace
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from metrics_tpu_torch.engine.faults import InjectedFault
from metrics_tpu_torch.engine.multistream import MultiStreamEngine, _values_to_host
from metrics_tpu_torch.engine.pipeline import EngineConfig, StreamingEngine, _metric_device, _norm_device
from metrics_tpu_torch.engine.quantize import decode_state_tree
from metrics_tpu_torch.engine.snapshot import load_snapshot
from metrics_tpu_torch.engine.trace import ENGINE_TRACE, render_openmetrics
from metrics_tpu_torch.parallel.collectives import all_gather_cat, hierarchical_fold_bytes, mesh_all_gather_tiled
from metrics_tpu_torch.parallel.mesh import Mesh, MeshAxis
from metrics_tpu_torch.utils.checks import traced_rows
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utils.state_bridge import _tensor_from_numpy
from metrics_tpu_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

__all__ = [
    "FleetBarrierError",
    "FleetConfig",
    "FleetEngine",
    "FleetHostLostError",
    "FleetTopologyError",
    "fleet_mesh",
    "last_consistent_cut",
    "restore_fleet_into",
]

_HOST_DIR_RE = re.compile(r"^host_(\d{3})$")
_CUT_MARKER_RE = re.compile(r"^fleet_cut_(\d{6})$")
#: how long a host waits for the others at the rendezvous
_RENDEZVOUS_TIMEOUT = timedelta(seconds=120)


class FleetTopologyError(MetricsTPUUserError):
    """A fleet/host topology mismatch: wrong host count, wrong host id,
    inconsistent cut indices, or a single-process snapshot where a fleet
    piece was required (and vice versa)."""


class FleetBarrierError(RuntimeError):
    """Hosts entered a snapshot-cut barrier with DIFFERENT cut cursors: the
    ingest plans have diverged, and no generation mixing two cuts is
    written."""


class FleetHostLostError(RuntimeError):
    """A fleet host was lost at a boundary (the non-transient ``host_loss``
    fault): the host-local steady state is intact, but cross-host
    boundaries cannot complete; restore the fleet from the last consistent
    snapshot cut."""


@dataclass
class FleetConfig:
    """Topology and per-host ingestion of :class:`FleetEngine`.

    Args:
        num_processes: the fleet size H. 1 (the default) is the degenerate
            fleet: no process group, a one-device fleet axis, every stream
            homed here; it runs the same fold and barrier code as H > 1.
        process_id: this host's rank in ``[0, num_processes)``.
        coordinator_address: ``tcp://host:port`` (or ``host:port``) of rank
            0's rendezvous; required when ``num_processes > 1`` unless the
            default process group is already initialised.
        engine: the per-host :class:`~metrics_tpu_torch.engine.pipeline.EngineConfig`.
            A local mesh must run ``mesh_sync="deferred"``; its
            ``snapshot_dir``/``snapshot_every`` must be unset (fleet
            snapshots follow the cut protocol).
        num_streams: serve S streams, stream ``sid`` homed on host
            ``sid % num_processes``; None serves one accumulation, batches
            homed by plan position.
        stream_shard: each host's engine in the paged form: ``resident_streams``
            slots a shard and the spill store for its home streams.
            Requires ``num_streams``.
        resident_streams: the paged form's slots a shard (0: every local
            stream resident). A memory budget, not a coordinate: restore
            re-homes across residencies through the spill store.
        snapshot_dir: the fleet's snapshot directory (shared storage); each
            host's pieces go under ``host_<pid>/``.
        snapshot_every: cut cadence in GLOBAL plan batches of
            :meth:`FleetEngine.ingest` (0: explicit
            :meth:`FleetEngine.fleet_snapshot` calls only).
        fleet_axis: the fleet axis's name.
    """

    num_processes: int = 1
    process_id: int = 0
    coordinator_address: Optional[str] = None
    engine: Any = None
    num_streams: Optional[int] = None
    stream_shard: bool = False
    resident_streams: int = 0
    snapshot_dir: Optional[str] = None
    snapshot_every: int = 0
    fleet_axis: str = "fleet"


def _rendezvous_address(address: str) -> Tuple[str, int]:
    """``(host, port)`` of ``tcp://host:port`` or ``host:port``."""
    hostport = address[len("tcp://"):] if address.startswith("tcp://") else address
    host, _, port = hostport.rpartition(":")
    if not host or not port.isdigit():
        raise FleetTopologyError(f"coordinator_address must be tcp://host:port or host:port, got {address!r}")
    return host, int(port)


def _device_identity(device: torch.device) -> str:
    """This host's representative device, as the layout compares it: the
    machine and, for a card, its UUID (two ranks on one card compare equal
    whatever each process's device numbering)."""
    ident = str(device)
    if device.type == "cuda":
        uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
        ident = f"cuda:{uuid}" if uuid is not None else ident
    return f"{socket.gethostname()}/{ident}"


def fleet_backend(layout: List[str]) -> str:
    """The transport a fleet layout takes: ``"nccl"`` when every host's
    representative device is a card no other host uses, else ``"gloo"``
    (the CPU, or hosts sharing a card, which NCCL refuses)."""
    cards = [d for d in layout if "/cuda" in d]
    return "nccl" if len(cards) == len(layout) and len(set(cards)) == len(cards) else "gloo"


def _ensure_distributed(cfg: FleetConfig, device: torch.device) -> None:
    """Start the default process group for an H > 1 fleet: rank
    ``process_id`` of ``num_processes``, through a rendezvous store at
    ``coordinator_address`` where the hosts first publish their devices so
    every host picks the same backend (:func:`fleet_backend`). An
    initialised default group is left alone; its size must match. A failed
    start raises; no other backend is tried."""
    H, pid = int(cfg.num_processes), int(cfg.process_id)
    if H <= 1:
        return
    if dist.is_initialized():
        live = dist.get_world_size()
        if live != H:
            raise FleetTopologyError(
                f"the default process group has {live} ranks but FleetConfig says num_processes={H}")
        return
    if cfg.coordinator_address is None:
        raise FleetTopologyError(
            "num_processes > 1 needs coordinator_address (rank 0's tcp://host:port) unless the default "
            "process group is already initialized")
    host, port = _rendezvous_address(cfg.coordinator_address)
    store = dist.TCPStore(host, port, H, is_master=pid == 0, timeout=_RENDEZVOUS_TIMEOUT)
    store.set(f"fleet_device/{pid}", _device_identity(device))
    layout = [store.get(f"fleet_device/{p}").decode() for p in range(H)]
    backend = fleet_backend(layout)
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=pid, world_size=H)


class FleetMesh:
    """The fleet's group and this host's representative device (the device
    its engine serves on): the counterpart of JAX's one-device-a-host fleet
    mesh. ``group`` is a world-1 :class:`MeshAxis` for the degenerate fleet,
    else None, the default process group; ``backend`` names the transport."""

    def __init__(self, num_hosts: int, device: torch.device, axis: str):
        self.num_hosts = num_hosts
        self.device = device
        self.axis = axis
        if num_hosts == 1:
            self.group: Optional[MeshAxis] = Mesh([device], (axis,)).axis(axis)
            self.backend = "one_device"
        else:
            self.group = None
            self.backend = dist.get_backend()


def fleet_mesh(num_hosts: int, axis: str = "fleet", device: Any = "cpu") -> FleetMesh:
    """The fleet's group for ``num_hosts`` hosts with ``device`` as this
    host's representative device. More than one host needs the default
    process group started with ``num_hosts`` ranks."""
    if num_hosts <= 0:
        raise FleetTopologyError(f"num_hosts must be positive, got {num_hosts}")
    dev = _norm_device(torch.device(device))
    if num_hosts > 1 and (not dist.is_initialized() or dist.get_world_size() != num_hosts):
        live = dist.get_world_size() if dist.is_initialized() else 0
        raise FleetTopologyError(
            f"a {num_hosts}-host fleet needs the default process group started with {num_hosts} ranks "
            f"(it has {live})")
    return FleetMesh(num_hosts, dev, axis)


def _host_dirs(fleet_dir: str) -> Dict[int, str]:
    """``{process_id: host dir}`` under a fleet snapshot directory."""
    try:
        names = os.listdir(fleet_dir)
    except (FileNotFoundError, NotADirectoryError):
        return {}
    out: Dict[int, str] = {}
    for n in sorted(names):
        m = _HOST_DIR_RE.match(n)
        if m:
            out[int(m.group(1))] = os.path.join(fleet_dir, n)
    return out


def _host_cuts(host_dir: str) -> Dict[int, str]:
    """``{cut index: snapshot basename}`` from one host dir's cut markers
    (a marker naming a snapshot that is gone is skipped)."""
    out: Dict[int, str] = {}
    try:
        names = os.listdir(host_dir)
    except (FileNotFoundError, NotADirectoryError):
        return out
    for n in names:
        m = _CUT_MARKER_RE.match(n)
        if not m:
            continue
        try:
            with open(os.path.join(host_dir, n)) as f:
                snap = f.read().strip()
        except OSError:
            continue
        if snap and os.path.exists(os.path.join(host_dir, snap)):
            out[int(m.group(1))] = snap
    return out


def last_consistent_cut(fleet_dir: str, num_hosts: int) -> Optional[int]:
    """The newest cut index EVERY host completed (its marker and the snapshot
    it names exist), or None. A host that died between the barrier and its
    save leaves the cut incomplete, and restore falls back to the previous
    one. Raises :class:`FleetTopologyError` when the directory was written
    by another host count."""
    dirs = _host_dirs(fleet_dir)
    if not dirs:
        return None
    if set(dirs) != set(range(num_hosts)):
        raise FleetTopologyError(
            f"fleet snapshot dir {fleet_dir!r} holds host pieces {sorted(dirs)} but this fleet has "
            f"num_hosts={num_hosts} (expected exactly hosts 0..{num_hosts - 1}); restore it with a same-size "
            "fleet, or merge it into a single-process engine with restore_fleet_into()")
    common = set.intersection(*[set(_host_cuts(dirs[p])) for p in range(num_hosts)])
    return max(common) if common else None


class FleetEngine:
    """H-host serving of one metric or collection.

    Construction starts the process group (for H > 1), builds the fleet's
    group and this host's local engine. The steady state is host-local;
    ``result()``, ``results()``, ``fleet_state()``, ``fleet_snapshot()`` and
    ``restore()`` are collective boundaries every host enters at the same
    position of the shared plan. See the module docstring.
    """

    def __init__(self, metric: Any, config: Optional[FleetConfig] = None, aot_cache: Any = None):
        self._fcfg = replace(config) if config is not None else FleetConfig()
        H, pid = int(self._fcfg.num_processes), int(self._fcfg.process_id)
        if H <= 0:
            raise FleetTopologyError(f"num_processes must be positive, got {H}")
        if not 0 <= pid < H:
            raise FleetTopologyError(f"process_id must be in [0, {H}), got {pid}")
        inner = self._fcfg.engine if self._fcfg.engine is not None else EngineConfig()
        if not isinstance(inner, EngineConfig):
            raise MetricsTPUUserError(f"FleetConfig.engine must be an EngineConfig, got {type(inner).__name__}")
        if inner.mesh is not None and inner.mesh_sync != "deferred":
            raise MetricsTPUUserError(
                "a fleet host's local mesh must run mesh_sync='deferred': the fleet steady state is "
                "collective-free by contract, and a step-sync local mesh would psum inside every step")
        if inner.snapshot_dir or inner.snapshot_every:
            raise MetricsTPUUserError(
                "set FleetConfig.snapshot_dir/snapshot_every, not the inner EngineConfig's: fleet snapshots "
                "follow the globally consistent cut protocol (barrier-on-batch-boundary), not a per-host cadence")
        if int(self._fcfg.snapshot_every) > 0 and not self._fcfg.snapshot_dir:
            raise MetricsTPUUserError(
                "FleetConfig.snapshot_every > 0 requires snapshot_dir — the first auto-cut would otherwise "
                "fail MID-PLAN, after real serving work (same construction-time contract as "
                "EngineConfig.snapshot_every)")
        if self._fcfg.stream_shard and self._fcfg.num_streams is None:
            raise MetricsTPUUserError(
                "FleetConfig(stream_shard=True) needs num_streams: stream sharding partitions the per-stream "
                "paged arena, and a single-accumulation fleet has no stream axis to shard — set num_streams=S, "
                "or drop stream_shard and serve the single accumulation with plan-position homing")
        if int(self._fcfg.resident_streams or 0) and not self._fcfg.stream_shard:
            raise MetricsTPUUserError(
                "FleetConfig.resident_streams only applies with stream_shard=True (it is the per-shard "
                "paged-arena slot budget) — set stream_shard=True, or drop resident_streams")
        win = inner.window
        self._windowed = win is not None and getattr(win, "kind", "cumulative") != "cumulative"
        self._pane_batches = 0
        if self._windowed:
            # rotations ride the shared plan cursor through the cut protocol:
            # the policy refuses wall-clock cadence, ewma and cat states
            reason = win.fleet_unsupported_reason(metric)
            if reason is not None:
                raise MetricsTPUUserError(f"windowed fleet serving: {reason}")
            self._pane_batches = int(win.pane_batches)
            every = int(self._fcfg.snapshot_every)
            if every > 0 and self._pane_batches % every != 0:
                raise MetricsTPUUserError(
                    "fleet pane rotations ride the snapshot-cut protocol: window.pane_batches must be a multiple "
                    "of FleetConfig.snapshot_every so every rotation lands on a barriered, fleet-consistent cut "
                    f"boundary (got pane_batches={self._pane_batches}, snapshot_every={every})")
        device = _norm_device(_metric_device(metric))
        _ensure_distributed(self._fcfg, device)
        self._H, self._pid = H, pid
        self._axis = self._fcfg.fleet_axis
        self._mesh = fleet_mesh(H, self._axis, device)
        self._fleet_device = device

        S = self._fcfg.num_streams
        if S is None:
            self._engine = StreamingEngine(metric, inner, aot_cache=aot_cache)
        else:
            ms_kwargs: Dict[str, Any] = {}
            if self._fcfg.stream_shard:
                ms_kwargs["stream_shard"] = True
                if int(self._fcfg.resident_streams or 0):
                    ms_kwargs["resident_streams"] = int(self._fcfg.resident_streams)
            self._engine = MultiStreamEngine(metric, int(S), inner, aot_cache=aot_cache, **ms_kwargs)
        if self._windowed:
            # the local cadence counts owned batches, which differ per host
            self._engine._fleet_rotation = True
        # the host topology: every snapshot the engine writes carries it, and
        # its restore refuses a piece of another topology
        self._engine._fleet_hosts = H
        self._engine._fleet_pid = pid
        st = self._engine.stats
        st.fleet_hosts = H
        st.fleet_process_id = pid
        st.fleet_streams_owned = len(self.streams_owned)
        self._metric = metric
        self._global_cursor = 0
        self._next_cut = 0
        self._payload_split: Optional[Tuple[int, int]] = None
        self._intra_bytes: Optional[int] = None
        if self._fcfg.snapshot_dir:
            self._host_dir: Optional[str] = os.path.join(self._fcfg.snapshot_dir, f"host_{pid:03d}")
            # the local engine writes the pieces into the host's subdirectory
            self._engine._cfg.snapshot_dir = self._host_dir
        else:
            self._host_dir = None

    # ------------------------------------------------------------------ topology

    @property
    def engine(self) -> Any:
        """The host-local ingestion engine."""
        return self._engine

    @property
    def mesh(self) -> FleetMesh:
        return self._mesh

    @property
    def num_hosts(self) -> int:
        return self._H

    @property
    def process_id(self) -> int:
        return self._pid

    @property
    def num_streams(self) -> Optional[int]:
        return self._fcfg.num_streams

    @property
    def streams_owned(self) -> List[int]:
        """Stream ids homed on THIS host (``sid % num_hosts == process_id``)."""
        S = self._fcfg.num_streams
        if S is None:
            return []
        return [sid for sid in range(int(S)) if sid % self._H == self._pid]

    @property
    def global_cursor(self) -> int:
        """Shared-plan batches :meth:`ingest` has seen, owned or not: the
        coordinate cuts are defined in."""
        return self._global_cursor

    def home(self, stream_id: int) -> int:
        """The host that owns ``stream_id``."""
        return int(stream_id) % self._H

    # ------------------------------------------------------------------ lifecycle

    def start(self) -> "FleetEngine":
        self._engine.start()
        return self

    def stop(self) -> None:
        self._engine.stop()

    def __enter__(self) -> "FleetEngine":
        return self.start()

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        self.stop()
        return False

    # -------------------------------------------------------------------- ingest

    def submit(self, *args: Any, **kwargs: Any) -> None:
        """Strict per-host submit: a multi-stream fleet takes ``(stream_id,
        *batch)`` and refuses a stream homed elsewhere, naming its home; a
        single-accumulation fleet takes any batch (the caller splits; see
        :meth:`ingest`). A windowed fleet refuses: its rotations need the
        plan cursor."""
        if self._windowed:
            raise MetricsTPUUserError(
                "a windowed fleet is driven through FleetEngine.ingest(): pane rotations fire at shared-plan "
                "positions, and a direct submit() has no plan cursor to rotate against — drive the shared global "
                "plan through ingest() on every host")
        if self._fcfg.num_streams is not None:
            sid = int(args[0])
            if sid % self._H != self._pid:
                raise FleetTopologyError(
                    f"stream {sid} homes on host {sid % self._H} (sid % num_hosts), not this host {self._pid}: "
                    "route it to its home host's ingestion pipeline (or drive the shared plan through "
                    "FleetEngine.ingest, which skips foreign batches)")
        self._engine.submit(*args, **kwargs)

    def ingest(self, *args: Any, **kwargs: Any) -> bool:
        """Drive one batch of the SHARED plan through this host: submitted
        when homed here (stream home, or plan position for one
        accumulation); the global cursor always advances, a pane rotation
        and then a cut firing at their shared-plan positions. Returns True
        when the batch was submitted here."""
        pos = self._global_cursor
        if self._fcfg.num_streams is not None:
            owned = int(args[0]) % self._H == self._pid
        else:
            owned = pos % self._H == self._pid
        if owned:
            self._engine.submit(*args, **kwargs)
        self._engine.stats.record_fleet_ingest(owned)
        self._global_cursor = pos + 1
        # rotation before the cut at one position: a boundary piece carries
        # the post-rotation ring, so a restore never rotates it again
        if self._pane_batches > 0 and self._global_cursor % self._pane_batches == 0:
            self._engine.rotate_pane()
        every = int(self._fcfg.snapshot_every)
        if every > 0 and self._global_cursor % every == 0:
            self.fleet_snapshot()
        return owned

    def flush(self) -> None:
        """Host-local flush (no collective)."""
        self._engine.flush()

    def reset(self) -> None:
        """Host-local fresh accumulation (captured steps kept) and fresh
        plan and cut cursors; hosts reset at the same plan point."""
        self._engine.reset()
        self._global_cursor = 0
        self._next_cut = 0

    # --------------------------------------------------------------- the fold

    def _fold(self, host_tree: Any) -> Any:
        """The global logical state: this host's tree through one fused
        ``sync_states`` bundle over the fleet's group."""
        group = self._mesh.group
        if isinstance(group, MeshAxis):
            return self._metric.sync_states([host_tree], group)[0]
        return self._metric.sync_states(host_tree, group)

    def _values_of(self, merged: Any) -> Any:
        """The metric's values of a folded global state: a tumbling ring's
        open pane, a sliding ring's live panes folded, each stream's value
        batched under ``vmap``."""
        eng = self._engine
        with traced_rows():
            if self._windowed and eng._window.kind == "tumbling":
                merged = tree_map(lambda x: x[int(eng._pane_cursor)], merged)
            elif self._windowed:
                merged = self._metric.merge_stacked_states(merged)
            if self._fcfg.num_streams is not None:
                return torch.func.vmap(self._metric.compute_from)(merged)
            return self._metric.compute_from(merged)

    def _finish_device(self) -> None:
        if self._fleet_device.type == "cuda":
            torch.cuda.current_stream(self._fleet_device).synchronize()

    def _fleet_payload_split(self) -> Tuple[int, int]:
        """(exact, quantized) bytes one host contributes to a fold: the
        engine's accounting at world = the host count over its host-logical
        leaves (stream-, pane- and paged-form scaled)."""
        if self._payload_split is None:
            self._payload_split = self._engine._payload_split_for(
                self._H, leaf_info=self._engine._fleet_leaf_info())
        return self._payload_split

    def _fleet_intra_bytes(self) -> int:
        """Bytes of the host-local logical tree a fold reads before anything
        leaves the host: the hierarchical fold's intra leg."""
        if self._intra_bytes is None:
            info = self._engine._fleet_leaf_info() or []
            self._intra_bytes = hierarchical_fold_bytes(info, self._H)["intra_bytes"]
        return self._intra_bytes

    def _refresh_tenancy(self) -> None:
        """The pager's residency and spill gauges into the fleet block (the
        paged form only)."""
        if not getattr(self._engine, "_stream_shard", False):
            return
        t = self._engine._pager.tenancy_stats()
        self._engine.stats.record_fleet_tenancy(t["resident_rows"], t["spilled_rows"], t["spill_bytes"])

    def _boundary_collective(self, program: Callable[..., Any], args: Tuple, site: str = "host_loss") -> Tuple[Any, float]:
        """One fleet collective behind the fault ``site`` (consulted before
        the dispatch, so a transient retries the whole collective; every
        host of a symmetric plan retries in lockstep) and the bounded retry;
        a non-transient ``host_loss`` becomes :class:`FleetHostLostError`.
        Returns the output and its microseconds, the device drained."""
        eng = self._engine

        def once() -> Tuple[Any, float]:
            eng._fault(site)
            t0 = time.perf_counter()
            out = program(*args)
            self._finish_device()
            return out, (time.perf_counter() - t0) * 1e6

        try:
            return eng._retry_transient(once)
        except InjectedFault as e:
            if e.site == "host_loss" and not e.transient:
                raise FleetHostLostError(
                    f"host lost at a fleet boundary (process {self._pid} of {self._H}): the host-local steady "
                    "state is intact; restore the fleet from the last consistent snapshot cut") from e
            raise

    def _record_fold(self, us: float) -> None:
        self._engine.stats.record_fleet_merge(us, *self._fleet_payload_split(),
                                              intra_bytes=self._fleet_intra_bytes())
        self._refresh_tenancy()
        tr = self._engine.trace
        if tr is not None:
            tr.complete("fleet_merge", trace=ENGINE_TRACE, dur_us=us)

    def fleet_state(self) -> Any:
        """The replicated GLOBAL logical state: a flush, then one fold of every
        host's local state. A collective boundary."""
        out, us = self._boundary_collective(self._fold, (self._engine.state(),))
        self._record_fold(us)
        return out

    def _boundary_values(self) -> Any:
        host_tree = self._engine.state()  # flushes first
        vals, us = self._boundary_collective(lambda t: self._values_of(self._fold(t)), (host_tree,))
        self._record_fold(us)
        return vals

    def result(self, stream_id: Optional[int] = None) -> Any:
        """The globally folded value on ANY host: one fold, no coordinator.
        A multi-stream fleet takes ``stream_id`` (the fold moves every
        stream either way: read many through :meth:`results`). A
        collective boundary."""
        vals = self._boundary_values()
        if self._fcfg.num_streams is None:
            if stream_id is not None:
                raise MetricsTPUUserError("stream_id is only valid for multi-stream fleets (FleetConfig.num_streams)")
            return vals
        if stream_id is None:
            raise MetricsTPUUserError("a multi-stream fleet's result() needs a stream_id (or use results() for "
                                      "every stream)")
        sid, S = int(stream_id), int(self._fcfg.num_streams)
        if not 0 <= sid < S:
            raise MetricsTPUUserError(f"stream_id {sid} out of range [0, {S})")
        return tree_map(lambda x: x[sid], vals)

    def results(self) -> Dict[int, Any]:
        """Every stream's globally folded value, on the host: one fold, one
        batched compute and one device-to-host copy for any S."""
        if self._fcfg.num_streams is None:
            raise MetricsTPUUserError("results() is the multi-stream surface; single-metric fleets read result()")
        S = int(self._fcfg.num_streams)
        return dict(enumerate(_values_to_host(self._boundary_values(), S)))

    # ------------------------------------------------------------------- snapshots

    def _barrier_program(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """The cut barrier's collective: each host's ``(1,)`` int32 cut cursor
        in, every host's cursor out (one ``all_gather``; the agreement check
        is on the host)."""
        group = self._mesh.group
        if isinstance(group, MeshAxis):
            return lambda x: mesh_all_gather_tiled([x], group)[0]
        return lambda x: all_gather_cat(x, group)

    def _barrier(self, cut: int) -> None:
        x = torch.tensor([int(cut)], dtype=torch.int32, device=self._fleet_device)
        out, _us = self._boundary_collective(self._barrier_program(), (x,), site="fleet_barrier")
        gathered = np.asarray(torch.as_tensor(out).cpu())
        if not bool(np.all(gathered == int(cut))):
            raise FleetBarrierError(
                f"hosts disagree on the snapshot cut cursor: this host presented cut {int(cut)} but the barrier "
                f"gathered {gathered.tolist()} — the ingest plans have diverged; no generation was written")
        self._engine.stats.record_fleet_barrier()

    def fleet_snapshot(self, cut: Optional[int] = None) -> str:
        """Write this host's piece of consistent cut ``cut`` (default: the next
        index): a local flush, the cut barrier, the piece through the
        engine's crash-safe snapshot stamped with the topology and the cut,
        then the fsynced cut marker. The cut is consistent once every host's
        marker lands. A collective boundary."""
        if not self._host_dir:
            raise MetricsTPUUserError("fleet_snapshot() requires FleetConfig.snapshot_dir")
        k = self._next_cut if cut is None else int(cut)
        if k < 0:
            raise MetricsTPUUserError(f"cut must be >= 0, got {k}")
        self._engine.flush()
        self._barrier(k)
        eng = self._engine
        eng._fleet_cut = k
        eng._fleet_plan_cursor = self._global_cursor
        try:
            path = eng.snapshot()
        finally:
            eng._fleet_cut = None
        os.makedirs(self._host_dir, exist_ok=True)
        marker = os.path.join(self._host_dir, f"fleet_cut_{k:06d}")
        tmp = marker + ".tmp"
        with open(tmp, "w") as f:
            f.write(os.path.basename(path))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, marker)
        self._next_cut = k + 1
        eng.stats.record_fleet_cut()
        return path

    def restore(self) -> Dict[str, Any]:
        """Resume this host from the last CONSISTENT cut: every host derives
        the same cut from the shared directory, agrees on it through the
        barrier and restores its own piece verbatim; replay the plan from
        ``meta["fleet_plan_cursor"]``."""
        if not self._fcfg.snapshot_dir:
            raise MetricsTPUUserError("restore() requires FleetConfig.snapshot_dir")
        k = last_consistent_cut(self._fcfg.snapshot_dir, self._H)
        if k is None:
            raise FileNotFoundError(f"no consistent fleet snapshot cut under {self._fcfg.snapshot_dir!r}")
        self._barrier(k)
        name = _host_cuts(self._host_dir).get(k)
        if name is None:  # pragma: no cover - the consistency scan guarantees it
            raise FleetTopologyError(f"host {self._pid} has no piece for consistent cut {k}")
        meta = self._engine.restore(os.path.join(self._host_dir, name))
        snap_cut = int(meta.get("fleet_cut", -1))
        if snap_cut != k:
            raise FleetTopologyError(
                f"host {self._pid}'s piece for cut {k} carries fleet_cut={snap_cut} — the marker and the snapshot "
                "disagree; the fleet dir is torn")
        self._global_cursor = int(meta.get("fleet_plan_cursor", 0))
        self._next_cut = k + 1
        return meta

    def adopt_single(self, path_or_dir: str) -> Dict[str, Any]:
        """Seat a SINGLE-PROCESS snapshot in this fleet: host 0 takes its
        state, every other host resets to init, so the fold reproduces the
        adopted value exactly. A fleet piece is refused (see
        :meth:`restore`). Every host calls."""
        state, meta = load_snapshot(path_or_dir, fallback=True)
        snap_hosts = int(meta.get("num_hosts", 1) or 1)
        if snap_hosts != 1:
            raise FleetTopologyError(
                f"adopt_single() takes a single-process snapshot; this one is host {meta.get('process_id')} of a "
                f"{snap_hosts}-host fleet — restore fleet pieces through FleetEngine.restore()")
        if self._pid == 0:
            patched = dict(meta, num_hosts=self._H, process_id=0)
            self._engine._restore_commit(state, patched)
        else:
            self._engine.reset()
        self._global_cursor = 0
        self._next_cut = 0
        return meta

    # ------------------------------------------------------------------- telemetry

    def telemetry(self) -> Dict[str, Any]:
        """The local engine's telemetry; its summary carries the ``fleet``
        block."""
        self._refresh_tenancy()
        return self._engine.telemetry()

    def export_telemetry(self, path: str) -> None:
        self._engine.export_telemetry(path)

    def metrics_text(self) -> str:
        """OpenMetrics: the local engine's exposition plus the ``host``- and
        ``leg``-labelled fleet families (a single-process engine emits none)."""
        self._refresh_tenancy()
        base = self._engine.metrics_text()
        st = self._engine.stats
        h = str(self._pid)
        cross = st.fleet_payload_exact_bytes + st.fleet_payload_quant_bytes
        labeled = {
            "fleet_ingested": ("host", {h: st.fleet_ingested}),
            "fleet_skipped": ("host", {h: st.fleet_skipped}),
            "fleet_merges": ("host", {h: st.fleet_merges}),
            "fleet_barriers": ("host", {h: st.fleet_barriers}),
            "fleet_snapshot_cuts": ("host", {h: st.fleet_cuts}),
            "fleet_sync_payload_bytes": ("host", {h: cross}),
            # the hierarchical fold by leg: intra scales with residency, cross with hosts
            "fleet_payload_bytes": ("leg", {"intra": st.fleet_payload_intra_bytes, "cross": cross}),
        }
        gauges = {
            "fleet_num_hosts": self._H,
            "fleet_process_id": self._pid,
            "fleet_streams_owned": st.fleet_streams_owned,
            "fleet_spill_rows": st.fleet_spill_rows,
            "fleet_spill_bytes": st.fleet_spill_bytes,
            "fleet_resident_rows": st.fleet_resident_rows,
        }
        fleet_text = render_openmetrics({}, (), labeled_counters=labeled, gauges=gauges)
        if not base.endswith("# EOF\n"):  # pragma: no cover - render_openmetrics always terminates
            raise RuntimeError("the engine's exposition lacks its # EOF terminator")
        return base[: -len("# EOF\n")] + fleet_text


def _piece_logical(engine: Any, state: Any, meta: Dict[str, Any], pid: int) -> Any:
    """One host piece's LOGICAL state tree, as the target engine's metric
    lays it out: a paged piece reassembled from resident, spilled and init
    rows; a codec-wrapped one decoded; a deferred one's shard axis folded."""
    metric = engine._metric
    if bool(int(meta.get("stream_shard", 0) or 0)):
        if str(meta.get("codec", "") or "") and str(meta.get("codec_fp", "") or "") != engine._precision_tag:
            raise MetricsTPUUserError(
                f"compressed stream-shard fleet piece was written under sync_precision policy "
                f"{meta.get('codec_fp')!r}, the target engine's metric declares {engine._precision_tag!r}; restore "
                "with the matching policy")
        return MultiStreamEngine.sshard_piece_logical(metric, state, meta)
    if str(meta.get("codec", "") or ""):
        state = decode_state_tree(state)
    state = tree_map(lambda x: _tensor_from_numpy(x) if isinstance(x, np.ndarray) else x, state)
    packed = bool(int(meta.get("packed", 0)))
    if packed:
        if engine._layout is None:
            raise MetricsTPUUserError("fleet piece holds a packed arena but the target engine runs use_arena=False")
        saved_fp = str(meta.get("arena_fp", "") or "")
        if saved_fp and saved_fp != engine._layout.fingerprint():
            raise MetricsTPUUserError(
                f"host {pid}'s arena layout does not match the target metric's — was the metric reconfigured "
                "since the snapshot?")
    if str(meta.get("mesh_sync", "") or "") == "deferred":
        lead = 2 if engine._win_stacked else 1
        stacked = engine._layout.unpack_stacked(state, lead=lead) if packed else state
        return metric.merge_stacked_states(stacked)
    return engine._unpack(state) if packed else state


def restore_fleet_into(engine: Any, fleet_dir: str) -> Dict[str, Any]:
    """Merge a whole fleet snapshot into ONE single-process engine: every
    host's piece at the last consistent cut, folded through
    ``merge_stacked_states`` (the hosts stacked on a leading axis, each
    state by its own reduction) and committed through the engine's restore
    path. The merged engine's value equals the fleet's at the cut; the
    returned meta's ``batches_done`` sums the hosts' cursors and is no
    replay cursor (replay is the fleet's own restore).

    Typed refusals: a fleet-managed target, pieces of another host count
    (:func:`last_consistent_cut`), pieces whose metas disagree with their
    directory or whose pane rings differ, and states with no stacked merge.
    """
    if getattr(engine, "_fleet_hosts", 1) != 1:
        raise FleetTopologyError(
            f"restore_fleet_into() targets a SINGLE-PROCESS engine; this one is host {engine._fleet_pid} of "
            f"{engine._fleet_hosts} — use FleetEngine.restore()")
    dirs = _host_dirs(fleet_dir)
    if not dirs:
        raise FileNotFoundError(f"no host pieces under {fleet_dir!r}")
    H = len(dirs)
    k = last_consistent_cut(fleet_dir, H)
    if k is None:
        raise FileNotFoundError(f"no consistent fleet snapshot cut under {fleet_dir!r}")
    metric = engine._metric
    reason = metric.stacked_merge_unsupported_reason()
    if reason is not None:
        raise MetricsTPUUserError(f"fleet snapshot cannot merge into a single engine: {reason}")
    logicals: List[Any] = []
    metas: List[Dict[str, Any]] = []
    for pid in range(H):
        state, meta = load_snapshot(os.path.join(dirs[pid], _host_cuts(dirs[pid])[k]))
        if int(meta.get("num_hosts", 1) or 1) != H or int(meta.get("process_id", 0) or 0) != pid:
            raise FleetTopologyError(
                f"piece under host_{pid:03d} claims num_hosts={meta.get('num_hosts')} "
                f"process_id={meta.get('process_id')} — the fleet dir is inconsistent with its pieces")
        if int(meta.get("fleet_cut", -1)) != k:
            raise FleetTopologyError(
                f"host {pid}'s piece for cut {k} carries fleet_cut={meta.get('fleet_cut')} — marker and snapshot "
                "disagree")
        logicals.append(tree_map(lambda x: torch.as_tensor(x).cpu(), _piece_logical(engine, state, meta, pid)))
        metas.append(meta)
    if str(metas[0].get("window", "") or ""):
        # every piece of a windowed fleet rotated at the same plan positions
        rings = {(str(m.get("window", "") or ""), int(m.get("pane_cursor", 0) or 0), int(m.get("rotations", 0) or 0))
                 for m in metas}
        if len(rings) > 1:
            raise FleetTopologyError(
                f"host pieces disagree on the pane ring {sorted(rings)} — fleet rotations are plan-consistent by "
                "contract, so the fleet dir is torn; restore a consistent cut with FleetEngine.restore()")
    flat = [tree_flatten(t) for t in logicals]
    stacked = tree_unflatten(flat[0][1], [torch.stack(xs) for xs in zip(*(leaves for leaves, _ in flat))])
    merged = metric.merge_stacked_states(stacked)
    out_meta = dict(metas[0])
    out_meta.update(
        num_hosts=1, process_id=0, packed=0, mesh_sync="single", world=1, codec="", arena_fp="", stream_shard=0,
        resident=0,
        step=sum(int(m.get("step", 0)) for m in metas),
        batches_done=sum(int(m.get("batches_done", 0)) for m in metas),
        rows_in=sum(int(m.get("rows_in", 0)) for m in metas),
        rows_padded=sum(int(m.get("rows_padded", 0)) for m in metas),
        fleet_cut=k,
        merged_from_hosts=H,
    )
    engine._restore_commit(merged, out_meta)
    return out_meta
