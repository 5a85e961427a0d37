"""Multi-host fleet serving, port of ``metrics_tpu/engine/fleet``.

:mod:`~metrics_tpu_torch.engine.fleet.runtime`: :class:`FleetConfig` and
:class:`FleetEngine`, per-host ingestion through the port's engines with a
collective-free steady state, boundary folds over a ``torch.distributed``
group, the cut-barrier snapshot protocol and the fleet/single-process
restore matrix.

:mod:`~metrics_tpu_torch.engine.fleet.harness`: the two-process harness
(``python -m metrics_tpu_torch.engine.fleet.harness``), gloo over local
sockets, held against a single-process engine, with kill-one-host, restore
and replay.
"""
from metrics_tpu_torch.engine.fleet.runtime import (
    FleetBarrierError,
    FleetConfig,
    FleetEngine,
    FleetHostLostError,
    FleetTopologyError,
    fleet_mesh,
    last_consistent_cut,
    restore_fleet_into,
)

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
