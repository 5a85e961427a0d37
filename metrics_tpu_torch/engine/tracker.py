"""Drift tracking over per-pane results: the serving-side MetricTracker.

Port of ``metrics_tpu/engine/tracker.py``. A windowed engine
(``engine/windows.py``) yields one result per closed pane;
:class:`DriftDetector` consumes that sequence and answers "has this metric
drifted?".

* **Pure in the value sequence.** ``record()`` reads no clock and no thread
  state: the alarm/clear transitions are a function of the recorded values
  alone, so seeded runs replay the same alarm list, in either package.
* **Hysteresis.** A deviation has to persist ``up_after`` consecutive panes
  to RAISE and stay inside the band ``down_after`` consecutive panes to
  CLEAR, the streak vocabulary of the degradation ladder.
* **Typed.** Every transition is a :class:`DriftAlarm`; with
  ``raise_on_alarm=True`` a RAISE also raises :class:`DriftAlarmError`
  (standalone use; an engine refuses it, since its dispatcher thread
  records, and surfaces alarms as ``drift_alarm`` trace events and the
  ``drift_alarms`` OpenMetrics counter instead).

Standalone use::

    det = DriftDetector(threshold=0.1, up_after=2)
    for pane, value in enumerate(pane_results):
        for alarm in det.record(value, pane=pane):
            print(alarm.describe())

Engine wiring: ``EngineConfig(window=..., drift=DriftDetector(...))``: the
dispatcher evaluates the CLOSING pane's result at every rotation (the
``drift_eval`` fault site; the evaluation is a pure read, so a transient
retries cleanly and the detector records exactly once).
"""
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["DriftAlarm", "DriftAlarmError", "DriftDetector"]

_BASELINES = ("first", "prev", "mean")


def _host_array(value: Any) -> Any:
    """``value`` as a host numpy array (a tensor leaves its device first)."""
    import numpy as np
    import torch

    if isinstance(value, torch.Tensor):
        t = value.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(value)


@dataclass(frozen=True)
class DriftAlarm:
    """One hysteresis transition of one tracked series.

    ``kind`` is ``"raise"`` (the deviation persisted ``up_after`` panes) or
    ``"clear"`` (back inside the band for ``down_after`` panes). ``key`` is
    the caller's series key (stream id for multi-stream engines, None for a
    single-stream engine); ``name`` the metric name inside a collection
    result ("" for scalar results). ``value``/``baseline``/``delta`` are the
    observation that completed the streak."""

    kind: str
    key: Optional[int]
    name: str
    pane: Optional[int]
    value: float
    baseline: float
    delta: float
    streak: int

    def describe(self) -> str:
        where = f"stream {self.key} " if self.key is not None else ""
        label = f"{self.name} " if self.name else ""
        return (
            f"drift {self.kind}: {where}{label}pane={self.pane} value={self.value:g} "
            f"baseline={self.baseline:g} delta={self.delta:+g} after {self.streak} panes"
        )


class DriftAlarmError(RuntimeError):
    """A raised drift alarm (``raise_on_alarm=True`` standalone mode). Carries
    the typed :class:`DriftAlarm` on ``.alarm``."""

    def __init__(self, alarm: DriftAlarm):
        self.alarm = alarm
        super().__init__(alarm.describe())


@dataclass
class _Series:
    history: List[float] = field(default_factory=list)
    first_value: float = 0.0
    running_sum: float = 0.0   # sum of ALL recorded panes (not history-bounded)
    count: int = 0             # panes recorded so far
    streak_out: int = 0
    streak_in: int = 0
    alarmed: bool = False


class DriftDetector:
    """Hysteresis-guarded drift alarms over a stream of per-pane results.

    Args:
        threshold: absolute deviation from the baseline that counts as "out
            of band" (per series).
        up_after: consecutive out-of-band panes before a RAISE transition.
        down_after: consecutive in-band panes before a CLEAR transition.
        baseline: what the deviation is measured against —

            * ``"first"`` — the series' first recorded pane (a fixed
              reference distribution);
            * ``"prev"`` — the previous pane (rate-of-change drift);
            * ``"mean"`` — the running mean of all panes recorded BEFORE the
              current one (a slowly adapting reference).
        min_panes: panes a series must have recorded before deviations start
            counting (warmup; the baseline needs at least one pane anyway).
        max_history: per-series pane values retained for :meth:`history`
            (oldest dropped; counters and baselines are unaffected — the
            running mean is O(1), not a window over this buffer).
        raise_on_alarm: raise :class:`DriftAlarmError` on RAISE transitions
            (standalone use only — keep False inside an engine).
    """

    def __init__(
        self,
        threshold: float,
        up_after: int = 2,
        down_after: int = 2,
        baseline: str = "first",
        min_panes: int = 1,
        max_history: int = 256,
        raise_on_alarm: bool = False,
    ):
        if threshold <= 0:
            raise ValueError(f"threshold must be positive, got {threshold}")
        if up_after < 1 or down_after < 1:
            raise ValueError(
                f"up_after/down_after must be >= 1, got {up_after}/{down_after}"
            )
        if baseline not in _BASELINES:
            raise ValueError(f"baseline must be one of {_BASELINES}, got {baseline!r}")
        if min_panes < 1:
            raise ValueError(f"min_panes must be >= 1, got {min_panes}")
        if max_history < 1:
            raise ValueError(f"max_history must be >= 1, got {max_history}")
        self.threshold = float(threshold)
        self.up_after = int(up_after)
        self.down_after = int(down_after)
        self.baseline = baseline
        self.min_panes = int(min_panes)
        self.max_history = int(max_history)
        self.raise_on_alarm = bool(raise_on_alarm)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[Optional[int], str], _Series] = {}
        self._alarms: List[DriftAlarm] = []
        self.evals = 0

    # ------------------------------------------------------------------ recording

    @staticmethod
    def _flatten(value: Any) -> Dict[str, float]:
        """One pane result -> named scalar series. Collections record one
        series per member; scalar results record the anonymous series ``""``.
        Non-scalar (curve/array) members are skipped: drift over a curve
        needs a scalar projection the caller owns. Tensors are read on the
        host (a bf16 value widens exactly)."""
        if isinstance(value, dict):
            out: Dict[str, float] = {}
            for k, v in value.items():
                arr = _host_array(v)
                if arr.ndim == 0:
                    out[str(k)] = float(arr)
            return out
        arr = _host_array(value)
        return {"": float(arr)} if arr.ndim == 0 else {}

    def record(
        self, value: Any, key: Optional[int] = None, pane: Optional[int] = None
    ) -> List[DriftAlarm]:
        """Record one closed pane's result for series ``key``; returns the
        hysteresis transitions (possibly empty) this pane completed, in
        series order. Deterministic in the value sequence; thread-safe."""
        transitions: List[DriftAlarm] = []
        flat = self._flatten(value)
        with self._lock:
            self.evals += 1
            for name, v in flat.items():
                s = self._series.setdefault((key, name), _Series())
                base: Optional[float] = None
                if s.count >= 1:
                    if self.baseline == "first":
                        base = s.first_value
                    elif self.baseline == "prev":
                        base = s.history[-1]
                    else:  # running mean of every pane BEFORE this one, O(1)
                        base = s.running_sum / s.count
                transitions.extend(
                    self._advance(s, key, name, pane, v, base, s.count)
                )
                # commit the observation AFTER the verdict (a pane judges
                # against the baseline that preceded it)
                if s.count == 0:
                    s.first_value = v
                s.running_sum += v
                s.count += 1
                s.history.append(v)
                if len(s.history) > self.max_history:
                    del s.history[0]
            self._alarms.extend(transitions)
        if self.raise_on_alarm:
            for a in transitions:
                if a.kind == "raise":
                    raise DriftAlarmError(a)
        return transitions

    def _advance(
        self,
        s: _Series,
        key: Optional[int],
        name: str,
        pane: Optional[int],
        v: float,
        base: Optional[float],
        n_prev: int,
    ) -> List[DriftAlarm]:
        """One hysteresis step for one series (lock held)."""
        if base is None or n_prev < self.min_panes:
            return []
        delta = v - base
        out: List[DriftAlarm] = []
        if abs(delta) > self.threshold:
            s.streak_out += 1
            s.streak_in = 0
            if not s.alarmed and s.streak_out >= self.up_after:
                s.alarmed = True
                out.append(DriftAlarm(
                    kind="raise", key=key, name=name, pane=pane,
                    value=v, baseline=base, delta=delta, streak=s.streak_out,
                ))
        else:
            s.streak_in += 1
            s.streak_out = 0
            if s.alarmed and s.streak_in >= self.down_after:
                s.alarmed = False
                out.append(DriftAlarm(
                    kind="clear", key=key, name=name, pane=pane,
                    value=v, baseline=base, delta=delta, streak=s.streak_in,
                ))
        return out

    # -------------------------------------------------------------------- reading

    def alarms(self, kind: Optional[str] = None) -> List[DriftAlarm]:
        with self._lock:
            return [a for a in self._alarms if kind is None or a.kind == kind]

    def alarmed_series(self) -> List[Tuple[Optional[int], str]]:
        """Series currently in the alarmed state (the gauge surface)."""
        with self._lock:
            return sorted(
                (k for k, s in self._series.items() if s.alarmed),
                key=lambda kn: (kn[0] is not None, kn[0] if kn[0] is not None else 0, kn[1]),
            )

    def history(self, key: Optional[int] = None, name: str = "") -> List[float]:
        """The retained per-pane values of one series (the MetricTracker
        ``compute_all`` analogue, bounded by ``max_history``)."""
        with self._lock:
            s = self._series.get((key, name))
            return list(s.history) if s is not None else []

    def summary(self) -> Dict[str, Any]:
        """The drift block engine telemetry embeds (deterministic ordering)."""
        with self._lock:
            return {
                "evals": self.evals,
                "series": len(self._series),
                "alarms_raised": sum(1 for a in self._alarms if a.kind == "raise"),
                "alarms_cleared": sum(1 for a in self._alarms if a.kind == "clear"),
                "alarmed": [
                    {"key": k, "name": n}
                    for k, n in sorted(
                        (kn for kn, s in self._series.items() if s.alarmed),
                        key=lambda kn: (
                            kn[0] is not None, kn[0] if kn[0] is not None else 0, kn[1]
                        ),
                    )
                ],
                "threshold": self.threshold,
                "baseline": self.baseline,
            }

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._alarms.clear()
            self.evals = 0
