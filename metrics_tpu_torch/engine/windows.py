"""Windowed and time-decayed metric semantics: the pane-ring window policy.

Port of ``metrics_tpu/engine/windows.py``. Every engine serves
cumulative-since-reset state by default; a :class:`WindowPolicy` asks for
"AUROC over the last hour" instead: tumbling and sliding pane rings, an
exponentially decayed accumulator, and drift alarms over the closed panes
(``engine/tracker.py``). This module holds the POLICY and its eligibility
rules; the mechanics live in ``engine/pipeline.py`` and
``engine/multistream.py``.

* **Ring of arenas.** A tumbling or sliding engine's carried state gains a
  leading PANE axis: each per-dtype arena buffer becomes ``(panes, n)``. A
  step writes ONE pane row, a contiguous view of those buffers: the captured
  step is the cumulative engine's graph, and the engine hands it the current
  pane's row, so a rotation changes which row is passed and never captures.
* **Exact pane folds.** ``result()`` of a sliding ring folds the live panes
  through ``merge_stacked_states`` (sum/min/max elementwise, ``cat`` capacity
  buffers concatenated across panes); a tumbling ring reads the open pane.
* **EWMA.** ``ewma(alpha)`` keeps one accumulator and scales every state by
  ``1 - alpha`` at each rotation (sum-reducible float states only, refused
  at construction otherwise).
* **Window x stream.** On the unsharded ``MultiStreamEngine`` the pane axis
  stacks outside the stream axis; under ``stream_shard=True`` the pane
  extends the pager's stream coordinate (``stream * panes + pane``), so cold
  panes spill through the pager and a rotation moves no bytes on the device.

Rotation cadence is ``pane_batches`` (replay-cursor batches: exact under
kill/resume) or ``pane_seconds`` through the injectable ``clock``. A
coalesced group never crosses a batch-cadence pane boundary. Snapshots carry
the policy's :meth:`WindowPolicy.fingerprint`, and a restore under another
policy is refused; the fingerprint is the JAX package's string, byte for
byte, so windowed snapshots cross between the packages.
"""
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

__all__ = ["WINDOW_KINDS", "WindowPolicy"]

WINDOW_KINDS = ("cumulative", "tumbling", "sliding", "ewma")


def _dtype_name(dtype: Any) -> str:
    """A torch dtype as numpy and JAX name it (``int32``, ``bool``)."""
    return str(dtype).replace("torch.", "")


@dataclass
class WindowPolicy:
    """Declarative window semantics for a streaming engine.

    Args:
        kind: one of :data:`WINDOW_KINDS`.

            * ``"cumulative"`` — the identity policy (since-reset, the
              engine's historical behavior; no pane axis, no rotation).
            * ``"tumbling"`` — the ring holds ``n_panes`` panes; ``result()``
              reads the CURRENT pane only (bit-identical to a fresh engine
              fed that pane's batches); rotation advances the cursor and
              init-fills the incoming pane.
            * ``"sliding"`` — ``result()`` folds the LIVE pane set — the
              open pane plus the ``n_panes - 1`` most recent closed panes
              (the incoming slot clears at each boundary, evicting the
              oldest pane) — via ``merge_stacked_states``: "over the last
              ``n_panes`` x cadence", counting the partially-filled open
              pane.
            * ``"ewma"`` — one accumulator; each rotation scales every state
              by ``1 - alpha`` (sum-reducible float states only, refused
              loudly otherwise). A ratio metric's numerator and denominator
              decay together, so the computed value is the exponentially
              weighted average of the per-pane values.
        pane_batches: rotation cadence in submitted batches (the replay
            cursor — exact under kill/resume and coalescing). Exactly one of
            ``pane_batches``/``pane_seconds`` must be set for rotating kinds.
        pane_seconds: rotation cadence in seconds of the injectable ``clock``.
        n_panes: live panes in the ring (tumbling >= 1, sliding >= 2).
        alpha: EWMA new-data weight in (0, 1); the per-rotation decay applied
            to the carried state is ``1 - alpha``.
        clock: injectable time source for ``pane_seconds`` (default
            ``time.monotonic``); deterministic tests and the windows smoke
            drive rotations through it.
    """

    kind: str = "cumulative"
    pane_batches: int = 0
    pane_seconds: float = 0.0
    n_panes: int = 1
    alpha: float = 0.0
    clock: Optional[Callable[[], float]] = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.kind not in WINDOW_KINDS:
            raise ValueError(
                f"window kind must be one of {WINDOW_KINDS}, got {self.kind!r}"
            )
        self.pane_batches = int(self.pane_batches)
        self.pane_seconds = float(self.pane_seconds)
        self.n_panes = int(self.n_panes)
        self.alpha = float(self.alpha)
        if self.kind == "cumulative":
            if self.pane_batches or self.pane_seconds or self.alpha or self.n_panes != 1:
                raise ValueError(
                    "cumulative windows take no cadence/pane/alpha parameters "
                    "(they ARE the engine's default since-reset semantics)"
                )
            return
        has_batches, has_seconds = self.pane_batches > 0, self.pane_seconds > 0
        if has_batches == has_seconds:
            raise ValueError(
                f"{self.kind} windows need exactly one rotation cadence: "
                f"pane_batches > 0 XOR pane_seconds > 0 "
                f"(got pane_batches={self.pane_batches}, pane_seconds={self.pane_seconds})"
            )
        if self.pane_batches < 0 or self.pane_seconds < 0:
            raise ValueError("rotation cadence must be positive")
        if self.kind == "ewma":
            if not (0.0 < self.alpha < 1.0):
                raise ValueError(f"ewma needs 0 < alpha < 1, got {self.alpha}")
            if self.n_panes != 1:
                raise ValueError("ewma carries one accumulator; n_panes must be 1")
            return
        if self.alpha:
            raise ValueError(f"{self.kind} windows take no alpha")
        if self.kind == "sliding" and self.n_panes < 2:
            raise ValueError(
                f"sliding windows need n_panes >= 2 (a 1-pane slide is tumbling), "
                f"got {self.n_panes}"
            )
        if self.kind == "tumbling" and self.n_panes < 1:
            raise ValueError(f"tumbling windows need n_panes >= 1, got {self.n_panes}")

    # ------------------------------------------------------------- constructors

    @classmethod
    def cumulative(cls) -> "WindowPolicy":
        return cls(kind="cumulative")

    @classmethod
    def tumbling(
        cls,
        pane_batches: int = 0,
        pane_seconds: float = 0.0,
        n_panes: int = 1,
        clock: Optional[Callable[[], float]] = None,
    ) -> "WindowPolicy":
        return cls(
            kind="tumbling", pane_batches=pane_batches, pane_seconds=pane_seconds,
            n_panes=n_panes, clock=clock,
        )

    @classmethod
    def sliding(
        cls,
        n_panes: int,
        pane_batches: int = 0,
        pane_seconds: float = 0.0,
        clock: Optional[Callable[[], float]] = None,
    ) -> "WindowPolicy":
        return cls(
            kind="sliding", pane_batches=pane_batches, pane_seconds=pane_seconds,
            n_panes=n_panes, clock=clock,
        )

    @classmethod
    def ewma(
        cls,
        alpha: float,
        pane_batches: int = 0,
        pane_seconds: float = 0.0,
        clock: Optional[Callable[[], float]] = None,
    ) -> "WindowPolicy":
        return cls(
            kind="ewma", alpha=alpha, pane_batches=pane_batches,
            pane_seconds=pane_seconds, clock=clock,
        )

    # ------------------------------------------------------------------ queries

    @property
    def stacked(self) -> bool:
        """Whether this policy carries a pane AXIS on the state (tumbling and
        sliding rings); ewma decays one accumulator in place and cumulative
        is the identity."""
        return self.kind in ("tumbling", "sliding")

    @property
    def panes(self) -> int:
        """Leading pane-axis length of the carried state (1 when unstacked)."""
        return self.n_panes if self.stacked else 1

    @property
    def decay(self) -> float:
        """The per-rotation scale EWMA applies to every state (``1 - alpha``)."""
        return 1.0 - self.alpha

    def time_source(self) -> Callable[[], float]:
        return self.clock if self.clock is not None else time.monotonic

    def fingerprint(self) -> str:
        """Canonical policy tag: folded into every AOT program key (two
        policies over identical state signatures lower different fold/rotate
        programs) and into snapshot meta (the cross-policy restore refusal —
        a pane ring is only replayable under the policy that built it). The
        clock is deliberately EXCLUDED: it is an injection seam, not
        semantics."""
        if self.kind == "cumulative":
            return "cumulative"
        cadence = (
            f"b{self.pane_batches}" if self.pane_batches > 0
            else f"s{self.pane_seconds:g}"
        )
        if self.kind == "ewma":
            return f"ewma:a{self.alpha:g}:{cadence}"
        return f"{self.kind}:p{self.n_panes}:{cadence}"

    # -------------------------------------------------------------- eligibility

    def unsupported_reason(self, metric: Any, mesh_deferred: bool = False) -> Optional[str]:
        """None when ``metric`` can serve under this policy, else a loud
        human-readable reason (the engine refuses at CONSTRUCTION — a wrong
        window fold must never be discovered in production results).

        * ewma: every state leaf must reduce with ``sum`` AND be floating —
          the decay is a scalar multiply, exact only for linear (sum) folds,
          and an int counter cannot carry a fraction of itself.
        * sliding: the pane fold is ``merge_stacked_states``, so every state
          needs a canonical stacked merge (sum/min/max/cat fixed arrays).
        * stacked windows under DEFERRED mesh sync: ``cat`` states are
          refused — the world boundary merge flattens the shard axis into
          dim 0 of every cat buffer, which under a pane ring is the PANE
          axis, and the interleaving would scramble pane provenance.
        """
        if self.kind == "cumulative":
            return None
        if self.kind == "ewma":
            info_fn = getattr(metric, "sync_leaf_info", None)
            if info_fn is None:
                return "metric does not expose sync_leaf_info (no per-state reductions to check)"
            for fx, leaf, _prec in info_fn():
                if fx != "sum":
                    return (
                        f"ewma decays are exact only for sum-reducible states; found a "
                        f"state with dist_reduce_fx={fx!r} (min/max/cat states have no "
                        "linear decay)"
                    )
                if not leaf.dtype.is_floating_point:
                    return (
                        f"ewma decay needs floating states; found a {_dtype_name(leaf.dtype)} "
                        "sum state (an integer counter cannot carry a fractional decay — "
                        "serve it tumbling/sliding, or use a float-state metric like MeanMetric)"
                    )
            return None
        # stacked (tumbling / sliding) rings
        if self.kind == "sliding":
            r = (
                metric.stacked_merge_unsupported_reason()
                if hasattr(metric, "stacked_merge_unsupported_reason")
                else "metric has no stacked merge (merge_stacked_states)"
            )
            if r is not None:
                return f"sliding folds live panes via merge_stacked_states: {r}"
        if mesh_deferred:
            info_fn = getattr(metric, "sync_leaf_info", None)
            if info_fn is not None and any(fx == "cat" for fx, _l, _p in info_fn()):
                return (
                    "windowed serving under deferred mesh sync refuses cat/scan-strategy "
                    "states: the world boundary merge flattens the shard axis into each "
                    "cat buffer's dim 0, which a pane ring uses for pane provenance — "
                    "serve cat-state metrics windowed on a single device"
                )
        return None

    def fleet_unsupported_reason(self, metric: Any) -> Optional[str]:
        """None when ``metric`` can serve under this policy ACROSS A FLEET,
        else a loud reason naming the sanctioned alternative. The
        fleet contract is strictly narrower than single-process serving: a
        pane rotation must land at a FLEET-CONSISTENT cut boundary (the
        shared plan cursor), so only the replay-cursor cadence qualifies, and
        the boundary fold crosses hosts, so cat states hit the same
        pane-provenance scramble the deferred-mesh check refuses.

        * ``pane_seconds``/wall-clock cadence: each host's clock would rotate
          at a different batch position — no fleet-consistent cut, replay
          non-deterministic. Use ``pane_batches`` (exact under the shared
          plan cursor), or serve time-cadence windows single-process.
        * ewma: the decay is a per-host in-place scale with no cut-aligned
          structure event the fleet protocol can order against the fold —
          serve ewma single-process, or tumbling/sliding in the fleet.
        * cat/scan-strategy states: the hierarchical fleet fold stacks host
          pieces on dim 0 of every cat buffer — the pane axis under a ring —
          scrambling pane provenance. Serve cat-state metrics windowed
          single-process, or cumulative in the fleet.
        """
        if self.kind == "cumulative":
            return None
        if self.kind == "ewma":
            return (
                "ewma has no fleet-consistent rotation boundary (the decay is a "
                "per-host in-place scale, not a cut-aligned structure event) — "
                "serve ewma single-process, or tumbling/sliding in the fleet"
            )
        if self.pane_batches <= 0:
            return (
                "fleet pane rotation must ride the shared plan cursor "
                "(pane_batches cadence): a wall-clock cadence rotates each host "
                "at a different batch position with no fleet-consistent cut — "
                "use WindowPolicy with pane_batches, or serve time-cadence "
                "windows single-process"
            )
        if self.kind == "sliding":
            r = (
                metric.stacked_merge_unsupported_reason()
                if hasattr(metric, "stacked_merge_unsupported_reason")
                else "metric has no stacked merge (merge_stacked_states)"
            )
            if r is not None:
                return f"sliding folds live panes via merge_stacked_states: {r}"
        info_fn = getattr(metric, "sync_leaf_info", None)
        if info_fn is not None and any(fx == "cat" for fx, _l, _p in info_fn()):
            return (
                "windowed fleet serving refuses cat/scan-strategy states: the "
                "hierarchical fleet fold stacks host pieces into each cat "
                "buffer's dim 0, which a pane ring uses for pane provenance — "
                "serve cat-state metrics windowed single-process, or cumulative "
                "in the fleet"
            )
        return None

    # ----------------------------------------------------------------- rotation

    def rotations_due(
        self,
        batches_done: int,
        last_rotate_batches: int,
        now: float,
        last_rotate_time: float,
    ) -> int:
        """How many rotations the cadence owes at this batch boundary (0 in
        the steady interior of a pane). Batch cadence is a pure function of
        the replay cursor — kill/resume replays rotations at identical
        boundaries; time cadence reads the injectable clock."""
        if self.kind == "cumulative":
            return 0
        if self.pane_batches > 0:
            return max(0, (batches_done - last_rotate_batches) // self.pane_batches)
        if self.pane_seconds > 0 and now >= last_rotate_time + self.pane_seconds:
            return int((now - last_rotate_time) // self.pane_seconds)
        return 0
