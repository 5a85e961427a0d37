"""Host-side stream paging: an LRU pager over the paged arena's slots.

Port of ``metrics_tpu/engine/paging.py``, whole: bookkeeping only (slot
tables, LRU order, the host-RAM spill store), numpy and the standard library.
The paged :class:`~metrics_tpu_torch.engine.multistream.MultiStreamEngine`
bounds device memory by the ACTIVE WORKING SET: its arena carries
``resident`` slots of per-stream state, and streams beyond that live in host
RAM as spilled per-dtype row vectors. All device I/O (reading a row out of
the arena to spill it, writing a faulted-in row back) stays in the engine;
the pager answers "which slot, and what must move". Every decision is a pure
function of the submit order.

Capacity invariant: a single routed step may touch at most ``resident``
distinct streams per shard (the engine's round builder enforces it), so
:meth:`StreamPager.plan_residency` can always seat a round — evicting only
streams the round does not need.
"""
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PageOp", "StreamPager"]


class PageOp:
    """One planned residency change on one shard.

    ``kind`` is ``"evict"`` (slot's current stream spills to host RAM) or
    ``"load"`` (``stream`` faults into ``slot`` — from its spilled row when
    one exists, else from the metric's init row). The engine executes evicts
    before loads, batched per dtype.
    """

    __slots__ = ("kind", "shard", "slot", "stream")

    def __init__(self, kind: str, shard: int, slot: int, stream: int):
        self.kind = kind
        self.shard = shard
        self.slot = slot
        self.stream = stream

    def __repr__(self) -> str:  # debugging/chaos-log aid
        return f"PageOp({self.kind}, shard={self.shard}, slot={self.slot}, stream={self.stream})"


class StreamPager:
    """Slot tables + LRU order + host-RAM spill store for ``world`` shards.

    Streams are identified by their LOCAL index on their home shard
    (``global_sid // world``); the engine owns the global→(shard, local)
    routing rule. ``resident`` is the per-shard slot count.
    """

    def __init__(self, world: int, resident: int):
        if world <= 0 or resident <= 0:
            raise ValueError(f"world and resident must be positive, got {world}, {resident}")
        self.world = int(world)
        self.resident = int(resident)
        # per shard: slot j -> local stream (or None when free)
        self._slots: List[List[Optional[int]]] = [
            [None] * self.resident for _ in range(self.world)
        ]
        # per shard: local stream -> slot, in LRU order (oldest first)
        self._lru: List["OrderedDict[int, int]"] = [OrderedDict() for _ in range(self.world)]
        # per shard: local stream -> spilled per-dtype row vectors (host numpy)
        self._spill: List[Dict[int, Dict[str, np.ndarray]]] = [
            {} for _ in range(self.world)
        ]
        # running byte total of the spill store, maintained incrementally at
        # the points rows enter/leave (commit/drop/reset/load_payload) — a
        # recount per gauge refresh would be O(spilled x dtypes) Python work
        # on every paging round, worst exactly when paging pressure is highest
        self._spill_bytes = 0

    # ------------------------------------------------------------------ queries

    def slot_of(self, shard: int, stream: int) -> Optional[int]:
        return self._lru[shard].get(stream)

    def spilled_row(self, shard: int, stream: int) -> Optional[Dict[str, np.ndarray]]:
        return self._spill[shard].get(stream)

    def resident_count(self) -> int:
        return sum(len(l) for l in self._lru)

    def spilled_count(self) -> int:
        return sum(len(s) for s in self._spill)

    def spill_nbytes(self) -> int:
        """Host-RAM bytes the spill store currently holds — the observable
        ``compress_payloads`` shrinks (rows arrive here already encoded by
        the engine's at-rest codec; the pager stores whatever per-dtype
        vectors it is handed, compressed or verbatim). O(1): maintained
        incrementally where rows enter and leave the store."""
        return self._spill_bytes

    @staticmethod
    def _row_nbytes(row: Optional[Dict[str, np.ndarray]]) -> int:
        return sum(int(v.nbytes) for v in row.values()) if row else 0

    def tenancy_stats(self) -> Dict[str, int]:
        """Resident/spilled row counts, the spill store's host-RAM bytes and
        the slot capacity: device residency stays flat while the stream
        universe grows."""
        return {
            "resident_rows": self.resident_count(),
            "spilled_rows": self.spilled_count(),
            "spill_bytes": self.spill_nbytes(),
            "capacity_rows": self.world * self.resident,
        }

    def resident_streams(self, shard: int) -> Tuple[int, ...]:
        return tuple(self._lru[shard])

    def spilled_streams(self, shard: int) -> Tuple[int, ...]:
        """Local stream coordinates currently living in the host spill store
        (sorted — deterministic enumeration for the windowed rotation's
        pane-expiry plan)."""
        return tuple(sorted(self._spill[shard]))

    def pane_expiry_plan(self, incoming: int, panes: int) -> List[Tuple[int, int]]:
        """The ``(shard, row)`` coordinates a pane rotation expires: every
        row, resident or spilled, of the INCOMING pane under the pane-extended
        coordinate ``row = stream * panes + pane``. Pure (the caller drops
        them at its commit); sorted, so a retried plan is the same list."""
        drops = []
        for shard in range(self.world):
            drops.extend((shard, r) for r in self.resident_streams(shard) if r % panes == incoming)
            drops.extend((shard, r) for r in self.spilled_streams(shard) if r % panes == incoming)
        return sorted(set(drops))

    # ----------------------------------------------------------------- planning

    def plan_residency(self, shard: int, streams: List[int]) -> Tuple[List[PageOp], int, int]:
        """Plan (without executing) the page ops seating ``streams`` on
        ``shard``; returns ``(ops, hits, faults)``. Raises when the distinct
        set exceeds the shard's slot count — the round builder's invariant.
        Does NOT mutate tables: the engine executes the device I/O first and
        then calls :meth:`commit`, so an injected page fault retried mid-plan
        can never leave the bookkeeping ahead of the buffers."""
        need = list(dict.fromkeys(int(s) for s in streams))  # ordered distinct
        if len(need) > self.resident:
            raise ValueError(
                f"round touches {len(need)} distinct streams on shard {shard}, "
                f"but only {self.resident} slots are resident"
            )
        lru = self._lru[shard]
        slots = self._slots[shard]
        hits = sum(1 for s in need if s in lru)
        missing = [s for s in need if s not in lru]
        ops: List[PageOp] = []
        if missing:
            free = [j for j, occupant in enumerate(slots) if occupant is None]
            needed_set = set(need)
            # evict oldest residents the round does not need, one per missing
            # stream beyond the free slots
            evictable = (s for s in lru if s not in needed_set)
            for s in need:
                if s in lru:
                    continue
                if free:
                    slot = free.pop(0)
                else:
                    victim = next(evictable)
                    slot = lru[victim]
                    ops.append(PageOp("evict", shard, slot, victim))
                ops.append(PageOp("load", shard, slot, s))
        return ops, hits, len(missing)

    def commit(self, ops: List[PageOp], spilled_rows: Dict[Tuple[int, int], Dict[str, np.ndarray]]) -> None:
        """Apply planned ops to the tables after the engine moved the bytes.
        ``spilled_rows`` maps ``(shard, stream)`` of each evict to the row
        vectors read out of the arena (stored in the host spill store); each
        load's stream drops its spill entry (the row is resident again)."""
        for op in ops:
            lru = self._lru[op.shard]
            slots = self._slots[op.shard]
            if op.kind == "evict":
                row = spilled_rows[(op.shard, op.stream)]
                self._spill_bytes += self._row_nbytes(row) - self._row_nbytes(
                    self._spill[op.shard].get(op.stream)
                )
                self._spill[op.shard][op.stream] = row
                lru.pop(op.stream, None)
                slots[op.slot] = None
            else:
                self._spill_bytes -= self._row_nbytes(
                    self._spill[op.shard].pop(op.stream, None)
                )
                slots[op.slot] = op.stream
                lru[op.stream] = op.slot

    def touch(self, shard: int, streams: List[int]) -> None:
        """Refresh LRU recency for the streams a routed step just updated
        (submit order = recency order, deterministically)."""
        lru = self._lru[shard]
        for s in dict.fromkeys(int(x) for x in streams):
            if s in lru:
                lru.move_to_end(s)

    def drop(self, shard: int, stream: int) -> Optional[int]:
        """Forget a stream entirely (``reset_stream``): its spill entry is
        discarded and its slot freed — the next access faults in the metric's
        init row. Returns the freed slot (None when it was not resident)."""
        self._spill_bytes -= self._row_nbytes(self._spill[shard].pop(stream, None))
        slot = self._lru[shard].pop(stream, None)
        if slot is not None:
            self._slots[shard][slot] = None
        return slot

    def reset(self) -> None:
        for shard in range(self.world):
            self._slots[shard] = [None] * self.resident
            self._lru[shard].clear()
            self._spill[shard].clear()
        self._spill_bytes = 0

    # ----------------------------------------------------- snapshot round-trip

    def snapshot_payload(self) -> Dict[str, Any]:
        """The pager's durable form, snapshot-codec-ready (numpy only): the
        ``(world, resident)`` slot table (-1 = free) and the spilled rows as
        one ``(K, n_dtype)`` matrix per dtype plus their ``(K, 2)``
        (shard, stream) coordinates — exact replay through a spill needs
        every one of these."""
        slot_table = np.full((self.world, self.resident), -1, np.int64)
        for w in range(self.world):
            for j, s in enumerate(self._slots[w]):
                if s is not None:
                    slot_table[w, j] = s
        coords: List[Tuple[int, int]] = []
        for w in range(self.world):
            for s in sorted(self._spill[w]):
                coords.append((w, s))
        payload: Dict[str, Any] = {"slots": slot_table}
        # the spill block is OMITTED when empty, as in the JAX package's
        # payload (an absent key round-trips cleanly)
        if coords:
            payload["spill_coords"] = np.asarray(coords, np.int64).reshape(len(coords), 2)
            dtypes = sorted(self._spill[coords[0][0]][coords[0][1]])
            for key in dtypes:
                payload[f"spill_{key}"] = np.stack(
                    [self._spill[w][s][key] for w, s in coords]
                )
        return payload

    def load_payload(self, payload: Dict[str, Any]) -> None:
        """Inverse of :meth:`snapshot_payload` (same world/resident only)."""
        slot_table = np.asarray(payload["slots"])
        if slot_table.shape != (self.world, self.resident):
            raise ValueError(
                f"pager payload is {slot_table.shape}, this pager is "
                f"({self.world}, {self.resident})"
            )
        self.reset()
        for w in range(self.world):
            for j in range(self.resident):
                s = int(slot_table[w, j])
                if s >= 0:
                    self._slots[w][j] = s
                    self._lru[w][s] = j
        coords = np.asarray(payload.get("spill_coords", np.zeros((0, 2), np.int64))).reshape(-1, 2)
        spill_keys = [k[len("spill_"):] for k in payload if k.startswith("spill_") and k != "spill_coords"]
        for i, (w, s) in enumerate(coords):
            row = {key: np.asarray(payload[f"spill_{key}"][i]) for key in spill_keys}
            self._spill[int(w)][int(s)] = row
            self._spill_bytes += self._row_nbytes(row)
