"""Shared traffic generators for the serving checks.

Port of ``metrics_tpu/engine/traffic.py``, whole and numpy only: for one
seed the two packages draw bit-identical stream ids and batches.

Real multi-tenant traffic is skewed — a few hot tenants dominate while a long
tail trickles — so the paging checks, the chaos runs and the overload drive
of ``chip_smoke.py`` draw stream ids from ONE seeded Zipfian sampler defined
here.

The HOT-SPOT SHIFT mode models the overload the degradation ladder
(``engine/admission.py``) exists for: at a given batch index the hot set
moves — the rank→stream permutation rotates and/or the Zipf exponent changes
— so a pager sized for the old working set faults on every batch. With
``shift_at=None`` the sequence is the unshifted generator's, draw for draw.

The LABEL/SCORE DRIFT mode models the scenario a drift detector exists for:
from ``drift_at`` onward scores ramp upward by dyadic increments
(``drift_score``) and/or labels flip with a ramping probability
(``drift_flip``), both reaching full strength over ``drift_ramp`` batches.
The drift TRANSFORMS already-drawn batches (score shifts are pure functions
of the drawn values; label flips draw from a per-batch-index seeded side
stream), so the pre-drift prefix of a drifted call equals the undrifted call
and two same-seed drifted runs are identical everywhere.

Values are dyadic rationals (multiples of 1/64), so float accumulation is
exact under ANY grouping, routing or paging order. Batch values and row
counts draw from a stream-id-independent RNG, so the shift moves WHICH
stream a batch lands on, never its contents.
"""
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["zipf_stream_ids", "zipf_traffic"]

_DRIFT_SEED_SALT = 0xD21F7


def _drift_strength(i: int, drift_at: int, drift_ramp: int) -> float:
    """Ramp from 0 (before ``drift_at``) to 1 (``drift_ramp`` batches later),
    piecewise-linear — the GRADUAL shift a hysteresis-guarded detector must
    ride out, then alarm on."""
    if i < drift_at:
        return 0.0
    return min(1.0, (i - drift_at + 1) / max(1, int(drift_ramp)))


def zipf_stream_ids(
    num_streams: int,
    n: int,
    alpha: float = 1.1,
    seed: int = 0,
    shift_at: Optional[int] = None,
    shift_rotation: Optional[int] = None,
    shift_alpha: Optional[float] = None,
) -> np.ndarray:
    """``n`` stream ids in ``[0, num_streams)`` drawn from a bounded Zipf.

    Rank ``r`` (0-based) has probability proportional to ``1/(r+1)^alpha``;
    rank maps to stream id through a seeded permutation, so the hot set is
    spread across the id space (and therefore across shards under the
    ``sid % world`` routing rule) instead of clustering on shard 0.

    ``shift_at`` arms the hot-spot shift: draws at indices >= ``shift_at``
    use a ROTATED rank→id permutation (``shift_rotation`` positions, default
    ``num_streams // 2`` — the head moves to previously-cold ids) and, when
    ``shift_alpha`` is given, a different Zipf exponent (a flatter/steeper
    tail). The rank STREAM itself is unchanged — one draw sequence, two
    mappings — so the pre-shift prefix of a shifted call equals the
    unshifted call exactly. Deterministic in every argument.
    """
    if num_streams <= 0 or n < 0:
        raise ValueError(f"need num_streams > 0 and n >= 0, got {num_streams}, {n}")
    if shift_at is not None and not (0 <= shift_at):
        raise ValueError(f"shift_at must be >= 0, got {shift_at}")
    rng = np.random.RandomState(seed)

    def _weights(a: float) -> np.ndarray:
        w = 1.0 / np.power(np.arange(1, num_streams + 1, dtype=np.float64), float(a))
        return w / w.sum()

    perm = np.random.RandomState(seed ^ 0x5A1F).permutation(num_streams)
    if shift_at is None or shift_at >= n:
        ranks = rng.choice(num_streams, size=int(n), p=_weights(alpha))
        return perm[ranks].astype(np.int32)
    head = rng.choice(num_streams, size=int(shift_at), p=_weights(alpha))
    tail = rng.choice(
        num_streams,
        size=int(n - shift_at),
        p=_weights(alpha if shift_alpha is None else shift_alpha),
    )
    rot = num_streams // 2 if shift_rotation is None else int(shift_rotation)
    perm_shifted = np.roll(perm, rot)
    return np.concatenate(
        [perm[head], perm_shifted[tail]]
    ).astype(np.int32)


def zipf_traffic(
    num_streams: int,
    n_batches: int,
    alpha: float = 1.1,
    seed: int = 0,
    max_rows: int = 24,
    shift_at: Optional[int] = None,
    shift_rotation: Optional[int] = None,
    shift_alpha: Optional[float] = None,
    drift_at: Optional[int] = None,
    drift_ramp: int = 8,
    drift_score: float = 0.0,
    drift_flip: float = 0.0,
    label_acc: Optional[float] = None,
) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """``(stream_id, preds, target)`` batches under the Zipfian stream law:
    ragged dyadic-float preds and 0/1 int targets (the Accuracy/MSE input
    shape every serving gate drives). One batch carries one stream's rows —
    cross-stream mixing happens in the engine's coalescer, same as
    production ingest. ``shift_at``/``shift_rotation``/``shift_alpha`` pass
    through to :func:`zipf_stream_ids` (batch CONTENTS draw from an
    id-independent RNG, so the shift reroutes batches without changing
    their rows).

    ``drift_at`` arms the LABEL/SCORE drift: batches at indices
    >= ``drift_at`` transform — preds shift upward by
    ``round(64 * drift_score * strength) / 64`` (clipped to [0, 1], so
    values stay dyadic) and each target row flips with probability
    ``drift_flip * strength``, where ``strength`` ramps linearly from 0 to 1
    over ``drift_ramp`` batches. The base draws are UNCHANGED (score drift
    is a pure remap; label flips draw from a per-batch-index seeded side
    stream), so the pre-drift prefix is bit-identical to the undrifted call
    and the whole sequence is deterministic in its arguments.

    ``label_acc`` correlates targets with predictions: each target agrees
    with ``preds > 0.5`` with that probability (same RNG budget as the
    default independent draw — one uniform per row — so arming it changes
    only the MAPPING of the draws). Without it, targets are independent of
    preds and a label flip cannot move accuracy — set it (e.g. 0.9) when
    the drift detector should see a real accuracy signal."""
    rng = np.random.RandomState(seed ^ 0x7AFF)
    sids = zipf_stream_ids(
        num_streams, n_batches, alpha=alpha, seed=seed,
        shift_at=shift_at, shift_rotation=shift_rotation, shift_alpha=shift_alpha,
    )
    if drift_at is not None and drift_at < 0:
        raise ValueError(f"drift_at must be >= 0, got {drift_at}")
    out: List[Tuple[int, np.ndarray, np.ndarray]] = []
    for i, sid in enumerate(sids):
        rows = int(rng.randint(1, max(2, max_rows + 1)))  # inclusive max_rows
        preds = (rng.randint(0, 65, size=rows) / 64.0).astype(np.float32)
        u = rng.rand(rows)
        if label_acc is None:
            target = (u > 0.5).astype(np.int32)
        else:
            pred_label = (preds > 0.5).astype(np.int32)
            agree = u < float(label_acc)
            target = np.where(agree, pred_label, 1 - pred_label).astype(np.int32)
        if drift_at is not None and i >= drift_at:
            strength = _drift_strength(i, drift_at, drift_ramp)
            if drift_score:
                # dyadic shift on the 1/64 grid: exact float32 arithmetic,
                # and a pure remap of the already-drawn values
                shift64 = int(round(64.0 * float(drift_score) * strength))
                preds = np.minimum(
                    np.round(preds * 64).astype(np.int64) + shift64, 64
                ).astype(np.float32) / np.float32(64.0)
            if drift_flip:
                # the flip stream is keyed by (seed, batch index) alone —
                # independent of the prefix draws, so arming the drift can
                # never shift the base sequence
                flip_rng = np.random.RandomState(
                    (seed ^ _DRIFT_SEED_SALT ^ (i * 2654435761)) & 0x7FFFFFFF
                )
                flips = flip_rng.rand(rows) < float(drift_flip) * strength
                target = np.where(flips, 1 - target, target).astype(np.int32)
        out.append((int(sid), preds, target))
    return out
