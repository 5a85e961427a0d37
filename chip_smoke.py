#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``metrics_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs a CUDA device and ``nvcc`` (``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``)
and exits non-zero, printing no result, without them. Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels K1–K7 from ``metrics_tpu_torch/ops/kernels/csrc``
   (one ``nvcc`` per source, all started together);
3. hold K1–K3 against their plain PyTorch versions on the card: at the shapes
   the main path gives them, on edge cases, and through their
   ``torch.func.vmap`` rules at a 1024-row bucket; then time kernel, plain
   version and (where one PyTorch call computes the same function) that call
   at each shape the main path launches: K1 at the masked step's leaves over
   a 1024-row bucket (1000 f32, 100, 10 and 1 int32 columns), K2 at the
   vmapped confusion matrix's (B, 1) int64 indices into 100 bins and at the
   one-shot (16 384,) batch, with the whole call's time, host µs and device
   launches beside the kernel's, K3 at the one-shot (16 384, 10) batch and at
   the vmapped (1, B*10) row, each against 100 thresholds; B is 64, 256 and
   1024, the engines' buckets;
4. the main path: the flagship collection (Accuracy, macro F1, binned AP over
   100 thresholds, confusion matrix; 10 classes) updated over 65 536 rows in
   batches, then computed; held against the same collection on the CPU and
   against numpy oracles for every count;
5. the masked bucket step: the same rows as ragged 1024-row buckets padded
   with garbage through ``update_state_masked``; its state must equal phase 4's;
6. hold K4–K7 (segment reduce, megastep fold, megastep segment and its q8
   decode) against their plain versions on edge cases and, exactly, at the
   engine's shapes, and time them there: K5 at the flagship arena's two
   buffers (3000 f32 and 146 int32 columns) over 1024- and 256-row buckets;
   K4, K6 and K7 once with random ids
   and once as the one-stream step the engines send (every unmasked row in
   one segment; K4 at a 1000- and a 10-column leaf), each also held exactly
   against ``index_add`` and K7 bit-identical to K6 on a host-decoded state;
7. ``StreamingEngine`` under ``kernel_backend="megastep"`` over the same rows
   as ragged 16–1024-row batches: bit-equal to phase 4, two K5 launches per
   step (one per arena dtype) and no K1;
8. the unsharded ``MultiStreamEngine``: 64 streams, Zipf(1.05) stream ids,
   the same rows in 16–1024-row batches; every stream bit-equal to a numpy
   oracle over its rows; K4 on every step;
9. the paged ``MultiStreamEngine``: 10 000 streams, Zipf(1.05), 128 resident
   slots, 8–64-row batches, so rows spill and page back in; (a) exact under
   ``"megastep"``, bit-equal to the per-stream oracle, coalescing queued
   batches across streams, and once more with ``coalesce=1`` for the step
   count without coalescing; (b) binned AP quantized ``q8_block`` with
   ``compress_payloads=True``: K7 decodes staged slots, int states exact;
   (c) (b)'s twin that decodes on the host instead: bit-identical to (b).
   (b) and (c) keep ``coalesce=1``: grouping follows timing, and a q8 spill
   taken at another step quantizes differently. Phases 8 and 9a end with one
   batched ``results()`` (every stream's value from one vmapped compute),
   held against ``result()`` of each of 64 (8) or 200 sampled (9a: resident,
   spilled and never-touched) streams and timed against that loop;
10. the classification dashboard (macro Precision, Recall and Specificity,
   HammingDistance, JaccardIndex, CohenKappa, MatthewsCorrCoef, HingeLoss)
   on the same rows, its launch counts set to 0 before it: (a) eager in
   4 batches, with ``CalibrationError(n_bins=15)`` in all three norms (K2's
   weighted form, one launch per ``compute``), ``KLDivergence`` against a
   second seeded distribution and ``dice_score``; counts equal to numpy's and
   to the CPU port's, the hinge measure, KL and calibration errors within
   the reassociation bounds of float64 oracles, other values within 1e-6
   relative; then through the per-leaf masked bucket step (K1); (b) the
   captured megastep ``StreamingEngine`` of phase 7 (two K5 and three K2
   launches a step); (c) the captured paged ``MultiStreamEngine`` of phase 9a
   (two K6 and three K2 launches a step), its 200 sampled streams against
   numpy, then one ``results()``; (d) the times of (a)-(c) and of that
   ``results()`` beside the per-stream loop;
11. the exact curves on the same rows, their launch counts set to 0 before
   them: (a) eager in 4 batches, AUROC macro and weighted (its class support
   one K2 launch), the binary AUROC of class 0 up to fpr 0.3, AP macro, ROC,
   the PR curve, AUC of class 0's ROC, ``BinnedRecallAtFixedPrecision`` (K3)
   and the aggregators, with ``AUROC``/``AveragePrecision(capacity=65 536)``;
   each value within its stated f32 bound of a float64 oracle
   (Mann-Whitney AUROC from ``scipy.stats.rankdata``, step AP), curves and
   counts bit-equal to the CPU port's; (b) the flagship collection plus
   ``AUROC`` and ``AveragePrecision(num_classes=10, capacity=65 536)``
   through phase 7's captured megastep ``StreamingEngine``: the scan members
   demote every arena dtype (the JAX package's fallback reasons, no K5),
   their buffers bit-equal to the CPU port's eager capacity update, the
   flagship's states to phase 4's, with capture seconds, host ms per step
   and one 1024-row bucket's device µs and launches; an uncaptured twin on a
   prefix of the batches, bit-equal too; (c) both forms of
   ``MultiStreamEngine`` refuse the scan members with the JAX package's
   reason;
12. wrappers and composition on the same rows, their launch counts set to 0
   before them: (a) eager in 4 batches, each against a numpy oracle:
   ``MinMaxMetric`` over macro F1 (the prefix extremes, and with
   ``fold_on_compute``), ``MultioutputWrapper`` over two heads with NaN rows
   removed, ``BootStrapper`` (10 replicas, poisson from the same seeded
   numpy draws, multinomial from a generator in the same state: replica
   counts exact, mean, std, median and raw within 1e-6), the composition
   ``2 * P * R / (P + R)`` of macro Precision and Recall (its harmonic mean;
   per class against ``F1Score(average="none")``), a scalar operand, a
   comparison, an index, and ``MetricTracker`` over the flagship collection
   for 3 epochs with ``best_metric(return_step=True)``; (b) the flagship plus
   that composition and a multinomial ``BootStrapper`` through phase 7's
   captured megastep ``StreamingEngine`` (three K5 launches a step: f32,
   int32 and the uint32 draw counter), with its uncaptured twin, a warm twin
   that captures nothing and a profile of a 1024-row bucket, and through
   phase 9a's captured paged ``MultiStreamEngine`` (an uncaptured twin on its
   first 230 batches; its sums over streams and 23 streams against numpy);
   ``MultioutputWrapper(remove_nans=False)`` through the megastep engine on
   two-head rows; every integer state, children included, bit-equal to the
   twins and to numpy (each occurrence of a shared operand counts every row
   twice; each replica sees each row once; ``draw_count`` counts the rows);
   (c) both engines refuse ``MinMaxMetric`` with the JAX package's reason,
   and a masked update of ``MultioutputWrapper(remove_nans=True)`` raises;
13. regression and pairwise on 65 536 seeded rows (gamma(2, 1) targets, the
   targets times log-normal noise as predictions), their launch counts set
   to 0 before them: (a) each of the 11 regression metrics over 4 batches
   and each functional over every row, Tweedie at powers 0, 1, 1.5, 2 and
   3, against float64 numpy: every f32 sum within 2^-24 (2 n Σ|term| +
   8 Σ parts) of the exact one, counts exact, each value within 1e-6
   relative plus the move its sums' bounds allow; Pearson (also as Chan's
   fold of 4 hand-stacked shards), Spearman and the cosine similarity within
   1e-5 of scipy and numpy; the eight served members through the masked
   bucket step (K1), padded with rows outside every domain; (b) the eight
   members whose value is served (MSE, RMSE, MAE, MSLE, MAPE, SMAPE,
   ExplainedVariance, Tweedie at 1.5) and R2Score alone through phase 7's
   captured megastep engine (two K5 a step), phase 8's unsharded engine (K4
   per leaf) and phase 9a's paged one (two K6 a step), one batch a step,
   each first over an uncaptured twin's prefix (bit-equal), every stream's
   states within their bounds of the per-stream oracle, the values of
   ``result()`` and of one timed ``results()`` against the oracle's, and
   R2Score's served ``result()``/``results()`` raising; a profile of one
   1024-row bucket; (c) the engines refuse Pearson, Spearman and
   CosineSimilarity with the JAX package's reasons; (d) the pairwise
   cosine, linear and euclidean at (8192, 512) x (8192, 512) and manhatten
   at (1024, 512) x (1024, 512) against float64 numpy on sampled rows.
14. Cross-process sync on ``torch.distributed``: (a) NCCL at world 1 on the
   card: the flagship collection plus capacity AUROC and AP over phase 4's
   rows, and phase 13's eight served members plus Pearson and a
   ``MinMaxMetric`` of an MSE (the min/max bucket) with the MSE's sum on the
   q8 carrier, over phase 13's rows, update on the card (K2, K3); each
   metric's eager ``sync()`` (forced at world 1) and one fused
   ``sync_states`` bundle per collection, whose collectives are counted
   against ``fused_sync_plan``; every value equals the unsynced one bit for
   bit (the flagship's states equal phase 4's), the q8 leaf its one-rank
   round trip; (b) two spawned processes on the same card, world 2 over
   gloo with the CUDA tensors themselves (gloo takes every dtype the bundle
   sends), each updating on half the rows: the merged states equal (a)'s,
   integers, buffers and min/max bit for bit, f32 sums within the
   reassociation bound, the q8 sum within ``q8_sum_error_bound``, and every
   rank's eager ``compute()`` gives (a)'s values. NCCL at world > 1 is not
   run: one card takes one NCCL rank. The phase line holds the collectives
   per sync, the payload bytes exact and with q8, host ms per sync (median
   of 20) at world 1 and 2, and the K2/K3 launches.
15. The compiled forward (``Metric.forward``, ``MetricCollection.forward``:
   one CUDA graph per input signature, ``engine/aot.py``'s
   ``CapturedForward``), each owner against an eager twin (the same metric
   with the compiled path off) over the same batches: (a) the flagship
   collection through ``coll(preds, target)`` over phase 4's rows as 64
   forwards of 1024 rows: the first runs eagerly, the second captures one
   fused graph, which serves 63 of the 64; every batch value bit-equal to
   the twin's, the final states bit-equal to phase 4's, ``compute()`` equal
   to phase 4's values, K2 and K3 launches credited per replay; (b)
   ``BinnedAveragePrecision`` alone over the same batches (the single
   metric's step, K3); (c) phase 13's eight members plus ``R2Score`` as a
   collection over phase 13's rows: the fused step fails (R2Score's compute
   reads ``n_obs`` on the host), each member takes its own graph, R2Score
   stays eager-only, the entry kinds equal to the JAX package's; (d) the
   deferred checks: a ``ConfusionMatrix`` batch with ``target ==
   num_classes`` and a Tweedie (power 1.5) batch with a negative target on
   the captured path: ``forward`` returns, every ``compute()`` raises the
   JAX package's message until ``reset()``; (e) a metric whose update reads
   the device on the host is refused in the warm-up, before any capture, and
   one that reads only while a capture runs gets past the warm-up and breaks
   its capture: each ends eager-only, its state equal to the twin's; a graph
   that draws random numbers, captured before, still follows
   ``manual_seed`` and draws apart from eager draws; (a)'s graph still
   replays right, and the ``compute()`` result kept from (a) (the confusion
   matrix's state tensor itself) keeps its values. The phase line holds captures, replays, eager-only
   signatures and capture seconds, host ms per forward (median over the
   replays, the device drained after each call) against the twin's, the
   device launches and µs of one forward captured and eager (profiler), the
   memory the capture kept, and the K2/K3 launches.
16. Snapshots and the restore matrix (``engine/snapshot.py``), through the
   captured engines: (a) phase 7's megastep engine and traffic with
   ``snapshot_every=16``, killed after batch 80, a fresh engine sharing its
   ``AotCache`` restored (the cursor 80, every state buffer at its address)
   and replayed: states bit-equal to phase 4's (counts), values within 1e-6,
   no capture; (b) phase 9's q8-staged tenancy (``coalesce=1``) snapshotted
   halfway with rows spilled and 8 spilled streams staged as int8 codes,
   served to the end, the snapshot restored into 128 slots, into 256 and
   merged into an unsharded engine, each replaying the second half: every
   staged row as it was before staging, integer states bit-equal to the
   uninterrupted run's, the q8-policy counts within the codec's bound
   (``snapshot_paged``), count-derived values of every 7th stream equal;
   (c) ``corrupt_snapshot`` on (a)'s LATEST: the restore falls back one
   generation (cursor 64) and the replay is bit-equal; (d) host ms and bytes
   on disk of one ``snapshot()`` and one ``restore()`` for (a) (into a fresh
   and into the live captured engine, which keeps its buffers and captures
   nothing) and (b) (each target), and phase 7's host ms per captured step
   with the cadence against without, warm, in turns. Snapshots are written
   under the gitignored ``build/phase16/``, removed after the phase.
17. The chaos sweep (``engine/faults.py`` wired through the engines), at
   full width: (a) phase 7's megastep engine and traffic, plus a 2-row NaN
   batch at cursor 2, with ``coalesce=8``, NaN quarantine and
   ``snapshot_every=16`` under the JAX package's chaos plan
   (``metrics_tpu/engine/chaos_smoke.py:127-225``: ``coalesce`` at rate 1,
   ``ingest``, ``compile``, ``step``, ``watchdog``, ``snapshot_write`` and
   ``snapshot_corrupt`` on the last good save, with ``kernel`` moved from
   occurrence 0 to 8 so that K5 launches before the demotion): states
   bit-equal to phase 4's, one ``megastep -> auto`` demotion (K5 before it,
   K1 after it), the recovery counters as JAX's smoke checks them, one
   quarantine record at cursor 2 with 2 rows, every state buffer at its
   address; then killed and restored past the corrupt LATEST with a
   transient ``snapshot_read`` (cursor 96) and replayed, bit-equal; (b)
   phase 9's q8 tenancy (``coalesce=1``) under ``page_out``, ``page_in``,
   ``quant_encode``, ``quant_decode`` and a ``kernel`` fault at the first
   step past the middle whose slots hold staged rows: every stream bit-equal
   to its fault-free twin, K6 and K7 before the demotion and K4 after it;
   (c) a device sleep of 0.15 s on the idle engine's stream ahead of one
   batch, the watchdog at 0.1 s: one expiry, one rollback, one retry,
   bit-equal to the twin; (d) a fatal ``dispatcher_kill`` on the first
   group: ``submit(timeout=0.5)`` raises ``EngineDispatchError``,
   ``reset()`` re-arms, phase 7's traffic gives phase 4's states; (e) host
   ms a warm captured step for phase 7's traffic plain, transactional (an
   empty-plan injector), drained (the watchdog site armed, no deadline) and
   with ``step_timeout_s=1.0``, in turns, and the device µs of one shadow
   copy of the flagship arena and of the paged 128-slot arena. Snapshots
   under the gitignored ``build/phase17/``, removed after the phase.

The engines run in their production form: ``submit`` enqueues, a dispatcher
thread coalesces queued batches and replays each (bucket, signature) step as
a CUDA graph captured once (``engine/aot.py``). Phases 7, 8 and 9a run once
more through the uncaptured step (the engine's private ``_capture = False``)
in the same call: the states must be bit-equal and the phase line prints
both host s/step. Each engine's ``aot_cache`` makes at most ``len(buckets)``
misses per payload signature, and phase 7 runs a warm twin engine over an
equal collection sharing the cache: it captures nothing. A capture runs the
step once on a copy of the state first (a warm-up), so each launch check
counts ``steps + warmup_steps``.

Every kernel's launch count is set to 0 before phase 4 and read after phase 9,
and set to 0 again before each of phases 10 to 17 and read after it;
each must be non-zero (phase 10: K1, K2, K5 and K6; phase 11: K1, K2 and
K3; phase 12: K2, K3, K5 and K6; phase 13: K1, K4, K5 and K6; phases 14
and 15: K2 and K3; phase 16: K2–K7; phase 17: K1–K7), and K2 must launch once per batch and per step
for each confusion matrix. A
``torch.profiler`` trace of one megastep bucket (``submit`` + ``flush``,
captured and uncaptured) and one per-leaf masked bucket
(``update_state_masked``) gives the device's busy share and device launches.
The line before the last is the ``kernels`` JSON object: K1, K2, K3 and K5
have one entry per shape above (K2 also at phase 10's calibration shape:
65 536 int64 indices into 15 bins, ``(65 536, 3)`` f32 weights, with
``index_add_`` into a zeroed ``(15, 3)`` output as its library call, and at
phase 11's AUROC support shape: 65 536 int64 labels into 10 bins, with
``torch.bincount`` as its library call), K4, K6 and K7 one per ``traffic`` (random ids
and one stream), each with ``device_us``, the device time of each CUDA kernel
the call launches. In it
``max_abs_err`` is the largest kernel-vs-plain difference over the f32 and
int32 cases, ``max_abs_err_bf16`` over the bf16 cases (null where there are
none), and ``bound_ms`` counts the bytes this run's data needs (unmasked rows
only; K7's codes and scales of the flagged slots only). The last line is
``{"ok": true, "device": {...}}``.
"""
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

SEED = 0
N_ROWS = 65536
BATCH = 16384
NUM_CLASSES = 10
THRESHOLDS = 100
BUCKET = 1024
TIMED_RUNS = 25
# the engine phases: 64 streams unsharded; the paged tenancy configuration of
# metrics_tpu/engine/stream_bench.py (10 000 streams, Zipf 1.05, 128 resident)
ALPHA = 1.05
MS_STREAMS = 64
PAGED_STREAMS = 10_000
RESIDENT = 128
PAGED_BUCKETS = (64, 256)

# bounds: NVIDIA's H100 SXM data sheet (HBM3 bandwidth; f32 rate outside the
# tensor cores, also taken as the rate of the int32 compares and adds here)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def max_abs_err(got, want):
    """Largest |got - want| in float64; positions where both agree exactly
    (equal infinities, both NaN) count 0."""
    g = got.detach().double().cpu()
    w = want.detach().double().cpu()
    check(g.shape == w.shape, f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    diff = torch.where(same, torch.zeros_like(g), (g - w).abs())
    return float(diff.max()) if diff.numel() else 0.0


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def gpu_ms(fn, runs=TIMED_RUNS):
    """Median device time of ``fn`` in ms. Each run is bracketed by CUDA events
    behind a short device sleep, so the host's launch overhead is hidden and
    the events see only the device work."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_trace(fn, runs=20):
    """Per CUDA kernel name (memsets and copies too), the mean device µs and
    the launches of one call of ``fn``, from a ``torch.profiler`` trace of
    ``runs`` calls. A kernel launched early (programmatic dependent launch)
    counts its wait for the one before."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without some device events: take another
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                name = re.search(r"::(\w+)\s*[<(]", e.key)  # "void at::native::foo<...>(...)" -> foo
                name = name.group(1) if name else e.key[:40]
                us, count = out.get(name, (0.0, 0.0))  # kernels of one name (templates) add up
                out[name] = (us + e.self_device_time_total / runs, count + e.count / runs)
        if out and all(float(count).is_integer() for _, count in out.values()):
            break
    return out


def device_us(fn, runs=20):
    """Mean device µs per call of each CUDA kernel ``fn`` launches, by name."""
    return {k: us for k, (us, _) in device_trace(fn, runs).items()}


def host_us(fn, calls=200):
    """Host µs per call of ``fn`` over ``calls`` calls in a row, with one
    synchronise at the end: what a caller's thread spends to issue it."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


# --------------------------------------------------------------------------- kernels

def fold_phase(dev, rng):
    from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda, fold_rows_plain

    i32 = torch.iinfo(torch.int32)
    err = {False: 0.0, True: 0.0}  # the f32/int32 cases, the bf16 cases
    cases = []
    for f in (1000, 100, 10, 1):  # the masked step's leaves: binned AP, confmat, macro counts, scalars
        cases += [("float32", "sum", BUCKET, f, "ragged"), ("int32", "sum", BUCKET, f, "ragged")]
    for dt in ("float32", "int32", "bfloat16"):
        for fx in ("sum", "min", "max"):
            cases += [(dt, fx, 1037, 33, "random"), (dt, fx, BUCKET, 100, "none"),
                      (dt, fx, 0, 7, "all"), (dt, fx, 5, 1000, "first")]
    cases += [("int32", fx, BUCKET, 64, "limits") for fx in ("sum", "min", "max")]
    cases += [("float32", fx, 300, 17, "nan") for fx in ("sum", "min", "max")]
    for dt, fx, n, f, pattern in cases:
        dtype = getattr(torch, dt)
        if dt == "int32":
            rows = torch.from_numpy(rng.randint(-1000, 1000, (n, f)).astype(np.int32))
            state = torch.from_numpy(rng.randint(-1000, 1000, (f,)).astype(np.int32))
            if pattern == "limits":
                rows[::3] = i32.max
                rows[1::3] = i32.min
                state[:] = i32.max if fx == "sum" else 0
        else:
            rows = torch.from_numpy(rng.randn(n, f).astype(np.float32)).to(dtype)
            state = torch.from_numpy(rng.randn(f).astype(np.float32)).to(dtype)
            if pattern == "nan":
                rows[7, :5] = float("nan")
                rows[9, 3:9] = float("-inf")
        if pattern in ("ragged", "random", "limits", "nan"):
            mask = rng.rand(n) > 0.3
        else:
            mask = np.zeros(n, bool) if pattern == "none" else np.ones(n, bool)
            if pattern == "first" and n:
                mask[:] = False
                mask[0] = True
        m = torch.from_numpy(mask.astype(np.int32))
        got = fold_rows_cuda(state.to(dev), rows.to(dev), m.to(dev), fx)
        want = fold_rows_plain(state.to(dev), rows.to(dev), m.to(dev), fx)
        e = _check_close(got, want, f"fold {dt}/{fx}/{n}x{f}/{pattern}", fx == "sum", _row_sums(rows, m, None, 1),
                         _reassociation_bound(rows, m, state))
        err[dt == "bfloat16"] = max(err[dt == "bfloat16"], e)

    # timed at the masked step's leaves over a 1024-row bucket: binned AP's (10, 100) f32
    # counts, the confusion matrix, F1's per-class counts, accuracy's scalars (int32)
    head = {"name": "fold_rows", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/fold.cu",
            "replaces": "metrics_tpu/ops/kernels/pallas_fold.py:48",
            "max_abs_err": err[False], "max_abs_err_bf16": err[True]}
    return [_timed_fold(head, lambda s, r, m: fold_rows_cuda(s, r, m, "sum"),
                        lambda s, r, m: fold_rows_plain(s, r, m, "sum"), dtype, BUCKET, f, rng, dev)
            for f, dtype in ((NUM_CLASSES * THRESHOLDS, torch.float32), (NUM_CLASSES * NUM_CLASSES, torch.int32),
                             (NUM_CLASSES, torch.int32), (1, torch.int32))]


def _timed_fold(head, kernel, plain, dtype, n, f, rng, dev):
    """One ``kernels`` entry of a masked sum fold (K1 or K5) of ``(n, f)``
    rows: 0/1 rows, about 10 % masked, so kernel, plain version and
    ``torch.addmv`` agree exactly; then each is timed. ``kernel`` and ``plain``
    take (state, rows, mask). An int32 fold's ``addmv`` runs on float copies,
    made before the timing: only the call is timed."""
    rows = torch.from_numpy(rng.randint(0, 2, (n, f)).astype(np.int32)).to(dev, dtype)
    state = torch.zeros(f, dtype=dtype, device=dev)
    m = torch.from_numpy((rng.rand(n) > 0.1).astype(np.int32)).to(dev)
    rows_f, state_f, mf = rows.float(), state.float(), m.float()
    got = kernel(state, rows, m)
    what = f"{head['name']} ({n}, {f}) {dtype}"
    check(max_abs_err(got, plain(state, rows, m)) == 0.0, f"{what}: kernel disagrees with its plain version")
    check(max_abs_err(got.float(), torch.addmv(state_f, rows_f.t(), mf)) == 0.0, f"{what}: kernel disagrees with addmv")
    entry = dict(head, shape=f"rows ({n}, {f}) {str(dtype).replace('torch.', '')}, sum")
    entry.update({
        "ms": gpu_ms(lambda: kernel(state, rows, m)),
        "plain_ms": gpu_ms(lambda: plain(state, rows, m)),
        "library_ms": gpu_ms(lambda: torch.addmv(state_f, rows_f.t(), mf)),
        "device_us": device_us(lambda: kernel(state, rows, m)),
    })
    # unmasked rows and the mask read once, the state read and written once (a
    # uniform op row is not read)
    live = int(m.sum())
    entry["bound_ms"], entry["bound_by"] = bound_ms(4 * live * f + 4 * n + 2 * 4 * f, live * f)
    return entry


def _hist_indices(rng, b, n, length):
    """int64 (B, N) indices in [-3, L + 3), every fifth past int32 on either
    side (2**32 + 1 would land in bin 1 if it wrapped)."""
    idx = rng.randint(-3, length + 3, (b, n)).astype(np.int64)
    big = np.array([2**31, 2**32 + 1, 2**33 + length - 1, -(2**31) - 1, -(2**40)], np.int64)
    idx.flat[::5] = rng.choice(big, idx.flat[::5].shape)
    return torch.from_numpy(idx)


def _hist_oracle(idx, length, mask=None, weights=None):
    """numpy's bincount of each row (weights summed in float64 or int64)."""
    idx = idx.cpu().numpy()
    v = np.clip(idx, 0, None)
    keep = v < length
    if mask is not None:
        keep &= mask.cpu().numpy() != 0
    rows = np.broadcast_to(np.arange(idx.shape[0])[:, None], idx.shape)
    if weights is None:
        out = np.zeros((idx.shape[0], length), np.int64)
        np.add.at(out, (rows[keep], v[keep]), 1)
        return out
    w = weights.cpu().double().numpy() if weights.dtype.is_floating_point else weights.cpu().numpy().astype(np.int64)
    out = np.zeros((idx.shape[0], length, w.shape[2]), w.dtype)
    np.add.at(out, (rows[keep], v[keep]), w[keep])
    return out


_HIST_OUT_EPS = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}


def hist_phase(dev, rng):
    """K2 against its plain version and numpy: both forms, masks batched and
    expanded with stride 0, every weight dtype, the vmap rule's one launch;
    then :func:`hist_timing`."""
    from metrics_tpu_torch.ops.kernels import histogram_accumulate
    from metrics_tpu_torch.ops.kernels.hist_cuda import WEIGHT_DTYPES, histogram_cuda, histogram_plain

    # counts: the main path's shapes, both forms, bin tiles past 48 KB, no indices
    for b, n, length in ((1, BATCH, 100), (64, 1, 100), (BUCKET, 1, 100), (256, 3, 12289), (1, 1037, 1),
                         (1, 4099, 12289), (8, BATCH, 102400), (64, 1, 102400), (3, 0, 5), (1, 1, 3)):
        idx = _hist_indices(rng, b, n, length).to(dev)
        mask = torch.from_numpy(rng.rand(b, n) > 0.3).to(dev)
        row_mask = mask[:1].to(torch.int32).expand(b, n)  # one row's int32 mask, stride 0
        for i, m in ((idx, None), (idx, mask), (idx[:1].expand(b, n), row_mask), (idx.to(torch.int32), mask)):
            got = histogram_cuda(i, length, m)
            want = histogram_plain(i, length, m)
            torch.cuda.synchronize()
            what = f"hist counts ({b}, {n}) L={length} {i.dtype} mask={None if m is None else m.dtype}"
            check(got.dtype == torch.int32 and torch.equal(got, want), f"{what}: kernel != plain")
            check(np.array_equal(got.cpu().numpy(), _hist_oracle(i, length, m)), f"{what}: != numpy")
    # weighted sums in every dtype, direct and shared form, weights batched and stride 0
    err = {False: 0.0, True: 0.0}  # the f32/int32 cases, the bf16 cases
    for dtype in WEIGHT_DTYPES:
        for b, n, length, k in ((64, 3, 37, 3), (2, 5000, 37, 3), (1, 3001, 5000, 1)):
            idx = _hist_indices(rng, b, n, length).to(dev)
            mask = torch.from_numpy(rng.rand(b, n) > 0.3).to(dev)
            if dtype.is_floating_point:
                w = torch.from_numpy(rng.randn(b, n, k) * 10).to(dev, dtype)
            else:
                info = torch.iinfo(dtype)
                w = torch.from_numpy(rng.randint(max(info.min, -(2**40)), min(info.max, 2**40), (b, n, k)))
                w = w.to(dev, dtype)
            for ww in (w, w[:1].expand(b, n, k)):
                got = histogram_cuda(idx, length, mask, ww)
                want = histogram_plain(idx, length, mask, ww)
                torch.cuda.synchronize()
                what = f"hist weights {dtype} ({b}, {n}, {k}) L={length}"
                check(got.dtype == dtype and got.shape == (b, length, k), f"{what}: dtype/shape")
                if not dtype.is_floating_point:  # exact, wrapping as the dtype does
                    check(torch.equal(got, want), f"{what}: kernel != plain")
                    oracle = _hist_oracle(idx, length, mask, ww).astype(str(dtype).replace("torch.", ""))
                    check(np.array_equal(got.cpu().numpy(), oracle), f"{what}: != numpy")
                    continue
                # the reassociation bound of the accumulator, plus one step of a bf16/f16 output
                abs_sums = torch.from_numpy(_hist_oracle(idx, length, mask, ww.abs())).to(dev)
                eps = 2.0**-53 if dtype == torch.float64 else 2.0**-24
                tol = (2 * n * eps + _HIST_OUT_EPS.get(dtype, 0.0)) * abs_sums
                diff = (got.double() - want.double()).abs()
                check(bool((diff <= tol).all()), f"{what}: err {float(diff.max())}")
                if dtype in (torch.float32, torch.bfloat16):
                    err[dtype == torch.bfloat16] = max(err[dtype == torch.bfloat16], float(diff.max()))
    # the vmap rule: one launch for the whole bucket, a stride-0 mask passed through
    rows_idx = _hist_indices(rng, BUCKET, 1, 100)
    row_mask = torch.from_numpy(rng.rand(1) > 0.5)
    for m in (None, row_mask):
        def call(i, m_dev):
            return torch.func.vmap(lambda r: histogram_accumulate(r, 100, mask=m_dev))(i)
        before = histogram_cuda.launches
        got = call(rows_idx.to(dev), None if m is None else m.to(dev))
        check(histogram_cuda.launches == before + 1, "hist vmap rule: expected exactly one launch")
        oracle = _hist_oracle(rows_idx, 100, None if m is None else m.expand(BUCKET, 1))
        check(torch.equal(got.cpu(), call(rows_idx, m)) and np.array_equal(got.cpu().numpy(), oracle), "hist vmap rule")
    return hist_timing(dev, rng, err)


def _k2(fn, idx, length):
    """``fn`` (K2's wrapper or its plain version) on ``(B, N)`` indices, as a
    closure for timing. A tree from before the batched kernel (a parent
    unpacked in ``build/baseline`` for a comparison in one call) takes 1-D
    int32 indices into one histogram of B * L bins; for it the batch is folded
    into the bins beforehand, outside the closure."""
    from metrics_tpu_torch.ops.kernels import hist_cuda

    if hasattr(hist_cuda, "histogram_op"):
        return lambda: fn(idx, length)
    b = idx.shape[0]
    flat = (idx.clamp(min=0) + torch.arange(b, device=idx.device)[:, None] * length).reshape(-1).to(torch.int32)
    return lambda: fn(flat, b * length)


def hist_timing(dev, rng, err=None):
    """One ``kernels`` entry per shape the main path launches K2 at: the
    vmapped confusion matrix, ``(B, 1)`` int64 indices into L = 100 bins at the
    64-, 256- and 1024-row buckets (phases 9, 5, 7 and 8), and the one-shot
    ``(16 384,)`` batch (phase 4). Each holds the kernel's ms and
    ``device_us``, the whole call's (``histogram_accumulate``, vmapped or not)
    ms, host µs and device launches, the plain version's ms,
    ``torch.bincount`` of the indices folded into B * L bins beforehand, and
    the bound. Runs in an unpacked parent tree as well (:func:`_k2`)."""
    from metrics_tpu_torch.ops.kernels import histogram_accumulate
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda, histogram_plain

    length = NUM_CLASSES * NUM_CLASSES
    entries = []
    for rows in (*PAGED_BUCKETS, BUCKET, None):
        # target * C + pred: int64, in range, as the confusion matrix computes it
        b, n = (rows, 1) if rows else (1, BATCH)
        idx = torch.from_numpy(rng.randint(0, length, (b, n))).to(dev)
        if rows:
            call = torch.func.vmap(lambda i: histogram_accumulate(i, length))
            whole = lambda: call(idx)  # noqa: E731
        else:
            flat_idx = idx.reshape(-1)
            whole = lambda: histogram_accumulate(flat_idx, length)  # noqa: E731
        kernel, plain = _k2(histogram_cuda, idx, length), _k2(histogram_plain, idx, length)
        folded = (idx + torch.arange(b, device=dev)[:, None] * length).reshape(-1)
        library = lambda: torch.bincount(folded, minlength=b * length)  # noqa: E731
        want = library().reshape(b, length).to(torch.int32)
        for f in (kernel, plain, whole):
            check(torch.equal(f().reshape(b, length), want), f"hist ({b}, {n}): disagrees with torch.bincount")
        trace = device_trace(whole)
        entry = {
            "name": "histogram", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/hist.cu",
            "replaces": "metrics_tpu/ops/kernels/pallas_hist.py:55",
            "shape": f"idx ({b}, {n}) int64, L={length} counts" + (f" (vmapped {rows}-row bucket)" if rows
                                                                  else " (one-shot batch)"),
            "max_abs_err": None if err is None else err[False], "max_abs_err_bf16": None if err is None else err[True],
            "ms": gpu_ms(kernel), "plain_ms": gpu_ms(plain), "library_ms": gpu_ms(library),
            "device_us": device_us(kernel),
            "call_ms": gpu_ms(whole), "call_host_us": host_us(whole),
            "call_device_us": {k: us for k, (us, _) in trace.items()},
            "call_device_launches": sum(c for _, c in trace.values()),
        }
        # each index read once, each output element written once; one add per index
        entry["bound_ms"], entry["bound_by"] = bound_ms(8 * b * n + 4 * b * length, b * n)
        entries.append(entry)
    return entries


def binned_phase(dev, rng):
    from metrics_tpu_torch.ops.binned_update import binned_counts, binned_counts_cuda, binned_counts_torch

    def data(n, c, edge):
        p = rng.rand(n, c).astype(np.float32)
        t = rng.rand(n, c) > 0.7
        if edge and n >= 40:
            p[3:9, 0] = np.nan
            p[10:30] = -np.inf  # pad rows: -inf preds, target 0
            t[10:30] = False
            p[31, :] = np.inf
            p[32, :] = 1.0
            p[33, :] = 0.0
        return torch.from_numpy(p).to(dev), torch.from_numpy(t).to(dev)

    def thr(t):
        return torch.linspace(0, 1, t, dtype=torch.float32, device=dev)

    for n, c, t, edge in ((BATCH, NUM_CLASSES, THRESHOLDS, False), (N_ROWS, NUM_CLASSES, THRESHOLDS, False),
                          (1037, 3, 7, True), (1037, 1, 1, True), (0, 4, 5, False), (BUCKET, 10, 100, True)):
        p, y = data(n, c, edge)
        got = binned_counts_cuda(p, y, thr(t))
        want = binned_counts_torch(p, y, thr(t))
        pn, yn, tn = p.cpu().numpy(), y.cpu().numpy(), thr(t).cpu().numpy()
        ge = pn[:, :, None] >= tn[None, None, :]
        oracle = ((yn[:, :, None] & ge).sum(0), (~yn[:, :, None] & ge).sum(0), (yn[:, :, None] & ~ge).sum(0))
        torch.cuda.synchronize()
        for g, w, o, name in zip(got, want, oracle, ("TP", "FP", "FN")):
            check(torch.equal(g.cpu(), w.cpu()), f"binned {name} {n}x{c}x{t}: kernel != plain")
            check(np.array_equal(g.cpu().numpy(), o.astype(np.float32)), f"binned {name} {n}x{c}x{t}: != numpy")
    # the vmap rule at one 1024-row bucket: (B, 1, C) widens to (1, B*C), one launch
    p, y = data(BUCKET, NUM_CLASSES, True)
    thresholds = thr(THRESHOLDS)
    per_row = torch.func.vmap(lambda pr, yr: binned_counts(pr, yr, thresholds))
    before = binned_counts_cuda.launches
    got = per_row(p.reshape(BUCKET, 1, NUM_CLASSES), y.reshape(BUCKET, 1, NUM_CLASSES))
    check(binned_counts_cuda.launches == before + 1, "binned vmap rule: expected exactly one launch")
    thr_cpu = thresholds.cpu()
    want = torch.func.vmap(lambda pr, yr: binned_counts(pr, yr, thr_cpu))(
        p.cpu().reshape(BUCKET, 1, NUM_CLASSES), y.cpu().reshape(BUCKET, 1, NUM_CLASSES))
    for g, w in zip(got, want):
        check(g.shape == (BUCKET, NUM_CLASSES, THRESHOLDS) and torch.equal(g.cpu(), w), "binned vmap rule")

    # timed at the one-shot batch and at the vmapped buckets that carry nearly every
    # launch: phase 9's 64 and 256 rows, phases 5 and 7's 1024, each one (1, B*C) row
    c, t = NUM_CLASSES, THRESHOLDS
    p, y = data(BATCH, c, False)
    th = thr(t)
    entries = []
    for rows, wide in ((BATCH, False), (PAGED_BUCKETS[0], True), (PAGED_BUCKETS[1], True), (BUCKET, True)):
        pp, yy = (p[:rows].reshape(1, -1).contiguous(), y[:rows].reshape(1, -1).contiguous()) if wide else (p, y)
        n, cc = pp.shape
        check(all(torch.equal(g, w) for g, w in zip(binned_counts_cuda(pp, yy, th), binned_counts_torch(pp, yy, th))),
              f"binned ({n}, {cc}) x {t}: kernel != plain at a timed shape")
        entry = {
            "name": "binned_counts", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/binned.cu",
            "replaces": "metrics_tpu/ops/binned_update.py:69",
            "shape": f"preds ({n}, {cc}) f32, T={t}" + (f" (vmapped {rows}-row bucket)" if wide else " (one-shot batch)"),
            "max_abs_err": 0.0, "max_abs_err_bf16": None,  # f32 preds only; counts exact
            "ms": gpu_ms(lambda: binned_counts_cuda(pp, yy, th)),
            "plain_ms": gpu_ms(lambda: binned_counts_torch(pp, yy, th)),
            "library_ms": None,
            "device_us": device_us(lambda: binned_counts_cuda(pp, yy, th)),
        }
        # preds (4 bytes) and target (1) read once, the thresholds once, three (C, T) f32 written
        entry["bound_ms"], entry["bound_by"] = bound_ms(n * cc * 5 + 4 * t + 3 * 4 * cc * t, n * cc * t)
        entries.append(entry)
    return entries


def _segment_case(rng, dtype, n, s, f, pattern):
    """Rows, state, int32 mask and ids: masked rows carry ids in {-7, S, 2**31-1}."""
    i32 = torch.iinfo(torch.int32)
    if dtype == torch.int32:
        rows = torch.from_numpy(rng.randint(-1000, 1000, (n, f)).astype(np.int32))
        state = torch.from_numpy(rng.randint(-1000, 1000, (s, f)).astype(np.int32))
        if pattern == "limits":
            rows[::3] = i32.max
            rows[1::3] = i32.min
    else:
        rows = torch.from_numpy(rng.randn(n, f).astype(np.float32)).to(dtype)
        state = torch.from_numpy(rng.randn(s, f).astype(np.float32)).to(dtype)
        if pattern == "nan" and n > 9:
            rows[7, : min(f, 5)] = float("nan")
            rows[9, :] = float("-inf")
    mask = rng.rand(n) > 0.3
    ids = rng.randint(0, s, n).astype(np.int32)
    if pattern == "one_segment":
        ids[:] = s - 1
    if pattern == "all_masked":
        mask[:] = False
    ids[~mask] = rng.choice(np.array([-7, s, 2**31 - 1], np.int64), int((~mask).sum())).astype(np.int32)
    return rows, state, torch.from_numpy(mask.astype(np.int32)), torch.from_numpy(ids)


def _row_sums(rows, mask, ids, s):
    """Each ``(segment, column)`` cell's exact (float64) sum of the unmasked
    rows its id addresses; ``ids`` None means one segment, shape ``(F,)``."""
    m = mask.bool()
    if ids is None:
        return rows[m].double().sum(0)
    return torch.zeros((s, rows.shape[1]), dtype=torch.float64).index_add_(0, ids[m].long(), rows[m].double())


def _reassociation_bound(rows, mask, state):
    """Per column, how far two f32 sums of the state and the unmasked rows,
    taken in other orders, can lie apart: each within n * 2**-24 * sum|terms|
    of the exact sum, n the number of terms."""
    m = mask.bool()
    terms = int(m.sum()) + 1
    return 2 * terms * 2.0 ** -24 * (state.double().abs() + rows[m].double().abs().sum(0))


def _check_close(got, want, what, sum_cols, row_sums, reassociation=None):
    """``got`` against ``want`` cell by cell; returns the largest |got - want|.
    Ints, and every column outside ``sum_cols`` (a bool or an ``(F,)`` bool
    tensor), exact; f32 sums within 1e-5 + 1e-6 * scale, or, where the kernel
    folds in an order of its own (K1 and K5: row lanes, a tree, cluster
    ranks), within the larger ``reassociation`` bound per cell; a bf16 sum
    rounds twice in both (the rows' f32 sum, then its add to the state), so
    within 2**-8 * (2|R| + |got| + |want|), R the cell's exact row sum
    (``row_sums``)."""
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape, f"{what}: dtype/shape")
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    diff = torch.where(same, torch.zeros_like(g), (g - w).abs())
    sums = torch.as_tensor(sum_cols).expand(g.shape)
    if got.dtype == torch.int32:
        tol = torch.zeros_like(g)
    elif got.dtype == torch.float32:
        scale = float(w.abs().nan_to_num(posinf=0, neginf=0).max()) if w.numel() else 0.0
        tol = torch.full_like(g, 1e-5 + 1e-6 * scale)
        if reassociation is not None:
            tol = torch.maximum(tol, reassociation.expand(g.shape))
        tol = torch.where(sums, tol, 0.0)
    else:
        tol = torch.where(sums, 2.0 ** -8 * (2 * row_sums.abs() + g.abs() + w.abs()), 0.0)
    bad = ~same & ~(diff <= tol)  # a NaN difference fails too
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} cells off, err {float(diff[bad].max())}")
    return float(diff.max()) if diff.numel() else 0.0


def segment_phase(dev, rng):
    """K4 against its plain version; timed at the unsharded engine's widest
    leaf (64 streams, a 1024-row bucket, binned AP's 1000 f32 columns)."""
    from metrics_tpu_torch.ops.kernels.segment_cuda import segment_reduce_cuda, segment_reduce_plain

    err = {False: 0.0, True: 0.0}  # the f32/int32 cases, the bf16 cases
    cases = []
    for dt in (torch.float32, torch.int32, torch.bfloat16):
        for fx in ("sum", "min", "max"):
            for s in (1, 7, 128, 5000):
                cases.append((dt, fx, 1037, s, 33, "random"))
            cases += [(dt, fx, 300, 7, 1, "one_segment"), (dt, fx, 300, 7, 9, "all_masked"),
                      (dt, fx, 0, 4, 5, "random"), (dt, fx, 1, 1, 1, "random"), (dt, fx, 500, 13000, 3, "random")]
    cases += [(torch.int32, fx, BUCKET, 64, 64, "limits") for fx in ("sum", "min", "max")]
    cases += [(torch.float32, fx, 300, 17, 17, "nan") for fx in ("sum", "min", "max")]
    for dt, fx, n, s, f, pattern in cases:
        rows, state, mask, ids = _segment_case(rng, dt, n, s, f, pattern)
        got = segment_reduce_cuda(state.to(dev), rows.to(dev), mask.to(dev), ids.to(dev), fx)
        want = segment_reduce_plain(state, rows, mask, ids, s, fx)
        e = _check_close(got, want, f"segment {dt}/{fx}/{n}x{f}/S={s}/{pattern}", fx == "sum",
                         _row_sums(rows, mask, ids, s))
        err[dt == torch.bfloat16] = max(err[dt == torch.bfloat16], e)

    def bound(n, s, f, live):  # unmasked rows, mask and ids read once; the state read and written once
        return bound_ms(4 * live * f + 8 * n + 2 * 4 * s * f, live * f)

    n, s, f = BUCKET, 64, NUM_CLASSES * THRESHOLDS
    rows = torch.from_numpy(rng.randint(0, 2, (n, f)).astype(np.float32)).to(dev)
    state = torch.zeros((s, f), device=dev)
    m = torch.from_numpy((rng.rand(n) > 0.1).astype(np.int32)).to(dev)
    ids = torch.from_numpy(rng.randint(0, s, n).astype(np.int32)).to(dev)
    masked_rows, ids64 = rows * m[:, None].float(), ids.long()
    # 0/1 rows: every sum is an integer, so kernel, plain version and library call agree exactly
    got = segment_reduce_cuda(state, rows, m, ids, "sum")
    check(max_abs_err(got, segment_reduce_plain(state, rows, m, ids, s, "sum")) == 0.0,
          "segment: kernel disagrees with its plain version at the main path's shape")
    check(max_abs_err(got, state.index_add(0, ids64, masked_rows)) == 0.0,
          "segment: kernel disagrees with index_add on 0/1 rows")
    entry = {
        "name": "segment_reduce", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/segment.cu",
        "replaces": "metrics_tpu/ops/kernels/pallas_segment.py:57", "shape": f"state ({s}, {f}), rows ({n}, {f}) f32, sum",
        "max_abs_err": err[False], "max_abs_err_bf16": err[True],
        "ms": gpu_ms(lambda: segment_reduce_cuda(state, rows, m, ids, "sum")),
        "plain_ms": gpu_ms(lambda: segment_reduce_plain(state, rows, m, ids, s, "sum")),
        "library_ms": gpu_ms(lambda: state.index_add(0, ids64, masked_rows)),
    }
    entry["bound_ms"], entry["bound_by"] = bound(n, s, f, int(m.sum()))
    entry["traffic"] = "random ids"
    entry["device_us"] = device_us(lambda: segment_reduce_cuda(state, rows, m, ids, "sum"))
    entries = [entry]

    # the step the multi-stream engine sends: one stream's rows, at binned AP's leaf and at a narrow one
    one_rng = np.random.RandomState(SEED + 5)  # its own draws: the entry above keeps its inputs and bound
    for f in (NUM_CLASSES * THRESHOLDS, NUM_CLASSES):
        state = torch.zeros((s, f), device=dev)
        rows, m, ids, sid = _one_stream(one_rng, n, s, f, dev)
        masked_rows, ids64 = rows * m[:, None].float(), torch.where(m.bool(), ids, sid).long()
        got = segment_reduce_cuda(state, rows, m, ids, "sum")
        check(max_abs_err(got, segment_reduce_plain(state, rows, m, ids, s, "sum")) == 0.0,
              f"segment: kernel disagrees with its plain version on one stream, F={f}")
        check(max_abs_err(got, state.index_add(0, ids64, masked_rows)) == 0.0,
              f"segment: kernel disagrees with index_add on one stream's 0/1 rows, F={f}")
        one = {k: entry[k] for k in ("name", "route", "source", "replaces", "max_abs_err", "max_abs_err_bf16")}
        one.update({
            "shape": f"state ({s}, {f}), rows ({n}, {f}) f32, sum", "traffic": "one stream",
            "ms": gpu_ms(lambda: segment_reduce_cuda(state, rows, m, ids, "sum")),
            "plain_ms": gpu_ms(lambda: segment_reduce_plain(state, rows, m, ids, s, "sum")),
            "library_ms": gpu_ms(lambda: state.index_add(0, ids64, masked_rows)),
            "device_us": device_us(lambda: segment_reduce_cuda(state, rows, m, ids, "sum")),
        })
        one["bound_ms"], one["bound_by"] = bound(n, s, f, int(m.sum()))
        entries.append(one)
    return entries


def _one_stream(rng, n, s, f, dev):
    """The engines' one-stream step: 0/1 f32 rows, about 10 % masked; every
    unmasked row carries one stream id, drawn in ``[0, S)``, and masked rows
    garbage ids. Returns rows, int32 mask, int32 ids and the stream id."""
    rows = torch.from_numpy(rng.randint(0, 2, (n, f)).astype(np.float32)).to(dev)
    mask = rng.rand(n) > 0.1
    sid = int(rng.randint(0, s))
    ids = np.full(n, sid, np.int32)
    ids[~mask] = rng.choice(np.array([-7, s, 2**31 - 1], np.int64), int((~mask).sum())).astype(np.int32)
    return rows, torch.from_numpy(mask.astype(np.int32)).to(dev), torch.from_numpy(ids).to(dev), sid


def _op_rows(f):
    """A uniform row per op and a mixed one (runs of each op, as leaves lay
    out), each with its bool mask of sum columns."""
    mixed = np.zeros(f, np.int32)
    mixed[f // 3: 2 * f // 3] = 1
    mixed[2 * f // 3:] = 2
    rows = [(fx, torch.full((f,), i, dtype=torch.int32)) for i, fx in enumerate(("sum", "min", "max"))]
    return [(u, ops, ops == 0) for u, ops in rows + [(None, torch.from_numpy(mixed))]]


def megastep_fold_phase(dev, rng):
    """K5 against its plain version; timed at the flagship arena's f32 buffer
    (3000 columns) over a 1024-row bucket."""
    from metrics_tpu_torch.ops.kernels.megastep_cuda import megastep_fold_cuda, megastep_fold_plain

    err = {False: 0.0, True: 0.0}  # the f32/int32 cases, the bf16 cases
    for dt in (torch.float32, torch.int32, torch.bfloat16):
        for n, f, pattern in ((1037, 300, "random"), (BUCKET, 146, "random"), (0, 7, "random"), (300, 1, "random"),
                              (300, 40, "all_masked"), (BUCKET, 64, "limits" if dt == torch.int32 else "nan")):
            for uniform, ops, sum_cols in _op_rows(f):
                rows, state, mask, _ = _segment_case(rng, dt, n, 1, f, pattern)
                got = megastep_fold_cuda(state[0].to(dev), rows.to(dev), mask.to(dev), ops.to(dev), uniform)
                want = megastep_fold_plain(state[0], rows, mask, ops)
                e = _check_close(got, want, f"megastep_fold {dt}/{uniform}/{n}x{f}/{pattern}", sum_cols,
                                 _row_sums(rows, mask, None, 1), _reassociation_bound(rows, mask, state[0]))
                err[dt == torch.bfloat16] = max(err[dt == torch.bfloat16], e)

    # timed at the flagship arena's two buffers (both uniform sum rows, as phase 7 sends
    # them): 3000 f32 columns and the int32 width ArenaLayout gives, over both buckets
    widths = make_collection(torch.device("cpu")).arena_layout().buffer_sizes()
    head = {"name": "megastep_fold", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/fold.cu",
            "replaces": "metrics_tpu/ops/kernels/pallas_megastep.py:86",
            "max_abs_err": err[False], "max_abs_err_bf16": err[True]}
    entries = []
    for key, dtype in (("float32", torch.float32), ("int32", torch.int32)):
        ops = torch.zeros(widths[key], dtype=torch.int32, device=dev)
        for n in (BUCKET, 256):
            entries.append(_timed_fold(head, lambda s, r, m: megastep_fold_cuda(s, r, m, ops, "sum"),
                                       lambda s, r, m: megastep_fold_plain(s, r, m, ops), dtype, n, widths[key],
                                       rng, dev))
    return entries


def megastep_segment_phase(dev, rng):
    """K6 and K7 against their plain versions, K7 also bit-identical to K6 on
    a host-decoded state; timed at the paged engine's f32 arena: 128 resident
    slots of 3000 columns, a 64-row bucket."""
    from metrics_tpu_torch.ops.kernels.megastep_cuda import (
        megastep_segment_cuda,
        megastep_segment_plain,
        megastep_segment_q8_cuda,
    )

    err6 = {False: 0.0, True: 0.0}  # the f32/int32 cases, the bf16 cases
    err7 = {False: 0.0, True: 0.0}
    for dt in (torch.float32, torch.int32, torch.bfloat16):
        for n, s, f, pattern in ((1037, 7, 33, "random"), (300, 128, 300, "random"), (200, 5000, 3, "random"),
                                 (300, 7, 9, "one_segment"), (300, 7, 9, "all_masked"), (0, 4, 5, "random"),
                                 (64, 1, 1, "random"), (BUCKET, 64, 64, "limits" if dt == torch.int32 else "nan")):
            for uniform, ops, sum_cols in _op_rows(f):
                rows, state, mask, ids = _segment_case(rng, dt, n, s, f, pattern)
                got = megastep_segment_cuda(state.to(dev), rows.to(dev), mask.to(dev), ids.to(dev), ops.to(dev),
                                            uniform)
                want = megastep_segment_plain(state, rows, mask, ids, ops)
                e = _check_close(got, want, f"megastep_segment {dt}/{uniform}/{n}x{f}/S={s}/{pattern}", sum_cols,
                                 _row_sums(rows, mask, ids, s))
                err6[dt == torch.bfloat16] = max(err6[dt == torch.bfloat16], e)
    # K7: flagged slots decode, touched or not, also with no rows
    for dt in (torch.float32, torch.bfloat16):
        for n, s, f in ((0, 16, 96), (211, 16, 96), (BUCKET, 128, 300), (5, 1, 1)):
            for uniform, ops, sum_cols in _op_rows(f):
                rows, state, mask, ids = _segment_case(rng, dt, n, s, f, "random")
                ids = torch.where(mask.bool(), ids % max(s // 2, 1), ids)  # the upper slots stay untouched
                flags = torch.from_numpy((np.arange(s) % 3 != 1).astype(np.int32))
                codes = torch.from_numpy(rng.randint(-127, 128, (s, f)).astype(np.int8))
                scales = torch.from_numpy((rng.rand(s, f) * 1e-2).astype(np.float32))
                qcol = torch.from_numpy((np.arange(f) % 4 != 3).astype(np.int32))
                q8 = (flags, codes, scales, qcol)
                got = megastep_segment_q8_cuda(state.to(dev), rows.to(dev), mask.to(dev), ids.to(dev), ops.to(dev),
                                               uniform, *(t.to(dev) for t in q8))
                want = megastep_segment_plain(state, rows, mask, ids, ops, q8=q8)
                what = f"megastep_segment_q8 {dt}/{uniform}/{n}x{f}/S={s}"
                e = _check_close(got, want, what, sum_cols, _row_sums(rows, mask, ids, s))
                err7[dt == torch.bfloat16] = max(err7[dt == torch.bfloat16], e)
                on = (flags[:, None] != 0) & (qcol[None, :] != 0)
                decoded = torch.where(on, (codes.float() * scales).to(dt), state)  # the host codec's arithmetic
                twin = megastep_segment_cuda(decoded.to(dev), rows.to(dev), mask.to(dev), ids.to(dev), ops.to(dev),
                                             uniform)
                torch.cuda.synchronize()
                check(torch.equal(got, twin), f"{what}: not bit-identical to K6 on the host-decoded state")

    n, s, f = 64, 128, 3 * NUM_CLASSES * THRESHOLDS
    rows = torch.from_numpy(rng.randint(0, 2, (n, f)).astype(np.float32)).to(dev)
    state = torch.zeros((s, f), device=dev)
    m = torch.from_numpy((rng.rand(n) > 0.1).astype(np.int32)).to(dev)
    ids = torch.from_numpy(rng.randint(0, s, n).astype(np.int32)).to(dev)
    ops = torch.zeros(f, dtype=torch.int32, device=dev)
    masked_rows, ids64 = rows * m[:, None].float(), ids.long()
    flags = torch.zeros(s, dtype=torch.int32, device=dev)
    flagged = 4  # a few slots paged in per step, as in the engine
    flags[:flagged] = 1
    codes = torch.from_numpy(rng.randint(-127, 128, (s, f)).astype(np.int8)).to(dev)
    scales = torch.from_numpy(rng.rand(s, f).astype(np.float32)).to(dev)
    qcol = torch.ones(f, dtype=torch.int32, device=dev)
    q8 = (flags, codes, scales, qcol)
    # 0/1 rows: every sum is an integer, so kernel, plain version and library
    # call agree exactly; K7 adds each decoded seed once, as its plain version does
    got = megastep_segment_cuda(state, rows, m, ids, ops, "sum")
    check(max_abs_err(got, megastep_segment_plain(state, rows, m, ids, ops)) == 0.0,
          "megastep_segment: kernel disagrees with its plain version at the main path's shape")
    check(max_abs_err(got, state.index_add(0, ids64, masked_rows)) == 0.0,
          "megastep_segment: kernel disagrees with index_add on 0/1 rows")
    check(max_abs_err(megastep_segment_q8_cuda(state, rows, m, ids, ops, "sum", *q8),
                      megastep_segment_plain(state, rows, m, ids, ops, q8=q8)) == 0.0,
          "megastep_segment_q8: kernel disagrees with its plain version at the main path's shape")
    qcols = int(qcol.sum())
    state_read = 4 * ((s - flagged) * f + flagged * (f - qcols))

    def k6_bound(live):  # unmasked rows, mask and ids read once; the arena read and written once
        return bound_ms(4 * live * f + 8 * n + 2 * 4 * s * f, live * f)

    def k7_bound(live):  # as K6, plus the flags and the column mask, and the codes and scales of the
        # flagged slots only; those slots' quantized columns are decoded, not read
        return bound_ms(4 * live * f + 8 * n + state_read + 4 * s * f + 4 * s + 4 * f + 5 * flagged * qcols,
                        live * f + flagged * qcols)

    live = int(m.sum())
    k6 = {
        "name": "megastep_segment", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/segment.cu",
        "replaces": "metrics_tpu/ops/kernels/pallas_megastep.py:210",
        "shape": f"arena ({s}, {f}), rows ({n}, {f}) f32, sum",
        "max_abs_err": err6[False], "max_abs_err_bf16": err6[True],
        "ms": gpu_ms(lambda: megastep_segment_cuda(state, rows, m, ids, ops, "sum")),
        "plain_ms": gpu_ms(lambda: megastep_segment_plain(state, rows, m, ids, ops)),
        "library_ms": gpu_ms(lambda: state.index_add(0, ids64, masked_rows)),
    }
    k6["bound_ms"], k6["bound_by"] = k6_bound(live)  # a uniform op row is not read
    k7 = {
        "name": "megastep_segment_q8", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/segment.cu",
        "replaces": "metrics_tpu/ops/kernels/pallas_megastep.py:258",
        "shape": f"arena ({s}, {f}), rows ({n}, {f}) f32, sum, {flagged} staged slots",
        "max_abs_err": err7[False], "max_abs_err_bf16": err7[True],
        "ms": gpu_ms(lambda: megastep_segment_q8_cuda(state, rows, m, ids, ops, "sum", *q8)),
        "plain_ms": gpu_ms(lambda: megastep_segment_plain(state, rows, m, ids, ops, q8=q8)),
        "library_ms": None,
    }
    k7["bound_ms"], k7["bound_by"] = k7_bound(live)
    k6["traffic"] = k7["traffic"] = "random ids"
    k6["device_us"] = device_us(lambda: megastep_segment_cuda(state, rows, m, ids, ops, "sum"))
    k7["device_us"] = device_us(lambda: megastep_segment_q8_cuda(state, rows, m, ids, ops, "sum", *q8))

    # the step the paged engine sends: one stream's rows into its slot, just paged in (flagged)
    one_rng = np.random.RandomState(SEED + 6)  # its own draws: the entries above keep their inputs and bounds
    rows, m, ids, sid = _one_stream(one_rng, n, s, f, dev)
    masked_rows, ids64 = rows * m[:, None].float(), torch.where(m.bool(), ids, sid).long()
    flags = torch.zeros(s, dtype=torch.int32, device=dev)
    flags[[sid] + [x for x in range(s) if x != sid][:flagged - 1]] = 1
    q8 = (flags, codes, scales, qcol)
    got = megastep_segment_cuda(state, rows, m, ids, ops, "sum")
    check(max_abs_err(got, megastep_segment_plain(state, rows, m, ids, ops)) == 0.0,
          "megastep_segment: kernel disagrees with its plain version on one stream")
    check(max_abs_err(got, state.index_add(0, ids64, masked_rows)) == 0.0,
          "megastep_segment: kernel disagrees with index_add on one stream's 0/1 rows")
    got = megastep_segment_q8_cuda(state, rows, m, ids, ops, "sum", *q8)
    check(max_abs_err(got, megastep_segment_plain(state, rows, m, ids, ops, q8=q8)) == 0.0,
          "megastep_segment_q8: kernel disagrees with its plain version on one stream")
    decoded = torch.where((flags[:, None] != 0) & (qcol[None, :] != 0), codes.float() * scales, state)
    twin = megastep_segment_cuda(decoded, rows, m, ids, ops, "sum")
    torch.cuda.synchronize()
    check(torch.equal(got, twin), "megastep_segment_q8: not bit-identical to K6 on the host-decoded state, one stream")
    live = int(m.sum())
    keys = ("name", "route", "source", "replaces", "max_abs_err", "max_abs_err_bf16")
    k6_one = {k: k6[k] for k in keys}
    k6_one.update({
        "shape": k6["shape"], "traffic": "one stream",
        "ms": gpu_ms(lambda: megastep_segment_cuda(state, rows, m, ids, ops, "sum")),
        "plain_ms": gpu_ms(lambda: megastep_segment_plain(state, rows, m, ids, ops)),
        "library_ms": gpu_ms(lambda: state.index_add(0, ids64, masked_rows)),
        "device_us": device_us(lambda: megastep_segment_cuda(state, rows, m, ids, ops, "sum")),
    })
    k6_one["bound_ms"], k6_one["bound_by"] = k6_bound(live)
    k7_one = {k: k7[k] for k in keys}
    k7_one.update({
        "shape": k7["shape"], "traffic": "one stream",
        "ms": gpu_ms(lambda: megastep_segment_q8_cuda(state, rows, m, ids, ops, "sum", *q8)),
        "plain_ms": gpu_ms(lambda: megastep_segment_plain(state, rows, m, ids, ops, q8=q8)),
        "library_ms": None,
        "device_us": device_us(lambda: megastep_segment_q8_cuda(state, rows, m, ids, ops, "sum", *q8)),
    })
    k7_one["bound_ms"], k7_one["bound_by"] = k7_bound(live)
    return [k6, k6_one], [k7, k7_one]


# ------------------------------------------------------------------------- main path

def make_collection(device, ap_precision=None):
    from metrics_tpu_torch import Accuracy, BinnedAveragePrecision, ConfusionMatrix, F1Score, MetricCollection

    return MetricCollection({
        "acc": Accuracy(device=device),
        "f1": F1Score(num_classes=NUM_CLASSES, average="macro", device=device),
        "binned_ap": BinnedAveragePrecision(num_classes=NUM_CLASSES, thresholds=THRESHOLDS, device=device,
                                            sync_precision=ap_precision),
        "confmat": ConfusionMatrix(num_classes=NUM_CLASSES, device=device),
    })


def flat_values(values):
    out = {}
    for k, v in values.items():
        v = torch.stack(list(v)) if isinstance(v, list) else v
        out[k] = v.detach().double().cpu()
    return out


def oracle_states(preds, target):
    """Every count of the collection from numpy alone."""
    c = NUM_CLASSES
    pred_label = preds.argmax(1)
    onehot = np.eye(c, dtype=bool)[target]
    pos = np.eye(c, dtype=bool)[pred_label]
    thr = np.linspace(0, 1, THRESHOLDS, dtype=np.float32)
    tp = np.zeros((c, THRESHOLDS)); fp = np.zeros_like(tp); fn = np.zeros_like(tp)
    for lo in range(0, len(preds), BATCH):
        ge = preds[lo:lo + BATCH, :, None] >= thr[None, None, :]
        y = onehot[lo:lo + BATCH, :, None]
        tp += (y & ge).sum(0); fp += (~y & ge).sum(0); fn += (y & ~ge).sum(0)
    macro = {"tp": (onehot & pos).sum(0), "fp": (~onehot & pos).sum(0),
             "tn": (~onehot & ~pos).sum(0), "fn": (onehot & ~pos).sum(0)}
    correct = int((pred_label == target).sum())
    n = len(target)
    micro = {"tp": correct, "fp": n - correct, "tn": n * (c - 1) - (n - correct), "fn": n - correct}
    return {
        "acc": micro,
        "f1": macro,
        "binned_ap": {"TPs": tp, "FPs": fp, "FNs": fn},
        "confmat": {"confmat": np.bincount(target * c + pred_label, minlength=c * c).reshape(c, c)},
    }


def compare_states(got, want, what):
    """Every leaf of ``got`` equal to ``want``'s: same dtype where ``want`` is a
    tensor of the port, same values always."""
    for k, member in want.items():
        for s, w in member.items():
            g = got[k][s].detach().cpu()
            if isinstance(w, torch.Tensor):
                check(g.dtype == w.dtype, f"{what}: {k}.{s} dtype {g.dtype} != {w.dtype}")
            w = torch.as_tensor(np.asarray(w.cpu() if isinstance(w, torch.Tensor) else w))
            check(g.shape == w.shape and torch.equal(g.double(), w.double()), f"{what}: {k}.{s} differs")


def main_path(dev, preds, target):
    """The flagship step: ``update`` over the rows in batches, then ``compute``."""
    coll = make_collection(dev)
    t0 = time.perf_counter()
    for lo in range(0, N_ROWS, BATCH):
        coll.update(preds[lo:lo + BATCH], target[lo:lo + BATCH])
    values = flat_values(coll.compute())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    state = {k: {s: getattr(m, s) for s in m._defaults} for k, m in coll.items(keep_base=True)}
    return state, values, seconds


def masked_path(dev, preds, target, rng, make=make_collection):
    coll = make(dev)
    state = coll.init_state()
    lo, buckets = 0, 0
    t0 = time.perf_counter()
    while lo < N_ROWS:
        valid = min(int(rng.randint(BUCKET // 2, BUCKET + 1)), N_ROWS - lo)
        p = rng.randn(BUCKET, NUM_CLASSES).astype(np.float32) * 1e3  # garbage padding
        p[valid:][::5] = np.nan
        t = rng.randint(-3, NUM_CLASSES + 5, BUCKET)
        p[:valid], t[:valid] = preds[lo:lo + valid], target[lo:lo + valid]
        mask = np.arange(BUCKET) < valid
        state = coll.update_state_masked(state, torch.from_numpy(p).to(dev), torch.from_numpy(t).to(dev),
                                         mask=torch.from_numpy(mask).to(dev))
        lo += valid
        buckets += 1
    check(valid < BUCKET, "the last bucket must be partly masked")
    values = flat_values(coll.compute_from(state))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return state, values, buckets, time.perf_counter() - t0


def zipf_stream_ids(num_streams, n, alpha, seed):
    """``n`` stream ids in ``[0, num_streams)`` from a bounded Zipf(alpha): rank
    ``r`` has probability ~ ``1/(r+1)**alpha`` and maps to an id through a
    seeded permutation (the draw of ``metrics_tpu/engine/traffic.py``)."""
    rng = np.random.RandomState(seed)
    w = 1.0 / np.power(np.arange(1, num_streams + 1, dtype=np.float64), float(alpha))
    perm = np.random.RandomState(seed ^ 0x5A1F).permutation(num_streams)
    return perm[rng.choice(num_streams, size=int(n), p=w / w.sum())].astype(np.int32)


def ragged_batches(seed, lo, hi):
    """Consecutive ``[start, stop)`` row ranges of ``lo``..``hi`` rows over the main path's rows."""
    rng = np.random.RandomState(seed)
    out, start = [], 0
    while start < N_ROWS:
        stop = min(N_ROWS, start + int(rng.randint(lo, hi + 1)))
        out.append((start, stop))
        start = stop
    return out


def run_engine(eng, capture, batches, submit):
    """Drive ``eng`` through its entry points (``with`` + ``submit``): host
    seconds from the first submit until the dispatcher has drained and the
    device finished. ``capture=False`` takes the uncaptured step."""
    eng._capture = capture
    t0 = time.perf_counter()
    with eng:
        for b in batches:
            submit(eng, b)
    return time.perf_counter() - t0


def streaming_megastep_phase(dev, preds, target, capture=True, aot_cache=None):
    """Phase 7: the megastep engine over the main path's rows, ragged."""
    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine

    eng = StreamingEngine(make_collection(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep"),
                          aot_cache=aot_cache)
    seconds = run_engine(eng, capture, ragged_batches(SEED + 2, 16, BUCKET),
                         lambda e, b: e.submit(preds[b[0]:b[1]], target[b[0]:b[1]]))
    check(eng.stats.kernel_fallbacks_by_reason() == {}, f"megastep engine fell back: {eng.stats.kernel_fallbacks}")
    return eng, seconds


def stream_rows(sids, batches):
    """Row indices of every stream, in submit order."""
    rows = {}
    for sid, (start, stop) in zip(sids, batches):
        rows.setdefault(int(sid), []).append(np.arange(start, stop))
    return {sid: np.concatenate(r) for sid, r in rows.items()}


def check_streams(eng, per_stream, preds_np, target_np, streams, what, int_only=False):
    """Every listed stream's state against the numpy oracle over its rows."""
    empty = np.zeros(0, np.int64)
    for sid in streams:
        idx = per_stream.get(sid, empty)
        want = oracle_states(preds_np[idx], target_np[idx])
        if int_only:
            want = {k: v for k, v in want.items() if k != "binned_ap"}
        compare_states(eng.stream_state(sid), want, f"{what}: stream {sid}")


def dispatcher_alone(dev, preds, target, aot_cache):
    """Phase 7's batches through a warm engine (sharing ``aot_cache``: no
    capture) twice: the producer submitting while the dispatcher steps (the
    two threads share the interpreter lock), and the producer first, alone,
    with the dispatcher held on the engine's state lock, then the dispatcher
    draining the whole backlog alone. Host seconds per step of each, and the
    producer's host µs per ``submit``."""
    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine

    batches = ragged_batches(SEED + 2, 16, BUCKET)
    out = {}
    for mode in ("together", "apart"):
        eng = StreamingEngine(make_collection(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep",
                                                                 max_queue=len(batches)), aot_cache=aot_cache)
        eng.start()
        held = eng._state_lock if mode == "apart" else contextlib.nullcontext()
        t0 = time.perf_counter()
        with held:
            for start, stop in batches:
                eng.submit(preds[start:stop], target[start:stop])
            t_submit = time.perf_counter()
        eng.stop()
        t_end = time.perf_counter()
        check(eng.stats.warmup_steps == 0, "dispatcher_alone: the warm engine captured")
        out[mode] = {"steps": eng.steps, "submit_us_per_batch": (t_submit - t0) / len(batches) * 1e6,
                     "s_per_step": (t_end - (t_submit if mode == "apart" else t0)) / eng.steps}
    return out


def multistream_phase(dev, preds, target, preds_np, target_np, capture=True):
    """Phase 8: the unsharded engine, 64 streams, Zipf stream ids."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine

    batches = ragged_batches(SEED + 3, 16, BUCKET)
    sids = zipf_stream_ids(MS_STREAMS, len(batches), ALPHA, SEED + 3)
    eng = MultiStreamEngine(make_collection(dev), MS_STREAMS, EngineConfig(buckets=(256, BUCKET)))
    seconds = run_engine(eng, capture, list(zip(sids, batches)),
                         lambda e, b: e.submit(int(b[0]), preds[b[1][0]:b[1][1]], target[b[1][0]:b[1][1]]))
    if capture:
        check_streams(eng, stream_rows(sids, batches), preds_np, target_np, range(MS_STREAMS), "multistream")
    return eng, seconds


def paged_phase(dev, preds, target, preds_np, target_np, q8, stage=True, capture=True, coalesce=8):
    """Phase 9: the paged engine, 10 000 streams in 128 slots under "megastep"."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine

    batches = ragged_batches(SEED + 4, 8, 64)
    sids = zipf_stream_ids(PAGED_STREAMS, len(batches), ALPHA, SEED + 4)
    eng = MultiStreamEngine(make_collection(dev, ap_precision="q8_block" if q8 else None), PAGED_STREAMS,
                            EngineConfig(buckets=PAGED_BUCKETS, kernel_backend="megastep", compress_payloads=q8,
                                         coalesce=coalesce),
                            stream_shard=True, resident_streams=RESIDENT)
    if not stage:  # the twin: spilled rows decode on the host before seating
        eng._q8_enabled = False
        eng._q8_reset_stage()
    seconds = run_engine(eng, capture, list(zip(sids, batches)),
                         lambda e, b: e.submit(int(b[0]), preds[b[1][0]:b[1][1]], target[b[1][0]:b[1][1]]))
    per_stream = stream_rows(sids, batches)
    st = eng.stats
    check(st.page_outs > 0, "paged: nothing was spilled")
    check(st.page_ins > len(per_stream), "paged: no spilled row was paged back in")  # first touches load init rows
    if capture:
        untouched = [s for s in range(0, PAGED_STREAMS, 97) if s not in per_stream][:20]
        check_streams(eng, per_stream, preds_np, target_np, sorted(per_stream) + untouched,
                      f"paged q8={q8} stage={stage}", int_only=q8)
    return eng, seconds, per_stream


def engine_states_equal(a, b, streams, what):
    """Two multi-stream engines' states, stream by stream, bit for bit: every
    listed stream's rows out of one reassembly of all streams per engine
    (``state()``), not one flushed read per stream."""
    x, y = stacked_host(a), stacked_host(b)
    idx = np.asarray(list(streams), np.int64)
    for k in x:
        for s in x[k]:
            g, w = x[k][s][idx], y[k][s][idx]
            if g.dtype != w.dtype or not np.array_equal(g, w):
                rows = np.nonzero((g != w).reshape(len(idx), -1).any(axis=1))[0]
                check(False, f"{what}: {k}.{s} ({g.dtype} / {w.dtype}) differs, first at stream "
                             f"{idx[rows[0]] if rows.size else None}")


def check_cache(eng, what, signatures=1):
    """A cold engine captures at most one step per bucket and signature."""
    misses = eng.aot_cache.misses
    check(misses <= signatures * len(eng._cfg.buckets),
          f"{what}: {misses} captures for {len(eng._cfg.buckets)} buckets")
    return eng.aot_cache.stats()


def profile_bucket(dev, preds, target, make=make_collection):
    """Device-busy share of one megastep bucket of ``make``'s collection
    through the engine's entry points (``submit`` + ``flush``: the
    dispatcher's captured graph replay, and the uncaptured step) and of one
    per-leaf masked bucket (``update_state_masked``): the kernel time of a
    torch.profiler trace of one bucket over the bucket's host wall time
    without the profiler (median of 5)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine

    engines = {}
    for name, capture in (("megastep_bucket_captured", True), ("megastep_bucket_uncaptured", False)):
        eng = engines[name] = StreamingEngine(make(dev), EngineConfig(buckets=(BUCKET,), kernel_backend="megastep"))
        eng._capture = capture
        eng.start()
    coll = make(dev)
    p, t = preds[:BUCKET], target[:BUCKET]
    mask = torch.ones(BUCKET, dtype=torch.bool, device=dev)

    def bucket(eng):
        eng.submit(p, t)
        eng.flush()

    runs = {name: (lambda e=eng: bucket(e)) for name, eng in engines.items()}
    runs["masked_bucket"] = lambda: coll.update_state_masked(coll.init_state(), p, t, mask=mask)
    out = {}
    for name, fn in runs.items():
        walls = []
        for _ in range(6):  # the first run warms up
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e6)
        wall_us = float(np.median(walls[1:]))
        for _ in range(3):  # a trace now and then comes back without its device events: take another
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            # device-side entries only (kernels, memcpys): a CPU op's self device
            # time repeats the time of the kernels it launched
            device = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
            busy = {e.key: e.self_device_time_total for e in device}
            total = float(sum(busy.values()))
            if total > 0:
                break
        # device_ops: distinct kernel names; device_launches: every kernel, memset and copy
        out[name] = {"wall_us": wall_us, "device_busy_us": total, "device_busy_share": total / wall_us,
                     "device_ops": len(busy), "device_launches": sum(e.count for e in device),
                     "top": [(k[:60], v) for k, v in sorted(busy.items(), key=lambda kv: -kv[1])[:6]]}
    for eng in engines.values():
        eng.stop()
    for name in engines:
        check(out[name]["device_busy_us"] > 0, f"profiler: no device time in the {name}")
    return out


def kernel_wrappers():
    """The kernel wrappers K1-K7 by name, each with its ``.launches`` count."""
    from metrics_tpu_torch.ops.binned_update import binned_counts_cuda
    from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda
    from metrics_tpu_torch.ops.kernels.megastep_cuda import (
        megastep_fold_cuda,
        megastep_segment_cuda,
        megastep_segment_q8_cuda,
    )
    from metrics_tpu_torch.ops.kernels.segment_cuda import segment_reduce_cuda

    return {"fold_rows": fold_rows_cuda, "histogram": histogram_cuda, "binned_counts": binned_counts_cuda,
            "segment_reduce": segment_reduce_cuda, "megastep_fold": megastep_fold_cuda,
            "megastep_segment": megastep_segment_cuda, "megastep_segment_q8": megastep_segment_q8_cuda}


def counts():
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def delta(before):
    now = counts()
    return {k: now[k] - before[k] for k in now}


def main_rows(dev):
    """The main path's seeded rows: ``(preds, target)`` on ``dev`` and as numpy."""
    data_rng = np.random.RandomState(SEED)
    preds_np = data_rng.rand(N_ROWS, NUM_CLASSES).astype(np.float32)
    preds_np /= preds_np.sum(axis=1, keepdims=True)
    target_np = data_rng.randint(0, NUM_CLASSES, N_ROWS)
    return torch.from_numpy(preds_np).to(dev), torch.from_numpy(target_np).to(dev), preds_np, target_np


def engine_phases(dev, preds, target, preds_np, target_np, gpu_state):
    """Phases 7-9: every engine in its production form (dispatcher, captured
    steps), with the uncaptured twins, the warm twin, the oracle, twin and
    launch checks. Returns the phases' numbers."""
    phases = {}

    def per_step(eng):  # every step the card ran: the served ones and each capture's warm-up
        return eng.steps + eng.stats.warmup_steps

    # phase 7: the megastep engine; 2 K5 launches per step, no K1
    before = counts()
    mega_eng, seconds = streaming_megastep_phase(dev, preds, target)
    d = delta(before)
    n7 = per_step(mega_eng)
    check(d["megastep_fold"] == 2 * n7 and d["fold_rows"] == 0,
          f"megastep engine: {d['megastep_fold']} K5 and {d['fold_rows']} K1 launches in {n7} steps")
    compare_states(mega_eng.state(), gpu_state, "megastep engine vs one-shot")
    check(d["histogram"] == n7, "megastep engine: K2 not one launch per step")
    aot7 = check_cache(mega_eng, "megastep engine")
    # its warm twin shares the cache: every step a hit, nothing captured
    before = counts()
    twin_eng, twin_seconds = streaming_megastep_phase(dev, preds, target, aot_cache=mega_eng.aot_cache)
    dt = delta(before)
    check(twin_eng.aot_cache.misses == aot7["misses"] and twin_eng.stats.warmup_steps == 0,
          f"warm twin engine captured: {twin_eng.aot_cache.stats()}")
    check(dt["megastep_fold"] == 2 * twin_eng.steps and dt["histogram"] == twin_eng.steps,
          "warm twin engine: launches not credited per replay")
    compare_states(twin_eng.state(), gpu_state, "warm twin engine vs one-shot")
    unc_eng, unc_seconds = streaming_megastep_phase(dev, preds, target, capture=False)
    compare_states(unc_eng.state(), mega_eng.state(), "megastep engine: captured vs uncaptured")
    phases["streaming_megastep"] = {
        "seconds": seconds, "steps": mega_eng.steps, "warmup_steps": mega_eng.stats.warmup_steps,
        "megasteps": mega_eng.stats.megasteps, "batches": mega_eng.stats.batches_submitted,
        "s_per_step": seconds / mega_eng.steps, "launches": d, "aot": aot7,
        "uncaptured": {"seconds": unc_seconds, "steps": unc_eng.steps, "s_per_step": unc_seconds / unc_eng.steps},
        "warm_twin": {"seconds": twin_seconds, "steps": twin_eng.steps, "aot": twin_eng.aot_cache.stats()},
        "dispatcher_alone": dispatcher_alone(dev, preds, target, mega_eng.aot_cache),
    }

    # phase 8: unsharded multi-stream; K4 on every step (one per state leaf)
    before = counts()
    ms_eng, seconds = multistream_phase(dev, preds, target, preds_np, target_np)
    d = delta(before)
    n8 = per_step(ms_eng)
    n_leaves = ms_eng.arena_layout.num_leaves
    check(d["segment_reduce"] == n_leaves * n8, "multistream: K4 did not launch once per leaf on every step")
    check(d["histogram"] == n8, "multistream: K2 not one launch per step")
    unc_eng, unc_seconds = multistream_phase(dev, preds, target, preds_np, target_np, capture=False)
    engine_states_equal(ms_eng, unc_eng, range(MS_STREAMS), "multistream: captured vs uncaptured")
    ms_results = results_timing(ms_eng, range(MS_STREAMS))
    phases["multistream"] = {
        "seconds": seconds, "steps": ms_eng.steps, "warmup_steps": ms_eng.stats.warmup_steps,
        "megasteps": ms_eng.stats.megasteps, "batches": ms_eng.stats.batches_submitted,
        "s_per_step": seconds / ms_eng.steps, "streams": MS_STREAMS, "launches": d,
        "aot": check_cache(ms_eng, "multistream"),
        "uncaptured": {"seconds": unc_seconds, "steps": unc_eng.steps, "s_per_step": unc_seconds / unc_eng.steps},
        "results": ms_results,
    }

    # phase 9: paged, (a) exact, coalesced and not, (b) q8 staged decode, (c) (b)'s host-decode twin
    for name, q8, stage, coalesce in (("paged_exact", False, True, 8), ("paged_exact_coalesce1", False, True, 1),
                                      ("paged_q8", True, True, 1), ("paged_q8_twin", True, False, 1)):
        before = counts()
        eng, seconds, per_stream = paged_phase(dev, preds, target, preds_np, target_np, q8, stage, coalesce=coalesce)
        st = eng.stats
        d = delta(before)
        n9 = per_step(eng)
        phases[name] = {"seconds": seconds, "steps": eng.steps, "warmup_steps": st.warmup_steps,
                        "megasteps": st.megasteps, "batches_coalesced": st.batches_coalesced,
                        "batches": st.batches_submitted, "s_per_step": seconds / eng.steps, "coalesce": coalesce,
                        "streams": PAGED_STREAMS, "resident": RESIDENT, "touched": len(per_stream),
                        "page_ins": st.page_ins, "page_outs": st.page_outs, "page_hits": st.page_hits,
                        "q8_staged_rows": st.q8_staged_rows, "launches": d,
                        "aot": check_cache(eng, name)}
        # one launch per arena dtype per step: K7 for the staged f32 arena of (b), K6 for the rest
        k7_per_step = 1 if name == "paged_q8" else 0
        check(d["megastep_segment"] == (2 - k7_per_step) * n9 and d["megastep_segment_q8"] == k7_per_step * n9,
              f"{name}: {d['megastep_segment']} K6 and {d['megastep_segment_q8']} K7 launches in {n9} steps")
        check(d["histogram"] == n9, f"{name}: K2 not one launch per step")
        if name == "paged_exact":
            check(st.megasteps > 0, "paged: no queued batches coalesced")
            exact_eng, exact_streams = eng, sorted(per_stream)
            unc_eng, unc_seconds, _ = paged_phase(dev, preds, target, preds_np, target_np, False, capture=False)
            engine_states_equal(eng, unc_eng, exact_streams, "paged: captured vs uncaptured")
            phases[name]["uncaptured"] = {"seconds": unc_seconds, "steps": unc_eng.steps,
                                          "s_per_step": unc_seconds / unc_eng.steps}
            phases[name]["results"] = results_timing(eng, result_sample(eng, per_stream))
        if name == "paged_exact_coalesce1":
            check(st.megasteps == 0, "paged coalesce=1: a step carried several batches")
            engine_states_equal(exact_eng, eng, exact_streams, "paged: coalesced vs not")
        if name == "paged_q8":
            check(st.q8_staged_rows > 0, "paged q8: no spilled row was seated for K7 to decode")
            q8_eng, q8_streams = eng, sorted(per_stream)
        if name == "paged_q8_twin":
            check(st.q8_staged_rows == 0, "paged twin: staged anyway")
            engine_states_equal(q8_eng, eng, q8_streams, "paged q8 vs twin")
    return phases


# ------------------------------------------------------- phase 10: the dashboard

CAL_BINS = 15
RESULT_SAMPLES = 200  # streams whose result() is held against results(), as stream_bench samples them


def make_dashboard(device):
    """The classification dashboard: every counting metric the engines serve."""
    from metrics_tpu_torch import (CohenKappa, HammingDistance, HingeLoss, JaccardIndex, MatthewsCorrCoef,
                                   MetricCollection, Precision, Recall, Specificity)

    c = NUM_CLASSES
    return MetricCollection({
        "precision": Precision(average="macro", num_classes=c, device=device),
        "recall": Recall(average="macro", num_classes=c, device=device),
        "specificity": Specificity(average="macro", num_classes=c, device=device),
        "hamming": HammingDistance(device=device),
        "jaccard": JaccardIndex(num_classes=c, device=device),
        "kappa": CohenKappa(num_classes=c, device=device),
        "mcc": MatthewsCorrCoef(num_classes=c, device=device),
        "hinge": HingeLoss(device=device),
    })


def dashboard_oracle(preds, target):
    """Every count of the dashboard from numpy alone, and its hinge measure
    (Crammer-Singer: 1 minus the true class's score over the best other, at
    least 0) in float64 with the absolute sum of its terms."""
    base = oracle_states(preds, target)
    macro, cm = base["f1"], base["confmat"]["confmat"]
    n, c = len(target), NUM_CLASSES
    rows = np.arange(n)
    p = preds.astype(np.float64)
    other = p.copy()
    other[rows, target] = -np.inf
    terms = np.maximum(0.0, 1.0 - (p[rows, target] - other.max(1)))
    # one-hot preds against one-hot targets: a wrong row differs in two places
    counts = {"precision": macro, "recall": macro, "specificity": macro,
              "hamming": {"correct": n * c - 2 * (n - int(np.trace(cm))), "total": n * c},
              "jaccard": {"confmat": cm}, "kappa": {"confmat": cm}, "mcc": {"confmat": cm}, "hinge": {"total": n}}
    return counts, float(terms.sum()), float(np.abs(terms).sum())


def check_dashboard_state(state, oracle, what):
    """Counts equal to numpy's (``oracle``: :func:`dashboard_oracle` of the
    same rows); the f32 hinge measure within the reassociation bound of its
    float64 sum (each term rounds twice, the sum of n terms reassociates)."""
    counts, measure, abs_sum = oracle
    compare_states(state, counts, what)
    got = float(state["hinge"]["measure"])
    tol = (2 * counts["hinge"]["total"] + 4) * 2.0**-24 * abs_sum
    check(abs(got - measure) <= tol, f"{what}: hinge measure {got} vs {measure} (tol {tol})")
    return tol


def close_value(got, want, what, slack=0.0):
    """One metric value against another: within 1e-6 relative plus 1e-6
    absolute (f32 arithmetic on the same counts in another order: a value
    near 0 such as a kappa of 1 - 0.99 keeps the absolute error of its
    terms), plus ``slack``, what reassociated f32 sums can move it."""
    g, w = float(got), float(want)
    ok = abs(g - w) <= 1e-6 * abs(w) + 1e-6 + slack or (np.isnan(g) and np.isnan(w))
    check(ok, f"{what}: {g} vs {w} (slack {slack})")


def same_values(got, want, what):
    """Two value trees leaf by leaf: integers exact, floats by :func:`close_value`."""
    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in leaves(v)]
        return [tree.detach().cpu()]

    a, b = leaves(got), leaves(want)
    check(len(a) == len(b), f"{what}: {len(a)} leaves vs {len(b)}")
    for x, y in zip(a, b):
        check(x.dtype == y.dtype and x.shape == y.shape, f"{what}: dtype/shape {x.dtype} {y.dtype}")
        if x.is_floating_point():
            for g, w in zip(x.reshape(-1).tolist(), y.reshape(-1).tolist()):
                close_value(g, w, what)
        else:
            check(torch.equal(x, y), f"{what}: integers differ")


def calibration_oracle(preds, target):
    """The calibration errors of the main rows in float64 (the port's f32
    bin boundaries, ``searchsorted(left) - 1``, confidence 0 in no bin), each
    with how far f32 bin sums within their reassociation bounds
    (2 * n_b * 2**-24 * the bin's sum) can move it."""
    from metrics_tpu_torch.functional.classification.calibration_error import _bin_boundaries

    conf = preds.max(1)
    acc = (preds.argmax(1) == target).astype(np.float64)
    idx = np.searchsorted(_bin_boundaries(CAL_BINS).numpy(), conf, side="left") - 1
    keep = idx >= 0
    idx = idx[keep]
    count = np.bincount(idx, minlength=CAL_BINS).astype(np.float64)
    conf_sum = np.bincount(idx, weights=conf[keep].astype(np.float64), minlength=CAL_BINS)
    acc_sum = np.bincount(idx, weights=acc[keep], minlength=CAL_BINS)
    safe, prop = np.maximum(count, 1.0), count / len(conf)
    gap = np.abs(acc_sum - conf_sum) / safe
    move = 2 * count * 2.0**-24 * (conf_sum + acc_sum) / safe
    sq, sq_move = (gap**2 * prop).sum(), ((2 * gap * move + move**2) * prop).sum()
    return {"l1": (float((gap * prop).sum()), float((move * prop).sum())),
            "l2": (float(np.sqrt(sq)), float(np.sqrt(sq + sq_move) - np.sqrt(max(sq - sq_move, 0.0)))),
            "max": (float(gap.max()), float(move.max()))}


def kl_inputs(dev):
    """A second seeded softmax distribution over the main rows' classes: KL's ``q``."""
    rng = np.random.RandomState(SEED + 5)
    q = rng.rand(N_ROWS, NUM_CLASSES).astype(np.float32)
    q /= q.sum(axis=1, keepdims=True)
    return torch.from_numpy(q).to(dev), q


def dashboard_eager(dev, preds, target, q):
    """Phase 10(a) on ``dev``: the dashboard's ``update`` over the rows in
    batches, then ``compute``; the calibration error in all three norms
    (K2's weighted form, one launch per ``compute``), KL against ``q`` and
    ``dice_score`` on the same rows."""
    from metrics_tpu_torch import CalibrationError, KLDivergence
    from metrics_tpu_torch.functional import dice_score
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda

    coll = make_dashboard(dev)
    t0 = time.perf_counter()
    for lo in range(0, N_ROWS, BATCH):
        coll.update(preds[lo:lo + BATCH], target[lo:lo + BATCH])
    values = flat_values(coll.compute())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    state = {k: {s: getattr(m, s) for s in m._defaults} for k, m in coll.items(keep_base=True)}
    cal, cal_launches = {}, 0
    for norm in ("l1", "l2", "max"):
        m = CalibrationError(n_bins=CAL_BINS, norm=norm, device=dev)
        m.update(preds, target)
        before = histogram_cuda.launches
        cal[norm] = float(m.compute())
        cal_launches += histogram_cuda.launches - before
    kl = KLDivergence(device=dev)
    kl.update(preds, q)
    return state, values, seconds, cal, cal_launches, float(kl.compute()), float(dice_score(preds, target))


def result_sample(eng, per_stream):
    """200 streams of a paged engine: resident, spilled and never touched."""
    rng = np.random.RandomState(SEED + 6)
    resident = sorted(eng.pager.resident_streams(0))
    spilled = sorted(eng.pager.spilled_streams(0))
    untouched = [s for s in range(eng.num_streams) if s not in per_stream]
    k_res, k_spill = min(50, len(resident)), min(100, len(spilled))
    k_new = RESULT_SAMPLES - k_res - k_spill
    check(k_res > 0 and k_spill > 0 and 0 < k_new <= len(untouched), "result sample: too few streams")
    picks = [rng.choice(resident, k_res, replace=False), rng.choice(spilled, k_spill, replace=False),
             rng.choice(untouched, k_new, replace=False)]
    return sorted(int(s) for p in picks for s in p)


def results_timing(eng, sample):
    """One batched ``results()`` against ``result()`` of each sampled
    stream: one more device computation, equal values. Host ms of the
    ``results()`` (flush, assembly, one vmapped compute, one copy to the
    host) and of the per-stream loop, and the device launches and µs of one
    ``results()`` from a profiler trace."""
    calls = eng.stats.result_device_calls
    t0 = time.perf_counter()
    values = eng.results()
    results_ms = (time.perf_counter() - t0) * 1e3
    check(eng.stats.result_device_calls == calls + 1, "results(): not one device computation")
    t0 = time.perf_counter()
    singles = {sid: eng.result(sid) for sid in sample}
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3
    for sid in sample:
        same_values(values[sid], singles[sid], f"results() vs result({sid})")
    trace = device_trace(eng.results, runs=2)
    return {"streams": eng.num_streams, "results_ms": results_ms,
            "results_device_launches": sum(c for _, c in trace.values()),
            "results_device_us": sum(us for us, _ in trace.values()),
            "sampled_streams": len(sample), "per_stream_result_ms": single_ms,
            "per_stream_result_ms_each": single_ms / len(sample)}


def dashboard_phase(dev, preds, target, preds_np, target_np):
    """Phase 10: the classification dashboard. (a) eager on the card, held
    against the port's CPU run and numpy (with the calibration error, KL and
    dice), and through the per-leaf masked bucket step; (b) the captured
    megastep ``StreamingEngine``; (c) the captured paged ``MultiStreamEngine``
    of phase 9a, then one ``results()``; (d) their times."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine

    out = {}
    q, q_np = kl_inputs(dev)
    gpu = dashboard_eager(dev, preds, target, q)
    cpu = dashboard_eager(torch.device("cpu"), torch.from_numpy(preds_np), torch.from_numpy(target_np),
                          torch.from_numpy(q_np))
    gpu_state, gpu_values, eager_s, cal, cal_launches, kl, dice = gpu
    check(cal_launches == 3, f"calibration error: {cal_launches} K2 launches for 3 computes")
    oracle = dashboard_oracle(preds_np, target_np)
    tol = check_dashboard_state(gpu_state, oracle, "dashboard (card)")
    check_dashboard_state(cpu[0], oracle, "dashboard (CPU)")
    compare_states({k: {s: v for s, v in m.items() if k != "hinge" or s != "measure"} for k, m in gpu_state.items()},
                   {k: {s: v for s, v in m.items() if k != "hinge" or s != "measure"} for k, m in cpu[0].items()},
                   "dashboard: card vs CPU")
    for k, v in gpu_values.items():
        close_value(v, cpu[1][k], f"dashboard value {k}", 2 * tol / N_ROWS if k == "hinge" else 0.0)
    for norm, (want, slack) in calibration_oracle(preds_np, target_np).items():
        close_value(cal[norm], want, f"calibration {norm} (card)", slack)
        close_value(cpu[3][norm], want, f"calibration {norm} (CPU)", slack)
    p64, q64 = preds_np.astype(np.float64), q_np.astype(np.float64)
    p64, q64 = p64 / p64.sum(1, keepdims=True), q64 / q64.sum(1, keepdims=True)
    elems = p64 * np.log(p64 / np.maximum(q64, 1e-6))
    kl_slack = (2 * N_ROWS + 8) * 2.0**-24 * float(np.abs(elems).sum()) / N_ROWS
    close_value(kl, float(elems.sum()) / N_ROWS, "KL divergence (card)", kl_slack)
    close_value(kl, cpu[5], "KL divergence card vs CPU", 2 * kl_slack)
    close_value(dice, cpu[6], "dice score card vs CPU")
    masked_state, _, buckets, masked_s = masked_path(dev, preds_np, target_np, np.random.RandomState(SEED + 1),
                                                     make=make_dashboard)
    check_dashboard_state(masked_state, oracle, "dashboard masked buckets")
    out["eager"] = {"update_compute_s": eager_s, "calibration": cal, "calibration_k2_launches": cal_launches,
                    "kl_divergence": kl, "dice": dice, "masked_buckets": buckets, "masked_update_compute_s": masked_s,
                    "values": {k: float(v) for k, v in gpu_values.items()}}

    # (b) the megastep engine: two K5 launches a step (int32 and f32 arenas), three K2 (one per confusion matrix)
    before = counts()
    eng = StreamingEngine(make_dashboard(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep"))
    seconds = run_engine(eng, True, ragged_batches(SEED + 2, 16, BUCKET),
                         lambda e, b: e.submit(preds[b[0]:b[1]], target[b[0]:b[1]]))
    d = delta(before)
    n = eng.steps + eng.stats.warmup_steps
    check(eng.stats.kernel_fallbacks_by_reason() == {}, f"dashboard megastep fell back: {eng.stats.kernel_fallbacks}")
    check(d["megastep_fold"] == 2 * n and d["fold_rows"] == 0 and d["histogram"] == 3 * n,
          f"dashboard megastep: {d['megastep_fold']} K5, {d['fold_rows']} K1, {d['histogram']} K2 in {n} steps")
    check_dashboard_state(eng.state(), oracle, "dashboard megastep engine")
    out["streaming_megastep"] = {"seconds": seconds, "steps": eng.steps, "warmup_steps": eng.stats.warmup_steps,
                                 "megasteps": eng.stats.megasteps, "s_per_step": seconds / eng.steps,
                                 "launches": d, "aot": check_cache(eng, "dashboard megastep")}

    # (c) the paged engine of phase 9a: two K6 launches a step, three K2; then one results()
    batches = ragged_batches(SEED + 4, 8, 64)
    sids = zipf_stream_ids(PAGED_STREAMS, len(batches), ALPHA, SEED + 4)
    before = counts()
    eng = MultiStreamEngine(make_dashboard(dev), PAGED_STREAMS,
                            EngineConfig(buckets=PAGED_BUCKETS, kernel_backend="megastep", coalesce=8),
                            stream_shard=True, resident_streams=RESIDENT)
    seconds = run_engine(eng, True, list(zip(sids, batches)),
                         lambda e, b: e.submit(int(b[0]), preds[b[1][0]:b[1][1]], target[b[1][0]:b[1][1]]))
    d = delta(before)
    n = eng.steps + eng.stats.warmup_steps
    check(d["megastep_segment"] == 2 * n and d["megastep_segment_q8"] == 0 and d["histogram"] == 3 * n,
          f"dashboard paged: {d['megastep_segment']} K6, {d['histogram']} K2 in {n} steps")
    check(eng.stats.page_outs > 0, "dashboard paged: nothing was spilled")
    per_stream = stream_rows(sids, batches)
    sample = result_sample(eng, per_stream)
    empty = np.zeros(0, np.int64)
    for sid in sample:
        idx = per_stream.get(sid, empty)
        check_dashboard_state(eng.stream_state(sid), dashboard_oracle(preds_np[idx], target_np[idx]),
                              f"dashboard paged stream {sid}")
    st = eng.stats
    out["paged"] = {"seconds": seconds, "steps": eng.steps, "warmup_steps": st.warmup_steps,
                    "megasteps": st.megasteps, "batches": st.batches_submitted, "s_per_step": seconds / eng.steps,
                    "streams": PAGED_STREAMS, "resident": RESIDENT, "touched": len(per_stream),
                    "page_ins": st.page_ins, "page_outs": st.page_outs, "launches": d,
                    "aot": check_cache(eng, "dashboard paged"),
                    # (d) the batched results() against the per-stream loop
                    "results": results_timing(eng, sample)}
    return out


def hist_calibration_timing(dev, preds, target):
    """K2's weighted one-shot form as phase 10's calibration error launches
    it: the main rows' top-label confidences binned into 15 bins, ``(N, 3)``
    f32 weights (in-bin flag, confidence, accuracy). Counts exact; the sums
    within the reassociation bound of the plain version's and of
    ``index_add_``'s. The library call is ``index_add_`` into a zeroed
    ``(15, 3)`` output."""
    from metrics_tpu_torch.functional.classification.calibration_error import _bin_boundaries, _ce_update
    from metrics_tpu_torch.ops.kernels import histogram_accumulate
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda, histogram_plain

    conf, acc = _ce_update(preds, target)
    idx = torch.searchsorted(_bin_boundaries(CAL_BINS, dev), conf, side="left") - 1
    w = (idx >= 0).to(torch.float32)
    idx = idx.clamp(0, CAL_BINS - 1)
    weights = torch.stack([w, conf * w, acc * w], dim=-1)
    i2, w3 = idx[None], weights[None]
    kernel = lambda: histogram_cuda(i2, CAL_BINS, None, w3)  # noqa: E731
    plain = lambda: histogram_plain(i2, CAL_BINS, None, w3)  # noqa: E731
    whole = lambda: histogram_accumulate(idx, CAL_BINS, weights=weights)  # noqa: E731
    library = lambda: torch.zeros((CAL_BINS, 3), device=dev).index_add_(0, idx, weights)  # noqa: E731
    want = plain()[0]
    tol = 2 * idx.numel() * 2.0**-24 * histogram_plain(i2, CAL_BINS, None, w3.abs())[0].double()
    err = 0.0
    for name, got in (("kernel", kernel()[0]), ("call", whole()), ("index_add_", library())):
        torch.cuda.synchronize()
        check(torch.equal(got[:, 0], want[:, 0]), f"hist calibration {name}: counts differ")
        diff = (got.double() - want.double()).abs()
        check(bool((diff <= tol).all()), f"hist calibration {name}: err {float(diff.max())}")
        err = max(err, float(diff.max()))
    trace = device_trace(whole)
    n = idx.numel()
    entry = {
        "name": "histogram", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/hist.cu",
        "replaces": "metrics_tpu/ops/kernels/pallas_hist.py:55",
        "shape": f"idx ({n},) int64 into {CAL_BINS} bins, ({n}, 3) f32 weights (calibration error, one-shot)",
        "max_abs_err": err, "max_abs_err_bf16": None,
        "ms": gpu_ms(kernel), "plain_ms": gpu_ms(plain), "library_ms": gpu_ms(library),
        "device_us": device_us(kernel),
        "call_ms": gpu_ms(whole), "call_host_us": host_us(whole),
        "call_device_us": {k: us for k, (us, _) in trace.items()},
        "call_device_launches": sum(c for _, c in trace.values()),
    }
    # the indices and weights read once, the (15, 3) sums written once; one add per weight
    entry["bound_ms"], entry["bound_by"] = bound_ms(8 * n + 12 * n + 4 * 3 * CAL_BINS, 3 * n)
    return entry


# ------------------------------------------------------------- phase 11: the curves

F32_EPS = 2.0**-24
CURVE_PREFIX_BATCHES = 2  # the uncaptured twin's batches: its eager scan takes ~1 s of host per 1024-row step
CAPACITY_KEYS = ("preds_buf", "target_buf", "valid_buf", "count", "overflow")
SCAN_REASON = "state 'preds_buf' has dist_reduce_fx='cat'"  # the JAX package's segmented refusal
SCAN_FALLBACKS = {"dtype.bool:strategy": 1, "dtype.float32:strategy": 1, "dtype.int32:strategy": 1}


def curve_oracle(scores, positive):
    """One class's exact AUROC (Mann-Whitney with scipy's average ranks) and
    step AP in float64 from the f32 scores, with the bounds the port's f32
    computations are held to: the trapezoid over ``m`` curve points and the
    step sum over ``m`` PR points, (4m + 8) * 2**-24 (fpr, tpr and precision
    rounded once, each difference and product once more, the sum
    reassociated: 2 * m * 2**-24 * sum|terms| with sum|terms| <= 1); the
    capacity form's rank sum, 2 * P * 2**-24 * sum(positive ranks) plus the
    rounding of P(P+1)/2, over P * N; its AP sum (2m + 4) * 2**-24 * AP."""
    from scipy.stats import rankdata

    s = scores.astype(np.float64)
    p = int(positive.sum())
    nn = len(s) - p
    s_pos = float(rankdata(s)[positive].sum())
    auroc = (s_pos - p * (p + 1) / 2) / (p * nn)
    order = np.argsort(-s, kind="stable")
    ys, ss = positive[order], s[order]
    end = np.r_[ss[1:] != ss[:-1], True]
    tp, fp = np.cumsum(ys)[end], np.cumsum(~ys)[end]
    ap = float((np.diff(np.r_[0, tp]) * tp / (tp + fp)).sum() / p)
    m = int(end.sum()) + 1
    return {"auroc": auroc, "ap": ap, "points": m, "support": p, "tol_curve": (4 * m + 8) * F32_EPS,
            "tol_ranks": ((2 * p + 1) * s_pos + p * (p + 1) / 2) * F32_EPS / (p * nn) + 4 * F32_EPS,
            "tol_capacity_ap": (2 * m + 4) * F32_EPS * ap + F32_EPS}


def partial_auroc_oracle(scores, positive, max_fpr):
    """Binary AUROC up to ``max_fpr`` with the McClish correction, in float64
    (the ROC at distinct thresholds, a point added at ``max_fpr`` by linear
    interpolation), and its bound: the trapezoid's (4m + 16) * 2**-24 times
    the correction's scale 0.5 / (max_fpr - max_fpr**2 / 2)."""
    s = scores.astype(np.float64)
    order = np.argsort(-s, kind="stable")
    ys, ss = positive[order], s[order]
    end = np.r_[ss[1:] != ss[:-1], True]
    tps, fps = np.r_[0, np.cumsum(ys)[end]], np.r_[0, np.cumsum(~ys)[end]]
    fpr, tpr = fps / fps[-1], tps / tps[-1]
    stop = int(np.searchsorted(fpr, max_fpr, side="right"))
    w = (max_fpr - fpr[stop - 1]) / (fpr[stop] - fpr[stop - 1])
    tpr = np.r_[tpr[:stop], tpr[stop - 1] + w * (tpr[stop] - tpr[stop - 1])]
    fpr = np.r_[fpr[:stop], max_fpr]
    partial = float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2))
    min_area = 0.5 * max_fpr**2
    scale = 0.5 / (max_fpr - min_area)
    return 0.5 * (1 + (partial - min_area) / (max_fpr - min_area)), scale * (4 * len(fpr) + 16) * F32_EPS


def make_curve_collection(device):
    """The flagship collection with an exact AUROC and AP over static buffers
    that hold every main row: the scan members of phase 11(b)."""
    from metrics_tpu_torch import AUROC, AveragePrecision

    coll = make_collection(device)
    coll.add_metrics({"auroc": AUROC(num_classes=NUM_CLASSES, capacity=N_ROWS, device=device),
                      "ap": AveragePrecision(num_classes=NUM_CLASSES, capacity=N_ROWS, device=device)})
    return coll


def curves_eager(dev, preds, target):
    """Phase 11(a) on ``dev``: every exact curve metric over the main rows
    in 4 batches (AUROC macro and weighted, AP macro, ROC, PR curve, AUC of
    class 0's ROC, the binary AUROC of class 0 up to fpr 0.3), binned recall
    at precision 0.15 over 100 thresholds, the aggregators over the
    top-label confidences, and the AUROC and AP capacity states. Returns the
    values, the K2 launches of the weighted compute and the seconds."""
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda

    c = NUM_CLASSES
    ms = {"auroc_macro": mp.AUROC(num_classes=c, device=dev),
          "auroc_weighted": mp.AUROC(num_classes=c, average="weighted", device=dev),
          "ap_macro": mp.AveragePrecision(num_classes=c, device=dev),
          "roc": mp.ROC(num_classes=c, device=dev),
          "pr_curve": mp.PrecisionRecallCurve(num_classes=c, device=dev),
          "binned_recall": mp.BinnedRecallAtFixedPrecision(num_classes=c, min_precision=0.15,
                                                           thresholds=THRESHOLDS, device=dev),
          "auroc_capacity": mp.AUROC(num_classes=c, capacity=N_ROWS, device=dev),
          "ap_capacity": mp.AveragePrecision(num_classes=c, capacity=N_ROWS, device=dev)}
    binary = mp.AUROC(max_fpr=0.3, device=dev)
    aggs = {"mean": mp.MeanMetric(device=dev), "sum": mp.SumMetric(device=dev), "max": mp.MaxMetric(device=dev),
            "min": mp.MinMetric(device=dev), "cat": mp.CatMetric(device=dev)}
    conf = preds.max(dim=1).values
    t0 = time.perf_counter()
    for lo in range(0, N_ROWS, BATCH):
        p, t = preds[lo:lo + BATCH], target[lo:lo + BATCH]
        for m in ms.values():
            m.update(p, t)
        binary.update(p[:, 0], (t == 0).to(torch.int64))
        for m in aggs.values():
            m.update(conf[lo:lo + BATCH])
    before = histogram_cuda.launches
    out = {k: m.compute() for k, m in ms.items()}
    support_launches = histogram_cuda.launches - before
    out["auroc_binary_max_fpr"] = binary.compute()
    auc = mp.AUC(device=dev)
    auc.update(out["roc"][0][0], out["roc"][1][0])
    out["auc_class0"] = auc.compute()
    out.update({f"agg_{k}": m.compute() for k, m in aggs.items()})
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    states = {k: {s: getattr(ms[k], s) for s in CAPACITY_KEYS} for k in ("auroc_capacity", "ap_capacity")}
    states["binned_recall"] = {s: getattr(ms["binned_recall"], s) for s in ("TPs", "FPs", "FNs")}
    return out, states, support_launches, seconds


def hist_auroc_support_timing(dev, target):
    """K2's one-shot form as the weighted AUROC counts class support:
    ``(65 536,)`` int64 labels into 10 bins, exact against its plain
    version and ``torch.bincount`` (the library call)."""
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda, histogram_plain
    from metrics_tpu_torch.utils.data import _bincount

    idx = target.reshape(-1)
    i2 = idx[None]
    kernel = lambda: histogram_cuda(i2, NUM_CLASSES)  # noqa: E731
    plain = lambda: histogram_plain(i2, NUM_CLASSES)  # noqa: E731
    whole = lambda: _bincount(idx, NUM_CLASSES)  # noqa: E731
    library = lambda: torch.bincount(idx, minlength=NUM_CLASSES)  # noqa: E731
    want = plain()[0]
    for name, got in (("kernel", kernel()[0]), ("call", whole()), ("bincount", library())):
        check(torch.equal(got.to(want.dtype), want), f"hist AUROC support {name}: counts differ")
    trace = device_trace(whole)
    n = idx.numel()
    entry = {
        "name": "histogram", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/hist.cu",
        "replaces": "metrics_tpu/ops/kernels/pallas_hist.py:55",
        "shape": f"idx ({n},) int64 into {NUM_CLASSES} bins (weighted AUROC support, one-shot)",
        "max_abs_err": 0.0, "max_abs_err_bf16": None,  # counts: held exactly above
        "ms": gpu_ms(kernel), "plain_ms": gpu_ms(plain), "library_ms": gpu_ms(library),
        "device_us": device_us(kernel),
        "call_ms": gpu_ms(whole), "call_host_us": host_us(whole),
        "call_device_us": {k: us for k, (us, _) in trace.items()},
        "call_device_launches": sum(c for _, c in trace.values()),
    }
    # the labels read once, the 10 int32 counts written once; one add per label
    entry["bound_ms"], entry["bound_by"] = bound_ms(8 * n + 4 * NUM_CLASSES, n)
    return entry


def close_within(got, want, tol, what):
    g = float(got)
    check(abs(g - want) <= tol, f"{what}: {g} vs {want} (tol {tol})")
    return abs(g - want)


def check_curve_values(values, oracles, preds_np, what):
    """(a)'s values against the float64 oracles, each within its bound.
    Returns the largest error beside each bound."""
    errs = {}
    per = oracles["classes"]
    w = np.array([o["support"] for o in per], np.float64) / N_ROWS
    tol_curve = np.array([o["tol_curve"] for o in per])
    tol_ranks = np.array([o["tol_ranks"] for o in per])
    auroc = np.array([o["auroc"] for o in per])
    ap = np.array([o["ap"] for o in per])
    for key, want, tol in (
        ("auroc_macro", auroc.mean(), tol_curve.mean() + 16 * F32_EPS),
        ("auroc_weighted", (auroc * w).sum(), (tol_curve * w).sum() + 16 * F32_EPS),
        ("ap_macro", ap.mean(), tol_curve.mean() + 16 * F32_EPS),
        ("auroc_capacity", auroc.mean(), tol_ranks.mean() + 16 * F32_EPS),
        ("ap_capacity", ap.mean(), np.mean([o["tol_capacity_ap"] for o in per]) + 16 * F32_EPS),
        ("auc_class0", auroc[0], tol_curve[0]),
        ("auroc_binary_max_fpr", *oracles["binary_max_fpr"]),
    ):
        errs[key] = (close_within(values[key], float(want), float(tol), f"{what}: {key}"), float(tol))
    conf = preds_np.max(1).astype(np.float64)
    total = float(conf.sum())
    tol = (2 * N_ROWS + 4) * F32_EPS * total
    errs["agg_sum"] = (close_within(values["agg_sum"], total, tol, f"{what}: sum"), tol)
    errs["agg_mean"] = (close_within(values["agg_mean"], total / N_ROWS, 2 * tol / N_ROWS, f"{what}: mean"),
                        2 * tol / N_ROWS)
    check(float(values["agg_max"]) == float(preds_np.max(1).max()), f"{what}: max")
    check(float(values["agg_min"]) == float(preds_np.max(1).min()), f"{what}: min")
    check(torch.equal(values["agg_cat"].cpu(), torch.from_numpy(preds_np.max(1))), f"{what}: cat")
    return errs


def curve_capacity_reference(preds_np, target_np, batches):
    """The CPU port's eager capacity update over ``batches``: the bit-exact
    reference of the engine's scan-folded buffers."""
    from metrics_tpu_torch import AUROC, AveragePrecision

    ms = {"auroc": AUROC(num_classes=NUM_CLASSES, capacity=N_ROWS, device="cpu"),
          "ap": AveragePrecision(num_classes=NUM_CLASSES, capacity=N_ROWS, device="cpu")}
    for start, stop in batches:
        p, t = torch.from_numpy(preds_np[start:stop]), torch.from_numpy(target_np[start:stop])
        for m in ms.values():
            m.update(p, t)
    return {k: {s: getattr(m, s) for s in CAPACITY_KEYS} for k, m in ms.items()}


def curve_engine_run(dev, preds, target, batches, capture, aot_cache=None):
    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine

    eng = StreamingEngine(make_curve_collection(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep"),
                          aot_cache=aot_cache)
    seconds = run_engine(eng, capture, batches, lambda e, b: e.submit(preds[b[0]:b[1]], target[b[0]:b[1]]))
    check(eng.stats.kernel_fallbacks_by_reason() == SCAN_FALLBACKS,
          f"curve engine fallbacks {eng.stats.kernel_fallbacks_by_reason()}")
    return eng, seconds


def profile_scan_bucket(dev, preds, target, aot_cache):
    """One 1024-row bucket through a warm twin of the curve engine (its
    captured graph replayed): host wall µs of ``submit`` + ``flush`` (median
    of 5), and from one profiler trace the device µs and device launches of
    the replay (the graph's kernel nodes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine

    eng = StreamingEngine(make_curve_collection(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep"),
                          aot_cache=aot_cache)
    p, t = preds[:BUCKET], target[:BUCKET]

    def bucket():
        eng.submit(p, t)
        eng.flush()

    eng.start()
    walls = []
    for _ in range(6):  # at most 64 buckets into the 65 536-row buffers: no overflow
        t0 = time.perf_counter()
        bucket()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bucket()
        torch.cuda.synchronize()
    eng.stop()
    check(eng.stats.warmup_steps == 0, "scan bucket profile: the warm twin captured a step")
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = float(sum(e.self_device_time_total for e in device))
    wall = float(np.median(walls[1:]))
    check(busy > 0, "profiler: no device time in the scan bucket")
    return {"wall_us": wall, "device_busy_us": busy, "device_busy_share": busy / wall,
            "device_launches": sum(e.count for e in device),
            "top": [(e.key[:60], e.self_device_time_total) for e in sorted(device, key=lambda e: -e.self_device_time_total)[:6]]}


def flat_curves(v):
    """The tensors of a curve value (tuples and per-class lists), in order."""
    if isinstance(v, (list, tuple)):
        return [x for e in v for x in flat_curves(e)]
    return [v]


def curves_phase(dev, preds, target, preds_np, target_np):
    """Phase 11: the exact curves. (a) eager on the card against float64
    oracles and the CPU port, with the weighted AUROC's support in one K2
    launch; (b) the flagship collection plus capacity AUROC and AP through
    the captured megastep engine (the scan members demote every arena dtype:
    no K5), buffers bit-equal to the CPU port's eager capacity update, an
    uncaptured twin on a prefix; (c) both multi-stream forms refuse the scan
    members with the JAX package's reason."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    out = {}
    oracles = {"classes": [curve_oracle(preds_np[:, k], target_np == k) for k in range(NUM_CLASSES)],
               "binary_max_fpr": partial_auroc_oracle(preds_np[:, 0], target_np == 0, 0.3)}
    gpu, gpu_states, support_launches, eager_s = curves_eager(dev, preds, target)
    cpu, cpu_states, _, _ = curves_eager(torch.device("cpu"), torch.from_numpy(preds_np), torch.from_numpy(target_np))
    check(support_launches == 1, f"weighted AUROC: {support_launches} K2 launches in its compute")
    errs = check_curve_values(gpu, oracles, preds_np, "curves (card)")
    check_curve_values(cpu, oracles, preds_np, "curves (CPU)")
    compare_states(gpu_states, cpu_states, "curves: card vs CPU")
    compare_states({"binned_recall": gpu_states["binned_recall"]},
                   {"binned_recall": oracle_states(preds_np, target_np)["binned_ap"]}, "binned recall vs numpy")
    for k in ("roc", "pr_curve", "binned_recall"):  # counts and f32 ratios of them: bit-equal
        for g, w in zip(flat_curves(gpu[k]), flat_curves(cpu[k])):
            check(g.dtype == w.dtype and torch.equal(g.cpu(), w), f"curves: {k} card vs CPU")
    out["eager"] = {"update_compute_s": eager_s, "auroc_support_k2_launches": support_launches,
                    "values": {k: float(v) for k, v in gpu.items() if k.startswith(("auroc", "ap", "auc", "agg_"))
                               and k != "agg_cat"},
                    "err_and_bound": errs}

    # (b) the captured megastep engine with two scan members
    batches = ragged_batches(SEED + 2, 16, BUCKET)
    before = counts()
    eng, seconds = curve_engine_run(dev, preds, target, batches, True)
    d = delta(before)
    n = eng.steps + eng.stats.warmup_steps
    check(d["megastep_fold"] == 0 and d["fold_rows"] > 0 and d["histogram"] == n and d["binned_counts"] == n,
          f"curve engine: {d} in {n} steps")
    state = eng.state()
    compare_states({k: state[k] for k in ("auroc", "ap")}, curve_capacity_reference(preds_np, target_np, batches),
                   "curve engine vs CPU eager capacity update")
    main_state, _, _ = main_path(dev, preds, target)
    compare_states({k: state[k] for k in main_state}, main_state, "curve engine flagship vs phase 4")
    values = eng.result()
    for key, member in (("auroc_capacity", "auroc"), ("ap_capacity", "ap")):
        tol = errs[key][1]
        close_within(values[member], float(gpu[key]), 2 * tol, f"curve engine {member} vs eager capacity")
    close_within(values["auroc"], float(gpu["auroc_macro"]), errs["auroc_macro"][1] + errs["auroc_capacity"][1],
                 "curve engine AUROC vs eager default mode")
    aot = check_cache(eng, "curve engine")
    prefix = batches[:CURVE_PREFIX_BATCHES]
    twin, twin_s = curve_engine_run(dev, preds, target, prefix, False)
    compare_states({k: twin.state()[k] for k in ("auroc", "ap")}, curve_capacity_reference(preds_np, target_np, prefix),
                   "uncaptured curve engine vs CPU eager capacity update")
    out["streaming_megastep"] = {
        "seconds": seconds, "steps": eng.steps, "warmup_steps": eng.stats.warmup_steps, "batches": len(batches),
        "ms_per_step": seconds / eng.steps * 1e3, "capture_seconds": aot["capture_seconds"], "aot": aot,
        "launches": d, "fallbacks": eng.stats.kernel_fallbacks_by_reason(),
        "uncaptured_prefix": {"batches": len(prefix), "steps": twin.steps, "seconds": twin_s,
                              "ms_per_step": twin_s / twin.steps * 1e3},
        "bucket_1024": profile_scan_bucket(dev, preds, target, eng.aot_cache)}

    # (c) the multi-stream engines refuse the scan members
    refusals = {}
    for name, kw in (("unsharded", {}), ("paged", {"stream_shard": True, "resident_streams": RESIDENT})):
        try:
            MultiStreamEngine(make_curve_collection(dev), MS_STREAMS, EngineConfig(buckets=(256, BUCKET)), **kw)
        except MetricsTPUUserError as e:
            refusals[name] = str(e)
        check(SCAN_REASON in refusals.get(name, ""), f"{name} multi-stream engine did not refuse the scan members")
    out["refusals"] = refusals
    return out


# -------------------------------------------- phase 12: wrappers and composition

BOOTSTRAPS = 10
TRACKER_EPOCHS = 3
PAGED_TWIN_BATCHES = 230  # the uncaptured paged twin's prefix (an eighth of the 1840 batches)
REFUSAL = "full_state_update metrics read the accumulated state in update"


def f1_composition(dev, average="macro"):
    """``2 * P * R / (P + R)`` over fresh Precision and Recall: each operand
    sits in both branches of the tree."""
    from metrics_tpu_torch import Precision, Recall

    p = Precision(num_classes=NUM_CLASSES, average=average, device=dev)
    r = Recall(num_classes=NUM_CLASSES, average=average, device=dev)
    return 2 * p * r / (p + r)


def make_wrapper_collection(device):
    """The flagship collection plus a composed F1 and a multinomial bootstrap
    of the accuracy: phase 12's served collection."""
    from metrics_tpu_torch import Accuracy, BootStrapper

    coll = make_collection(device)
    coll.add_metrics({
        "f1_composed": f1_composition(device),
        "boot": BootStrapper(Accuracy(num_classes=NUM_CLASSES, device=device), num_bootstraps=BOOTSTRAPS,
                             sampling_strategy="multinomial", seed=SEED),
    })
    return coll


def make_multioutput_collection(device, remove_nans=False):
    from metrics_tpu_torch import Accuracy, MetricCollection, MultioutputWrapper

    return MetricCollection({"multi": MultioutputWrapper(Accuracy(num_classes=NUM_CLASSES, device=device),
                                                         num_outputs=2, remove_nans=remove_nans)})


def two_head_rows(dev, preds_np, target_np):
    """Two heads over the main rows: head 0 the main rows, head 1 a second
    seeded distribution and labels; ``(N, 10, 2)`` probabilities, ``(N, 2)``
    labels."""
    rng = np.random.RandomState(SEED + 7)
    q = rng.rand(N_ROWS, NUM_CLASSES).astype(np.float32)
    q /= q.sum(axis=1, keepdims=True)
    p2 = np.ascontiguousarray(np.stack([preds_np, q], axis=-1))
    t2 = np.ascontiguousarray(np.stack([target_np, rng.randint(0, NUM_CLASSES, N_ROWS)], axis=-1))
    return p2, t2


def macro_f1_of(counts):
    tp, fp, fn = (np.asarray(counts[k], np.float64) for k in ("tp", "fp", "fn"))
    return float(np.mean(2 * tp / (2 * tp + fp + fn)))


def micro_accuracy(pred_label, target):
    return float((pred_label == target).mean())


def compare_trees(got, want, what):
    """Every leaf ``want`` names, in ``got``, equal to it (numbers exact)."""
    if isinstance(want, dict):
        for k, v in want.items():
            check(k in got, f"{what}: no {k}")
            compare_trees(got[k], v, f"{what}.{k}")
    elif isinstance(want, list):
        check(len(got) == len(want), f"{what}: {len(got)} vs {len(want)} entries")
        for i, (g, w) in enumerate(zip(got, want)):
            compare_trees(g, w, f"{what}[{i}]")
    else:
        g = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        w = want.detach().cpu().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
        check(g.shape == w.shape and np.array_equal(g.astype(np.float64), w.astype(np.float64)),
              f"{what}: differs")


def same_trees(a, b, what):
    """Two state trees bit for bit (same dtypes)."""
    from metrics_tpu_torch.utils.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    check(len(la) == len(lb), f"{what}: {len(la)} vs {len(lb)} leaves")
    for x, y in zip(la, lb):
        check(x.dtype == y.dtype and torch.equal(x, y), f"{what}: a leaf differs")


def wrapper_oracle(preds, target, template):
    """Every integer state of the served collection from numpy: the
    flagship's, the composition's (each occurrence of P and R counts every
    row twice: the operand is updated once per occurrence, as in the JAX
    package; ``template`` is the composition's state tree) and the
    bootstrap's (each replica sees each row once, ``draw_count`` counts the
    rows)."""
    base = oracle_states(preds, target)
    macro2 = {k: 2 * np.asarray(v) for k, v in base["f1"].items()}

    def doubled(tree):
        if isinstance(tree, list):
            return [doubled(v) for v in tree]
        return {k: doubled(v) if isinstance(v, (dict, list)) else macro2[k] for k, v in tree.items()}

    base["f1_composed"] = doubled(template)
    base["boot"] = {"draw_count": len(target), "_children": {"metrics": [base["acc"]] * BOOTSTRAPS}}
    return base


def wrapper_eager(dev, preds, target, preds_np, target_np):
    """Phase 12(a): the wrappers and compositions eagerly in 4 batches on the
    card, each against a numpy oracle (values within 1e-6, counts exact)."""
    from metrics_tpu_torch import (Accuracy, BootStrapper, F1Score, MetricTracker, MinMaxMetric, Precision,
                                   Recall)

    out = {}
    t0 = time.perf_counter()
    label = preds_np.argmax(1)
    batches = [(lo, lo + BATCH) for lo in range(0, N_ROWS, BATCH)]
    prefix_f1 = [macro_f1_of(oracle_states(preds_np[:hi], target_np[:hi])["f1"]) for _, hi in batches]
    # MinMax: prefix semantics, and the fold at compute
    for fold in (False, True):
        mm = MinMaxMetric(F1Score(num_classes=NUM_CLASSES, average="macro", device=dev), fold_on_compute=fold)
        for lo, hi in batches:
            mm.update(preds[lo:hi], target[lo:hi])
        v = mm.compute()
        lo_want, hi_want = (prefix_f1[-1], prefix_f1[-1]) if fold else (min(prefix_f1), max(prefix_f1))
        close_value(v["raw"], prefix_f1[-1], f"minmax fold={fold} raw")
        close_value(v["min"], lo_want, f"minmax fold={fold} min")
        close_value(v["max"], hi_want, f"minmax fold={fold} max")
        out[f"minmax{'_fold_on_compute' if fold else ''}"] = {k: float(x) for k, x in v.items()}
    # Multioutput over two heads, NaN rows planted, removed per head
    p2, t2 = two_head_rows(dev, preds_np, target_np)
    nan_rows = {0: [5, 1000, N_ROWS * 5 // 8], 1: [77, N_ROWS - 1]}
    for h, rows in nan_rows.items():
        p2[rows, 3, h] = np.nan
    mo = make_multioutput_collection(dev, remove_nans=True)["multi"]
    p2d, t2d = torch.from_numpy(p2).to(dev), torch.from_numpy(t2).to(dev)
    for lo, hi in batches:
        mo.update(p2d[lo:hi], t2d[lo:hi])
    v = mo.compute()
    for h, rows in nan_rows.items():
        keep = np.ones(N_ROWS, bool)
        keep[rows] = False
        close_value(v[h], micro_accuracy(p2[keep, :, h].argmax(1), t2[keep, h]), f"multioutput head {h}")
        check(int(mo.metrics[h].tp + mo.metrics[h].fn) == N_ROWS - len(rows), f"multioutput head {h}: rows kept")
    out["multioutput"] = [float(x) for x in v]
    # BootStrapper: poisson (the same numpy draws) and multinomial (the same generator state)
    for strategy in ("poisson", "multinomial"):
        boot = BootStrapper(Accuracy(num_classes=NUM_CLASSES, device=dev), num_bootstraps=BOOTSTRAPS, quantile=0.5,
                            raw=True, sampling_strategy=strategy, seed=SEED)
        rng, gen = np.random.RandomState(SEED), torch.Generator()
        gen.set_state(boot._generator.get_state())
        correct, total = np.zeros(BOOTSTRAPS), np.zeros(BOOTSTRAPS)
        for lo, hi in batches:
            boot.update(preds[lo:hi], target[lo:hi])
            for r in range(BOOTSTRAPS):
                if strategy == "poisson":
                    idx = np.repeat(np.arange(hi - lo), rng.poisson(1, hi - lo))
                else:
                    idx = torch.randint(0, hi - lo, (hi - lo,), generator=gen).numpy()
                correct[r] += (label[lo:hi][idx] == target_np[lo:hi][idx]).sum()
                total[r] += idx.size
        v = boot.compute()
        raw = correct / total
        for r, m in enumerate(boot.metrics):
            check(int(m.tp) == int(correct[r]) and int(m.tp + m.fn) == int(total[r]), f"bootstrap {strategy}: replica {r}")
        for got, want, name in ((v["mean"], raw.mean(), "mean"), (v["std"], raw.std(ddof=1), "std"),
                                (v["quantile"], np.quantile(raw, 0.5), "quantile")):
            close_value(got, want, f"bootstrap {strategy} {name}")
        for got, want in zip(v["raw"].tolist(), raw):
            close_value(got, want, f"bootstrap {strategy} raw")
        out[f"bootstrap_{strategy}"] = {"mean": float(v["mean"]), "std": float(v["std"])}
    # compositions: the F1 harmonic mean, a scalar operand, a comparison, an index
    macro = oracle_states(preds_np, target_np)["f1"]
    tp, fp, fn = (np.asarray(macro[k], np.float64) for k in ("tp", "fp", "fn"))
    prec_c, rec_c = tp / (tp + fp), tp / (tp + fn)
    pm, rm = prec_c.mean(), rec_c.mean()
    f1c, f1c_pct = f1_composition(dev), f1_composition(dev) * 100.0
    p_gt_r = Precision(num_classes=NUM_CLASSES, average="macro", device=dev) > Recall(
        num_classes=NUM_CLASSES, average="macro", device=dev)
    p3 = Precision(num_classes=NUM_CLASSES, average="none", device=dev)[3]
    per_class, f1_none = f1_composition(dev, "none"), F1Score(num_classes=NUM_CLASSES, average="none", device=dev)
    comps = (f1c, f1c_pct, p_gt_r, p3, per_class, f1_none)
    for lo, hi in batches:
        for c in comps:
            c.update(preds[lo:hi], target[lo:hi])
    close_value(f1c.compute(), 2 * pm * rm / (pm + rm), "composed F1")
    close_value(f1c_pct.compute(), 100 * 2 * pm * rm / (pm + rm), "composed F1 x 100")
    check(bool(p_gt_r.compute()) == bool(pm > rm), "P > R")
    close_value(p3.compute(), prec_c[3], "precision[3]")
    for got, want in zip(per_class.compute().tolist(), f1_none.compute().tolist()):
        close_value(got, want, "per-class composition vs F1Score(average='none')")
    compare_trees(f1c.metric_b.metric_a._pack_state(), {k: 2 * np.asarray(v) for k, v in macro.items()},
                  "composed F1: P's counts (two occurrences)")
    out["composition"] = {"f1_composed": float(f1c.compute()), "macro_f1": macro_f1_of(macro),
                          "precision_gt_recall": bool(p_gt_r.compute())}
    # MetricTracker over the flagship collection, 3 epochs (one batch each)
    tracker = MetricTracker(make_collection(dev), maximize=[True, True, True, True])
    f1_tracker = MetricTracker(F1Score(num_classes=NUM_CLASSES, average="macro", device=dev))
    epoch_f1 = []
    for lo, hi in batches[:TRACKER_EPOCHS]:
        for t in (tracker, f1_tracker):
            t.increment()
            t.update(preds[lo:hi], target[lo:hi])
        epoch_f1.append(macro_f1_of(oracle_states(preds_np[lo:hi], target_np[lo:hi])["f1"]))
    allv = tracker.compute_all()
    for e, (lo, hi) in enumerate(batches[:TRACKER_EPOCHS]):
        close_value(allv["f1"][e], epoch_f1[e], f"tracker epoch {e} F1")
        close_value(allv["acc"][e], micro_accuracy(label[lo:hi], target_np[lo:hi]), f"tracker epoch {e} accuracy")
        compare_trees(allv["confmat"][e], oracle_states(preds_np[lo:hi], target_np[lo:hi])["confmat"]["confmat"],
                      f"tracker epoch {e} confmat")
    step, best = f1_tracker.best_metric(return_step=True)
    check(step == int(np.argmax(epoch_f1)), f"tracker best step {step}")
    close_value(best, max(epoch_f1), "tracker best F1")
    out["tracker"] = {"best_step": step, "best_f1": best}
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    return out


def wrapper_engine_run(dev, batches, submit, capture, make, cfg, aot_cache=None, **kw):
    from metrics_tpu_torch.engine import MultiStreamEngine, StreamingEngine

    if kw:
        eng = MultiStreamEngine(make(dev), PAGED_STREAMS, cfg, aot_cache=aot_cache, **kw)
    else:
        eng = StreamingEngine(make(dev), cfg, aot_cache=aot_cache)
    return eng, run_engine(eng, capture, batches, submit)


def wrapper_phase(dev, preds, target, preds_np, target_np):
    """Phase 12: (a) the wrappers and compositions eagerly; (b) the flagship
    plus a composed F1 and a multinomial BootStrapper through the captured
    megastep ``StreamingEngine`` (with its uncaptured and warm twins) and the
    captured paged ``MultiStreamEngine`` (an uncaptured twin on a prefix),
    and ``MultioutputWrapper(remove_nans=False)`` through the megastep engine
    on two-head rows; integer states, children included, bit-equal to the
    twins and to numpy; (c) the refusals."""
    from metrics_tpu_torch import Accuracy, MetricCollection, MinMaxMetric
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
    from metrics_tpu_torch.utils.tree import tree_map

    out = {"eager": wrapper_eager(dev, preds, target, preds_np, target_np)}
    template = make_wrapper_collection(torch.device("cpu")).init_state()["f1_composed"]

    # (b) the captured megastep engine, its uncaptured twin and a warm twin
    mega = EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep")
    batches = ragged_batches(SEED + 2, 16, BUCKET)
    submit = lambda e, b: e.submit(preds[b[0]:b[1]], target[b[0]:b[1]])  # noqa: E731
    before = counts()
    eng, seconds = wrapper_engine_run(dev, batches, submit, True, make_wrapper_collection, mega)
    d = delta(before)
    n = eng.steps + eng.stats.warmup_steps
    check(eng.stats.kernel_fallbacks_by_reason() == {}, f"wrapper engine fell back: {eng.stats.kernel_fallbacks}")
    check(d["megastep_fold"] == 3 * n and d["fold_rows"] == 0, f"wrapper engine: {d} in {n} steps")
    state = eng.state()
    compare_trees(state, wrapper_oracle(preds_np, target_np, template), "wrapper engine vs numpy")
    aot = check_cache(eng, "wrapper engine")
    unc, unc_seconds = wrapper_engine_run(dev, batches, submit, False, make_wrapper_collection, mega)
    same_trees(unc.state(), state, "wrapper engine: uncaptured vs captured")
    twin, twin_seconds = wrapper_engine_run(dev, batches, submit, True, make_wrapper_collection, mega,
                                            aot_cache=eng.aot_cache)
    check(twin.stats.warmup_steps == 0 and eng.aot_cache.misses == aot["misses"], "wrapper warm twin captured")
    same_trees(twin.state(), state, "wrapper engine: warm twin vs first")
    value = eng.result()
    close_value(value["boot"]["mean"], value["acc"], "served bootstrap mean vs accuracy")
    close_value(value["boot"]["std"], 0.0, "served bootstrap std")
    out["streaming_megastep"] = {
        "steps": eng.steps, "batches": len(batches), "seconds": seconds, "ms_per_step": seconds / eng.steps * 1e3,
        "capture_seconds": aot["capture_seconds"], "aot": aot, "launches": d,
        "uncaptured_ms_per_step": unc_seconds / unc.steps * 1e3,
        "warm_twin": {"warmup_steps": twin.stats.warmup_steps, "ms_per_step": twin_seconds / twin.steps * 1e3},
        "bucket_1024": profile_bucket(dev, preds, target, make=make_wrapper_collection)}

    # the paged engine: an uncaptured twin on a prefix, then the rest captured
    paged = EngineConfig(buckets=PAGED_BUCKETS, kernel_backend="megastep")
    pbatches = ragged_batches(SEED + 4, 8, 64)
    sids = zipf_stream_ids(PAGED_STREAMS, len(pbatches), ALPHA, SEED + 4)
    items = list(zip(sids, pbatches))
    psubmit = lambda e, b: e.submit(int(b[0]), preds[b[1][0]:b[1][1]], target[b[1][0]:b[1][1]])  # noqa: E731
    pkw = {"stream_shard": True, "resident_streams": RESIDENT}
    before = counts()
    peng, p_first = wrapper_engine_run(dev, items[:PAGED_TWIN_BATCHES], psubmit, True, make_wrapper_collection, paged,
                                       **pkw)
    punc, punc_seconds = wrapper_engine_run(dev, items[:PAGED_TWIN_BATCHES], psubmit, False, make_wrapper_collection,
                                            paged, **pkw)
    same_trees(punc.state(), peng.state(), "paged wrapper engine: uncaptured vs captured prefix")
    p_rest = run_engine(peng, True, items[PAGED_TWIN_BATCHES:], psubmit)
    pd = delta(before)
    check(pd["megastep_segment"] > 0 and peng.stats.kernel_fallbacks_by_reason() == {},
          f"paged wrapper engine: {pd}, {peng.stats.kernel_fallbacks}")
    check(peng.stats.page_outs > 0, "paged wrapper engine: nothing was spilled")
    # every stream: the sums over streams equal the counts over all rows
    stacked = tree_map(lambda x: x.cpu().numpy().astype(np.int64).sum(0) if not x.is_floating_point()
                       else x.double().sum(0).cpu().numpy(), peng.state())
    compare_trees(stacked, wrapper_oracle(preds_np, target_np, template), "paged wrapper engine: sum over streams")
    per_stream = stream_rows(sids, pbatches)
    busiest = sorted(per_stream, key=lambda s: -len(per_stream[s]))[:10]
    quiet = [s for s in sorted(per_stream) if len(per_stream[s]) < 64][:10]
    for sid in busiest + quiet + [s for s in range(0, PAGED_STREAMS, 997) if s not in per_stream][:3]:
        idx = per_stream.get(sid, np.zeros(0, np.int64))
        compare_trees(peng.stream_state(sid), wrapper_oracle(preds_np[idx], target_np[idx], template),
                      f"paged wrapper engine: stream {sid}")
    paot = check_cache(peng, "paged wrapper engine")
    out["paged"] = {"steps": peng.steps, "batches": len(items), "seconds": p_first + p_rest,
                    "ms_per_step": (p_first + p_rest) / peng.steps * 1e3, "capture_seconds": paot["capture_seconds"],
                    "aot": paot, "launches": pd, "page_outs": peng.stats.page_outs, "page_ins": peng.stats.page_ins,
                    "uncaptured_prefix": {"batches": PAGED_TWIN_BATCHES, "steps": punc.steps,
                                          "ms_per_step": punc_seconds / punc.steps * 1e3}}

    # MultioutputWrapper(remove_nans=False) through the megastep engine on two-head rows
    p2, t2 = two_head_rows(dev, preds_np, target_np)
    p2d, t2d = torch.from_numpy(p2).to(dev), torch.from_numpy(t2).to(dev)
    msubmit = lambda e, b: e.submit(p2d[b[0]:b[1]], t2d[b[0]:b[1]])  # noqa: E731
    meng, m_seconds = wrapper_engine_run(dev, batches, msubmit, True, make_multioutput_collection, mega)
    munc, _ = wrapper_engine_run(dev, batches, msubmit, False, make_multioutput_collection, mega)
    same_trees(munc.state(), meng.state(), "multioutput engine: uncaptured vs captured")
    want = {"multi": {"_children": {"metrics": [oracle_states(p2[:, :, h], t2[:, h])["acc"] for h in range(2)]}}}
    compare_trees(meng.state(), want, "multioutput engine vs numpy")
    out["multioutput_megastep"] = {"steps": meng.steps, "ms_per_step": m_seconds / meng.steps * 1e3,
                                   "capture_seconds": meng.aot_cache.stats()["capture_seconds"]}

    # (c) the refusals
    refusals = {}
    minmax = MetricCollection({"minmax": MinMaxMetric(Accuracy(device=dev))})
    for name, build in (("streaming", lambda: StreamingEngine(minmax, mega)),
                        ("paged", lambda: MultiStreamEngine(minmax, PAGED_STREAMS, paged, **pkw))):
        try:
            build()
        except MetricsTPUUserError as e:
            refusals[name] = str(e)
        check(REFUSAL in refusals.get(name, ""), f"the {name} engine did not refuse MinMaxMetric")
    nan_multi = make_multioutput_collection(dev, remove_nans=True)
    try:
        nan_multi.update_state_masked(nan_multi.init_state(), p2d[:BUCKET], t2d[:BUCKET],
                                      mask=torch.ones(BUCKET, dtype=torch.bool, device=dev))
        refusals["multioutput_remove_nans_masked"] = None
    except RuntimeError as e:
        refusals["multioutput_remove_nans_masked"] = str(e)[:120]
    check(refusals["multioutput_remove_nans_masked"] is not None,
          "a masked update of MultioutputWrapper(remove_nans=True) did not raise")
    out["refusals"] = refusals
    return out


# ---------------------------------------------------- phase 13: regression and pairwise

TWEEDIE_POWERS = (0.0, 1.0, 1.5, 2.0, 3.0)
SERVED_POWER = 1.5
MAPE_EPS = 1.17e-06
U32 = 2.0 ** -24  # the f32 unit roundoff
CORR_TOL = 1e-5
COSINE_DIM = 16
REG_SHARDS = 4
# the uncaptured twins' prefixes (each engine's captured run goes on past it)
REG_TWIN_BATCHES = {"streaming_megastep": 24, "multistream": 24, "paged": 240}
PAIR_ROWS, PAIR_DIM, MANHATTEN_ROWS, PAIR_SAMPLE = 8192, 512, 1024, 256
REG_REFUSALS = {  # the JAX package's reasons
    ("pearson", "streaming"): "full_state_update metrics read the accumulated state in update; a row fold is not exact",
    ("pearson", "multistream"): "full_state_update metrics read the accumulated state in update; row deltas are not exact",
    ("list", "streaming"): "state 'preds' is a list (cat/gather) state with no static shape",
    ("list", "multistream"): "state 'preds' is a list (cat/gather) state",
}
R2_REASON = "R2Score's compute reads n_obs on the host"


def regression_rows(dev):
    """Phase 13's seeded rows: gamma(2, 1) targets, and the targets times
    log-normal(0, 0.3) noise as predictions. Both are positive, so the log
    error and every Tweedie power are defined."""
    rng = np.random.RandomState(SEED + 13)
    t = rng.gamma(2.0, 1.0, N_ROWS).astype(np.float32)
    p = (t * np.exp(rng.normal(0.0, 0.3, N_ROWS))).astype(np.float32)
    return torch.from_numpy(p).to(dev), torch.from_numpy(t).to(dev), p, t


def make_regression_collection(device):
    """The eight members whose value the engines serve (phase 13(b))."""
    from metrics_tpu_torch import (ExplainedVariance, MeanAbsoluteError, MeanAbsolutePercentageError,
                                   MeanSquaredError, MeanSquaredLogError, MetricCollection,
                                   SymmetricMeanAbsolutePercentageError, TweedieDevianceScore)

    return MetricCollection({
        "mse": MeanSquaredError(device=device),
        "rmse": MeanSquaredError(squared=False, device=device),
        "mae": MeanAbsoluteError(device=device),
        "msle": MeanSquaredLogError(device=device),
        "mape": MeanAbsolutePercentageError(device=device),
        "smape": SymmetricMeanAbsolutePercentageError(device=device),
        "explained_variance": ExplainedVariance(device=device),
        "tweedie": TweedieDevianceScore(power=SERVED_POWER, device=device),
    })


def make_r2_collection(device):
    """R2Score alone: its updates serve, its value does not."""
    from metrics_tpu_torch import MetricCollection, R2Score

    return MetricCollection({"r2": R2Score(device=device)})


def tweedie_parts(p, t, power):
    """The float64 deviance per row at ``power``, and the magnitude of the
    parts each is computed from (what its f32 rounding scales with)."""
    if power == 0:
        d = (t - p) ** 2
        return d, d
    if power == 1:
        a = t * np.log(t / p)
        return 2 * (a + p - t), 2 * (np.abs(a) + p + t)
    if power == 2:
        a = np.log(p / t)
        return 2 * (a + t / p - 1), 2 * (np.abs(a) + t / p + 1)
    t1 = t ** (2 - power) / ((1 - power) * (2 - power))
    t2 = t * p ** (1 - power) / (1 - power)
    t3 = p ** (2 - power) / (2 - power)
    return 2 * (t1 - t2 + t3), 2 * (np.abs(t1) + np.abs(t2) + np.abs(t3))


def regression_terms(p, t, power=SERVED_POWER):
    """Per row, every state of the served members and of R2Score in float64:
    ``(term, parts)`` for an f32 sum (``parts`` bounds the term's own
    rounding), a plain array for an integer count."""
    p, t = p.astype(np.float64), t.astype(np.float64)
    d = p - t
    lp, lt = np.log1p(p), np.log1p(t)
    ld = lp - lt
    ones = np.ones_like(p)
    ape = np.abs(d) / np.maximum(np.abs(t), MAPE_EPS)
    sape = 2 * np.abs(d) / np.maximum(np.abs(t) + np.abs(p), MAPE_EPS)
    dev, parts = tweedie_parts(p, t, power)
    sq = (d * d, d * d)
    return {
        "mse": {"sum_squared_error": sq, "total": ones},
        "rmse": {"sum_squared_error": sq, "total": ones},
        "mae": {"sum_abs_error": (np.abs(d), np.abs(d)), "total": ones},
        "msle": {"sum_squared_log_error": (ld * ld, 2 * np.abs(ld) * (np.abs(lp) + np.abs(lt) + np.abs(ld))),
                 "total": ones},
        "mape": {"sum_abs_per_error": (ape, ape), "total": (ones, ones)},
        "smape": {"sum_abs_per_error": (sape, sape), "total": (ones, ones)},
        "explained_variance": {"sum_error": (-d, np.abs(d)), "sum_squared_error": sq, "sum_target": (t, t),
                               "sum_squared_target": (t * t, t * t), "n_obs": (ones, ones)},
        "tweedie": {"sum_deviance_score": (dev, parts), "num_observations": ones},
        "r2": {"sum_squared_error": (t * t, t * t), "sum_error": (t, t), "residual": sq, "total": ones},
    }


def regression_oracle(p, t, groups=None, num_groups=1, power=SERVED_POWER):
    """Every state's float64 sum, per group of rows (``groups``: each row's
    stream; None: one group), as ``{member: {state: (sum, bound)}}``; an
    integer count's bound is 0. An f32 sum of n terms is within
    2^-24 (2 n Σ|term| + 8 Σ parts) of the exact one: the reassociation
    bound of the masked folds, plus each term's own rounding."""
    groups = np.zeros(len(p), np.int64) if groups is None else groups
    n = np.bincount(groups, minlength=num_groups).astype(np.float64)
    out = {}
    for member, states in regression_terms(p, t, power).items():
        out[member] = {}
        for name, v in states.items():
            if isinstance(v, tuple):
                term, parts = v
                s = np.bincount(groups, weights=term, minlength=num_groups)
                mag = np.bincount(groups, weights=np.abs(term), minlength=num_groups)
                par = np.bincount(groups, weights=parts, minlength=num_groups)
                out[member][name] = (s, U32 * (2 * n * mag + 8 * par))
            else:
                out[member][name] = (np.bincount(groups, weights=v, minlength=num_groups), np.zeros(num_groups))
    return out


def check_regression_states(state, oracle, what):
    """Every leaf of ``state`` (stream-stacked or not) within its oracle bound;
    integer counts exact."""
    errs = {}
    for member, states in oracle.items():
        if member not in state:
            continue
        for name, (want, bound) in states.items():
            got = state[member][name].detach().double().cpu().numpy().reshape(len(want))
            err = np.abs(got - want)
            if state[member][name].is_floating_point():
                check(np.all(err <= bound), f"{what}: {member}.{name} err {err.max()} over bound {bound.max()}")
            else:
                check(np.array_equal(got, want), f"{what}: {member}.{name} count differs")
            errs[f"{member}.{name}"] = float(err.max()) if err.size else 0.0
    return errs


def _ev(s):
    n = s["n_obs"]
    num = s["sum_squared_error"] / n - (s["sum_error"] / n) ** 2
    den = s["sum_squared_target"] / n - (s["sum_target"] / n) ** 2
    return np.where((num != 0) & (den != 0), 1 - num / np.where(den != 0, den, 1), np.where(num != 0, 0.0, 1.0))


def _r2(s):
    n = s["total"]
    return 1 - s["residual"] / (s["sum_squared_error"] - s["sum_error"] * s["sum_error"] / n)


REG_VALUES = {
    "mse": lambda s: s["sum_squared_error"] / s["total"],
    "rmse": lambda s: np.sqrt(s["sum_squared_error"] / s["total"]),
    "mae": lambda s: s["sum_abs_error"] / s["total"],
    "msle": lambda s: s["sum_squared_log_error"] / s["total"],
    "mape": lambda s: s["sum_abs_per_error"] / s["total"],
    "smape": lambda s: s["sum_abs_per_error"] / s["total"],
    "explained_variance": _ev,
    "tweedie": lambda s: s["sum_deviance_score"] / s["num_observations"],
    "r2": _r2,
}


def regression_values(oracle):
    """Each member's value from its oracle sums, with the slack its f32
    compute may take: the value's move under each sum moved by its bound,
    plus 8 roundings of the intermediates the explained variance and R2
    subtract (their cancellation). Returns ``{member: (value, slack)}``."""
    out = {}
    with np.errstate(divide="ignore", invalid="ignore"):
        for member, states in oracle.items():
            s = {k: v for k, (v, _) in states.items()}
            fn = REG_VALUES[member]
            value = fn(s)
            slack = np.zeros_like(value)
            for k, (v, b) in states.items():
                move = np.zeros_like(value)
                for sign in (1, -1):
                    move = np.maximum(move, np.nan_to_num(np.abs(fn({**s, k: v + sign * b}) - value)))
                slack = slack + move
            n = s.get("n_obs", s.get("total"))
            if member == "explained_variance":
                a, b = s["sum_squared_error"] / n, (s["sum_error"] / n) ** 2
                c, e = s["sum_squared_target"] / n, (s["sum_target"] / n) ** 2
                slack = slack + 8 * U32 * np.nan_to_num((a + b) / np.abs(c - e) + np.abs(a - b) * (c + e) / (c - e) ** 2)
            if member == "r2":
                ss, se, rss = s["sum_squared_error"], s["sum_error"], s["residual"]
                tss = ss - se * se / n
                slack = slack + 8 * U32 * np.nan_to_num(rss * (ss + se * se / n) / tss ** 2 + np.abs(rss / tss))
            out[member] = (value, slack)
    return out


def check_regression_values(values, oracle_values, what):
    """``values`` (``{member: tensor}``, stream-stacked or not) within 1e-6
    relative plus 1e-6 of the oracle's, plus its slack; equal NaNs agree
    (an untouched stream's 0/0)."""
    worst = {}
    for member, got in values.items():
        want, slack = oracle_values[member]
        g = np.asarray([float(x) for x in got], np.float64) if isinstance(got, list) else \
            got.detach().double().cpu().numpy().reshape(len(want))
        err = np.abs(g - want)
        ok = (err <= 1e-6 * np.abs(want) + 1e-6 + slack) | (np.isnan(g) & np.isnan(want))
        check(np.all(ok), f"{what}: {member} {g[~ok][:3]} vs {want[~ok][:3]} (slack {slack[~ok][:3]})")
        worst[member] = float(np.nanmax(np.where(np.isnan(err), 0, err))) if err.size else 0.0
    return worst


def regression_eager(dev, p, t, pn, tn):
    """Phase 13(a): each regression metric over 4 batches and each functional
    over all rows on the card, against float64 numpy (scipy's correlations);
    Tweedie at every power; Pearson's Chan fold of 4 hand-stacked shards; the
    served collection through the masked bucket step (K1), padded with rows
    outside every domain."""
    from scipy import stats

    import metrics_tpu_torch.functional as F
    from metrics_tpu_torch import CosineSimilarity, PearsonCorrCoef, R2Score, SpearmanCorrCoef, TweedieDevianceScore

    out = {}
    t0 = time.perf_counter()
    batches = [(lo, lo + BATCH) for lo in range(0, N_ROWS, BATCH)]
    oracle = regression_oracle(pn, tn)
    want = regression_values(oracle)
    # the served members and R2Score
    coll, r2 = make_regression_collection(dev), R2Score(device=dev)
    for lo, hi in batches:
        coll.update(p[lo:hi], t[lo:hi])
        r2.update(p[lo:hi], t[lo:hi])
    state = {k: m._pack_state() for k, m in coll.items(keep_base=True)}
    state["r2"] = r2._pack_state()
    out["state_err"] = check_regression_states(state, oracle, "eager")
    values = {k: v for k, v in coll.compute().items()}
    values["r2"] = r2.compute()
    out["value_err"] = check_regression_values(values, want, "eager")
    out["values"] = {k: float(v) for k, v in values.items()}
    # the functionals over every row at once
    fvalues = {"mse": F.mean_squared_error(p, t), "rmse": F.mean_squared_error(p, t, squared=False),
               "mae": F.mean_absolute_error(p, t), "msle": F.mean_squared_log_error(p, t),
               "mape": F.mean_absolute_percentage_error(p, t), "smape": F.symmetric_mean_absolute_percentage_error(p, t),
               "explained_variance": F.explained_variance(p, t), "r2": F.r2_score(p, t),
               "tweedie": F.tweedie_deviance_score(p, t, power=SERVED_POWER)}
    out["functional_err"] = check_regression_values(fvalues, want, "functional")
    # Tweedie at every power, metric and functional
    tweedie = {}
    for power in TWEEDIE_POWERS:
        sub = {"tweedie": regression_oracle(pn, tn, power=power)["tweedie"]}
        m = TweedieDevianceScore(power=power, device=dev)
        for lo, hi in batches:
            m.update(p[lo:hi], t[lo:hi])
        check_regression_states({"tweedie": m._pack_state()}, sub, f"tweedie power {power}")
        w = regression_values(sub)
        check_regression_values({"tweedie": m.compute()}, w, f"tweedie power {power}")
        check_regression_values({"tweedie": F.tweedie_deviance_score(p, t, power=power)}, w,
                                f"tweedie functional power {power}")
        tweedie[str(power)] = float(m.compute())
    out["tweedie"] = tweedie
    # the correlations, against scipy in float64
    p64, t64 = pn.astype(np.float64), tn.astype(np.float64)
    pearson_want, spearman_want = stats.pearsonr(p64, t64)[0], stats.spearmanr(p64, t64)[0]
    pearson, spearman = PearsonCorrCoef(device=dev), SpearmanCorrCoef(device=dev)
    shards = [PearsonCorrCoef(device=dev) for _ in range(REG_SHARDS)]
    for (lo, hi), shard in zip(batches, shards):
        for m in (pearson, spearman, shard):
            m.update(p[lo:hi], t[lo:hi])
    stacked = {k: torch.stack([getattr(s, k) for s in shards]) for k in shards[0]._defaults}
    corr = {"pearson": float(pearson.compute()), "pearson_functional": float(F.pearson_corrcoef(p, t)),
            "pearson_chan_fold": float(pearson.compute_from(stacked)),
            "spearman": float(spearman.compute()), "spearman_functional": float(F.spearman_corrcoef(p, t))}
    for k, v in corr.items():
        w = spearman_want if k.startswith("spearman") else pearson_want
        check(abs(v - w) <= CORR_TOL, f"{k}: {v} vs scipy {w}")
    out["correlations"] = {**corr, "scipy_pearson": float(pearson_want), "scipy_spearman": float(spearman_want)}
    # cosine similarity of (N / 16, 16) vectors
    pv, tv = p.reshape(-1, COSINE_DIM), t.reshape(-1, COSINE_DIM)
    p2, t2 = p64.reshape(-1, COSINE_DIM), t64.reshape(-1, COSINE_DIM)
    cos = (p2 * t2).sum(1) / np.sqrt((p2 * p2).sum(1) * (t2 * t2).sum(1))
    cosine = CosineSimilarity(reduction="mean", device=dev)
    rows = len(pv) // REG_SHARDS
    for lo in range(0, len(pv), rows):
        cosine.update(pv[lo:lo + rows], tv[lo:lo + rows])
    got = {"mean": float(cosine.compute()), "sum": float(F.cosine_similarity(pv, tv))}
    check(abs(got["mean"] - cos.mean()) <= CORR_TOL, f"cosine mean: {got['mean']} vs {cos.mean()}")
    check(abs(got["sum"] - cos.sum()) <= CORR_TOL * len(cos), f"cosine sum: {got['sum']} vs {cos.sum()}")
    none = F.cosine_similarity(pv, tv, reduction="none").double().cpu().numpy()
    check(np.abs(none - cos).max() <= CORR_TOL, "cosine per row")
    out["cosine"] = got
    # the served collection through masked 1024-row buckets (K1), padding outside every domain
    rng = np.random.RandomState(SEED + 15)
    mcoll = make_regression_collection(dev)
    mstate = mcoll.init_state()
    lo, buckets = 0, 0
    while lo < N_ROWS:
        valid = min(int(rng.randint(BUCKET // 2, BUCKET + 1)), N_ROWS - lo)
        bp = np.full(BUCKET, -1.0, np.float32)  # log1p(-1) = -inf, a negative Tweedie prediction
        bt = np.full(BUCKET, np.nan, np.float32)
        bp[:valid], bt[:valid] = pn[lo:lo + valid], tn[lo:lo + valid]
        mask = np.arange(BUCKET) < valid
        mstate = mcoll.update_state_masked(mstate, torch.from_numpy(bp).to(dev), torch.from_numpy(bt).to(dev),
                                           mask=torch.from_numpy(mask).to(dev))
        lo += valid
        buckets += 1
    out["masked_buckets"] = buckets
    out["masked_state_err"] = check_regression_states(mstate, oracle, "masked buckets")
    check_regression_values(mcoll.compute_from(mstate), want, "masked buckets")
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    return out


def regression_engine(dev, make, kind, capture, items):
    """A regression engine of ``kind`` (phase 7's megastep ``StreamingEngine``,
    phase 8's unsharded or phase 9a's paged ``MultiStreamEngine``), one batch
    a step (``coalesce=1``: grouping follows timing, and f32 sums folded in
    other groups differ in their last bits), driven over ``items``."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine

    if kind == "streaming_megastep":
        eng = StreamingEngine(make(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep", coalesce=1))
    elif kind == "multistream":
        eng = MultiStreamEngine(make(dev), MS_STREAMS, EngineConfig(buckets=(256, BUCKET), coalesce=1))
    else:
        eng = MultiStreamEngine(make(dev), PAGED_STREAMS, EngineConfig(buckets=PAGED_BUCKETS, kernel_backend="megastep",
                                                                       coalesce=1),
                                stream_shard=True, resident_streams=RESIDENT)
    return eng, regression_run(eng, capture, items)


def regression_run(eng, capture, items):
    return run_engine(eng, capture, items, lambda e, b: e.submit(*b))


def regression_served(dev, p, t, pn, tn):
    """Phase 13(b): the served collection and R2Score alone through three
    engines, each first over an uncaptured twin's prefix (bit-equal), then
    on to every row captured; every state (every stream's) within its bound
    of the float64 oracle; the collection's values from ``result()`` or one
    timed ``results()`` against the oracle's; R2Score's served value raises."""
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    out = {}
    layouts = {
        "streaming_megastep": (ragged_batches(SEED + 2, 16, BUCKET), None),
        "multistream": (ragged_batches(SEED + 3, 16, BUCKET), MS_STREAMS),
        "paged": (ragged_batches(SEED + 4, 8, 64), PAGED_STREAMS),
    }
    for kind, (batches, streams) in layouts.items():
        if streams is None:
            items = [(p[a:b], t[a:b]) for a, b in batches]
            groups, num = None, 1
        else:
            sids = zipf_stream_ids(streams, len(batches), ALPHA, SEED + (3 if kind == "multistream" else 4))
            items = [(int(s), p[a:b], t[a:b]) for s, (a, b) in zip(sids, batches)]
            groups = np.repeat(sids.astype(np.int64), [b - a for a, b in batches])
            num = streams
        oracle = regression_oracle(pn, tn, groups, num)
        prefix = REG_TWIN_BATCHES[kind]
        for name, make in (("regression", make_regression_collection), ("r2", make_r2_collection)):
            before = counts()
            eng, first = regression_engine(dev, make, kind, True, items[:prefix])
            mid = counts()
            twin, twin_seconds = regression_engine(dev, make, kind, False, items[:prefix])
            d_twin = delta(mid)
            same_trees(twin.state(), eng.state(), f"{kind} {name}: uncaptured twin vs captured, {prefix} batches")
            resumed = counts()
            rest = regression_run(eng, True, items[prefix:])
            d = {k: v + mid[k] - before[k] for k, v in delta(resumed).items()}
            check(eng.stats.kernel_fallbacks_by_reason() == {}, f"{kind} {name} fell back: {eng.stats.kernel_fallbacks}")
            # every step the card ran: the served ones and each capture's warm-up; two arena dtypes (f32, int32)
            for e, launched in ((eng, d), (twin, d_twin)):
                n = e.steps + e.stats.warmup_steps
                if kind == "streaming_megastep":
                    ok = launched["megastep_fold"] == 2 * n and launched["fold_rows"] == 0
                elif kind == "multistream":
                    ok = launched["segment_reduce"] == e.arena_layout.num_leaves * n
                else:
                    ok = launched["megastep_segment"] == 2 * n and e.stats.page_outs > 0
                check(ok, f"{kind} {name}: {launched} in {n} steps")
            state = eng.state()
            entry = {"steps": eng.steps, "batches": len(items), "seconds": first + rest,
                     "ms_per_step": (first + rest) / eng.steps * 1e3, "launches": d,
                     "aot": check_cache(eng, f"{kind} {name}"),
                     "uncaptured_prefix": {"batches": prefix, "steps": twin.steps,
                                           "ms_per_step": twin_seconds / twin.steps * 1e3},
                     "state_err": check_regression_states(state, {k: oracle[k] for k in state}, f"{kind} {name}")}
            if kind == "paged":
                entry.update(page_ins=eng.stats.page_ins, page_outs=eng.stats.page_outs)
            want = regression_values({k: oracle[k] for k in state})
            if name == "r2":
                for call in ([eng.result] if streams is None else [eng.results, lambda: eng.result(0)]):
                    try:
                        call()
                        raised = None
                    except MetricsTPUUserError as e:
                        raised = str(e)
                    check(raised is not None and R2_REASON in raised, f"{kind}: R2Score's served value did not raise")
                entry["served_value_raises"] = raised[:80]
                # the eager compute of the served state works: every stream's would take seconds, so 16 of them
                r2 = eng._metric["r2"]
                picked = [0] if streams is None else sorted(int(s) for s in np.unique(groups)[:: max(1, num // 16)])
                got = [r2.compute_from(eng.state()["r2"] if streams is None else eng.stream_state(sid)["r2"])
                       for sid in picked]
                w, slack = want["r2"]
                entry["value_err_eager"] = check_regression_values(
                    {"r2": got}, {"r2": (w[picked], slack[picked])}, f"{kind} r2 eager on served state")
            elif streams is None:
                entry["value_err"] = check_regression_values(eng.result(), want, f"{kind} result()")
            else:
                sample = range(streams) if kind == "multistream" else \
                    result_sample(eng, {int(s) for s in np.unique(groups)})
                entry["results"] = results_timing(eng, sample)
                values = eng.results()
                stacked = {m: [values[sid][m] for sid in range(streams)] for m in want}
                entry["value_err"] = check_regression_values(stacked, want, f"{kind} results()")
            out[f"{kind}_{name}"] = entry
    return out


def regression_refusals(dev):
    """Phase 13(c): the engines refuse Pearson, Spearman and CosineSimilarity
    with the JAX package's reasons."""
    from metrics_tpu_torch import CosineSimilarity, MetricCollection, PearsonCorrCoef, SpearmanCorrCoef
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    out = {}
    engines = {
        "streaming": lambda c: StreamingEngine(c, EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep")),
        "multistream": lambda c: MultiStreamEngine(c, MS_STREAMS, EngineConfig(buckets=(256, BUCKET))),
        "paged": lambda c: MultiStreamEngine(c, PAGED_STREAMS, EngineConfig(buckets=PAGED_BUCKETS,
                                                                            kernel_backend="megastep"),
                                             stream_shard=True, resident_streams=RESIDENT),
    }
    for name, cls in (("pearson", PearsonCorrCoef), ("spearman", SpearmanCorrCoef), ("cosine", CosineSimilarity)):
        for kind, build in engines.items():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # Spearman's buffer warning
                coll = MetricCollection({"x": cls(device=dev)})
            try:
                build(coll)
                reason = None
            except MetricsTPUUserError as e:
                reason = str(e)
            want = REG_REFUSALS[("pearson" if name == "pearson" else "list",
                                 "streaming" if kind == "streaming" else "multistream")]
            check(reason is not None and reason.endswith(want), f"{kind} engine: {name} refusal {reason!r}")
            out[f"{name}_{kind}"] = reason
    return out


def pairwise_phase(dev):
    """Phase 13(d): the four pairwise functions on the card against float64
    numpy on a sample of rows: cosine, linear and euclidean at
    (8192, 512) x (8192, 512), manhatten at (1024, 512) x (1024, 512) (its
    (N, M, d) broadcast holds 2 GiB). An f32 dot product over d terms is
    within 2 d 2^-24 Σ|x_k y_k| of the exact one; a euclidean distance within
    the square root of its expansion's bound, or that bound over the
    distance where smaller; a manhatten distance within (2 d + 2) 2^-24 of
    its own size."""
    import metrics_tpu_torch.functional as F

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on: the products would not be f32")
    rng = np.random.RandomState(SEED + 16)
    x = rng.normal(size=(PAIR_ROWS, PAIR_DIM)).astype(np.float32)
    y = rng.normal(size=(PAIR_ROWS, PAIR_DIM)).astype(np.float32)
    xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    rows = np.sort(rng.choice(PAIR_ROWS, PAIR_SAMPLE, replace=False))
    xs, y64 = x[rows].astype(np.float64), y.astype(np.float64)
    dots, absdots = xs @ y64.T, np.abs(xs) @ np.abs(y64).T
    nx, ny = (xs * xs).sum(1)[:, None], (y64 * y64).sum(1)[None, :]
    d = PAIR_DIM
    out = {}

    picked = torch.from_numpy(rows).to(dev)

    def held(name, fn, want, allowed):
        err = np.abs(fn()[picked].double().cpu().numpy() - want)
        check(np.all(err <= allowed), f"pairwise {name}: err {err.max()} over its bound")
        out[name] = {"max_abs_err": float(err.max()), "ms": gpu_ms(fn, runs=5)}

    held("linear", lambda: F.pairwise_linear_similarity(xd, yd), dots, 2 * d * U32 * absdots + 1e-30)
    cos_want = dots / np.sqrt(nx * ny)
    held("cosine", lambda: F.pairwise_cosine_similarity(xd, yd), cos_want,
         2 * (d + 4) * U32 * absdots / np.sqrt(nx * ny) + 1e-30)
    sq = nx + ny - 2 * dots
    euc_want = np.sqrt(np.maximum(sq, 0))
    bsq = 2 * (d + 2) * U32 * (nx + ny + 2 * absdots)
    held("euclidean", lambda: F.pairwise_euclidean_distance(xd, yd), euc_want,
         np.minimum(np.sqrt(bsq), bsq / np.maximum(euc_want, 1e-30)))
    # the reductions over the same matrix: a row's mean of the sampled rows' full rows
    mean = F.pairwise_linear_similarity(xd, yd, reduction="mean")[picked].double().cpu().numpy()
    check(np.all(np.abs(mean - dots.mean(1)) <= (2 * d * U32 * absdots).mean(1) + 1e-6 * np.abs(dots).mean(1)),
          "pairwise linear mean")
    xm, ym = x[:MANHATTEN_ROWS], y[:MANHATTEN_ROWS]
    msample = rows[rows < MANHATTEN_ROWS]
    man_want = np.abs(xm[msample].astype(np.float64)[:, None, :] - ym.astype(np.float64)[None, :, :]).sum(-1)
    got = F.pairwise_manhatten_distance(xd[:MANHATTEN_ROWS], yd[:MANHATTEN_ROWS])
    err = np.abs(got[torch.from_numpy(msample).to(dev)].double().cpu().numpy() - man_want)
    check(np.all(err <= (2 * d + 2) * U32 * man_want), f"pairwise manhatten: err {err.max()}")
    out["manhatten"] = {"max_abs_err": float(err.max()), "sampled_rows": int(len(msample)),
                        "ms": gpu_ms(lambda: F.pairwise_manhatten_distance(xd[:MANHATTEN_ROWS], yd[:MANHATTEN_ROWS]),
                                     runs=5)}
    zero = F.pairwise_euclidean_distance(xd[:64])
    check(bool((torch.diagonal(zero) == 0).all()), "pairwise euclidean: x against itself keeps its diagonal")
    out["sampled_rows"] = PAIR_SAMPLE
    return out


def regression_phase(dev):
    """Phase 13: regression and pairwise on the flagship's 65 536 rows."""
    p, t, pn, tn = regression_rows(dev)
    out = {"eager": regression_eager(dev, p, t, pn, tn)}
    out["served"] = regression_served(dev, p, t, pn, tn)
    out["bucket_1024"] = profile_bucket(dev, p, t, make=make_regression_collection)
    out["refusals"] = regression_refusals(dev)
    out["pairwise"] = pairwise_phase(dev)
    return out


# ------------------------------------------------ phase 14: cross-process sync

SYNC_TIMED = 20  # syncs per host-ms median
SYNC_BATCHES = 4  # update batches over all rows, as phases 4 and 13(a)


def make_sync_collections(device, capacity):
    """Phase 14's two collections: the flagship plus capacity AUROC and AP
    (phase 4's rows), and phase 13's served members plus Pearson (stacked
    None moments) and a ``MinMaxMetric`` of an MSE (min/max states), the
    MSE's squared-error sum on the q8 carrier (phase 13's rows)."""
    from metrics_tpu_torch import AUROC, AveragePrecision, MeanSquaredError, MinMaxMetric, PearsonCorrCoef

    cls = make_collection(device)
    cls.add_metrics({"auroc": AUROC(num_classes=NUM_CLASSES, capacity=capacity, device=device),
                     "ap": AveragePrecision(num_classes=NUM_CLASSES, capacity=capacity, device=device)})
    reg = make_regression_collection(device)
    reg.add_metrics({"pearson": PearsonCorrCoef(device=device),
                     "minmax": MinMaxMetric(MeanSquaredError(device=device))})
    reg["mse"].set_sync_precision("q8_block")
    return cls, reg


def sync_rows(dev, lo, hi):
    """Rows ``lo:hi`` of phase 4's and of phase 13's seeded rows, on ``dev``."""
    preds, target, _, _ = main_rows(dev)
    rp, rt, _, _ = regression_rows(dev)
    return (preds[lo:hi], target[lo:hi]), (rp[lo:hi], rt[lo:hi])


def sync_update(colls, rows, batches):
    for coll, (p, t) in zip(colls, rows):
        step = p.shape[0] // batches
        for lo in range(0, p.shape[0], step):
            coll.update(p[lo:lo + step], t[lo:lo + step])


def coll_state(coll):
    return {k: m._pack_state() for k, m in coll.items(keep_base=True)}


def host_tree(x, fn=lambda t: t.detach().cpu()):
    """A state or value tree with ``fn`` applied to every tensor (default: a
    host copy)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: host_tree(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [host_tree(v, fn) for v in x]
    return x


def numpy_tree(x):
    """``host_tree`` as numpy arrays: what a rank sends through a queue (a
    tensor would travel as a file descriptor the exiting rank closes)."""
    return host_tree(x, lambda t: t.detach().cpu().numpy())


def timed_syncs(coll, state, dev):
    """Median host ms of one ``sync_states`` of ``state`` (device drained)."""
    times = []
    for _ in range(SYNC_TIMED):
        t0 = time.perf_counter()
        coll.sync_states(state)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bundle_numbers(coll, state, world):
    """One counted ``sync_states``: its collectives against the plan's, and
    the payload bytes of the declared precisions and of all-exact ones."""
    from metrics_tpu_torch.parallel import collectives as col

    leaves = coll.sync_leaf_info()
    col.reset_collective_counts()
    synced = coll.sync_states(state)
    got = col.collective_counts()
    plan = col.fused_sync_plan(leaves, world)
    check(got["all_reduce"] + got["all_gather"] == plan["collectives"],
          f"sync bundle: {got} collectives, the plan names {plan['collectives']}")
    return synced, {"collectives": got, "plan_collectives": plan["collectives"],
                    "payload_bytes": col.sync_payload_bytes(leaves, world),
                    "payload_bytes_exact": col.sync_payload_bytes([(f, l, "exact") for f, l, _ in leaves], world)}


def sync_rank(rank, store, device, queue):
    """One rank of phase 14(b): gloo at world 2 with the tensors on ``device``
    (the first card); updates its half of the rows, syncs, computes; sends
    the host copies back."""
    import torch.distributed as dist

    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
        half = N_ROWS // 2
        colls = make_sync_collections(dev, half)
        sync_update(colls, sync_rows(dev, rank * half, (rank + 1) * half), SYNC_BATCHES // 2)
        out = {"local": [], "synced": [], "values": [], "bundle": [], "sync_ms": []}
        for coll in colls:
            state = coll_state(coll)
            synced, numbers = bundle_numbers(coll, state, 2)
            check(all(v.device == dev for v in tensor_leaves(synced)), "gloo sync left the card")
            out["local"].append(host_tree(state))
            out["synced"].append(host_tree(synced))
            out["values"].append(host_tree(coll.compute()))  # eager: every member syncs itself
            out["bundle"].append(numbers)
            out["sync_ms"].append(timed_syncs(coll, state, dev))
        dist.destroy_process_group()
        queue.put((rank, True, numpy_tree(out)))
    except BaseException:  # noqa: BLE001 - the parent reports it and fails
        import traceback

        queue.put((rank, False, traceback.format_exc()))


def tensor_tree(x):
    """Inverse of :func:`numpy_tree`."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, dict):
        return {k: tensor_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [tensor_tree(v) for v in x]
    return x


def tensor_leaves(tree):
    """Every tensor of a state tree."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return []


def same_tree(got, want, what):
    """Bit-equal trees of host tensors."""
    if isinstance(want, dict):
        check(set(got) == set(want), f"{what}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            same_tree(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, list):
        check(len(got) == len(want), f"{what}: lengths differ")
        for i, (g, x) in enumerate(zip(got, want)):
            same_tree(g, x, f"{what}[{i}]")
    else:
        check(got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want),
              f"{what}: differs ({got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)})")


def sync_phase(dev, gpu_state, gpu_values):
    """Phase 14: (a) NCCL at world 1, (b) gloo at world 2 in two processes on
    the card, held against (a). Returns the phase's numbers."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as tmp

    from metrics_tpu_torch.parallel.collectives import q8_roundtrip, q8_sum_error_bound

    out = {}
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_sync_")
    t0 = time.perf_counter()
    # (a) NCCL, world 1 (gloo when rehearsed on the CPU)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(store_dir, "world1"), 1), rank=0, world_size=1)
    try:
        colls = make_sync_collections(dev, N_ROWS)
        sync_update(colls, sync_rows(dev, 0, N_ROWS), SYNC_BATCHES)
        world1 = {"local": [], "synced": [], "values": [], "bundle": [], "sync_ms": []}
        for coll in colls:
            state = coll_state(coll)
            values = host_tree(coll.compute())  # world 1: no eager sync
            for k, m in coll.items(keep_base=True):  # the eager transport, forced at world 1
                with m.sync_context(distributed_available_fn=lambda: True):
                    check(m._is_synced, f"14(a) {k}: the eager sync did not run")
                    eager = host_tree(m.compute_from(m._pack_state()))
                same_tree(host_tree(m._pack_state()), host_tree(state[k]), f"14(a) {k} restored after unsync")
                check(tree_err(eager, values[k]) == 0, f"14(a) {k}: eager synced value differs")
            synced, numbers = bundle_numbers(coll, state, 1)
            synced_values = host_tree(coll.compute_from(synced))
            world1["local"].append(host_tree(state))
            world1["synced"].append(host_tree(synced))
            world1["values"].append(values)
            world1["bundle"].append(numbers)
            world1["sync_ms"].append(timed_syncs(coll, state, dev))
            for k, v in values.items():
                if k not in ("mse", "rmse"):  # the q8 leaf: checked below
                    check(tree_err(synced_values[k], v) == 0, f"14(a) compute_synced {k} differs from compute")
    finally:
        dist.destroy_process_group()
    cls_local, reg_local = world1["local"]
    cls_synced, reg_synced = world1["synced"]
    for k in ("acc", "f1", "binned_ap", "confmat"):
        same_tree(host_tree({s: cls_local[k][s] for s in gpu_state[k]}), host_tree(gpu_state[k]), f"14(a) {k} vs phase 4")
        check(tree_err(world1["values"][0][k], gpu_values[k]) == 0, f"14(a) {k} value vs phase 4")
    for i, (local, synced) in enumerate(zip(world1["local"], world1["synced"])):
        for k in local:
            for s, v in local[k].items():
                if k == "mse" and s == "sum_squared_error":
                    want = torch.from_numpy(q8_roundtrip(v)).reshape(v.shape)
                    check(torch.equal(synced[k][s], want), "14(a) q8 leaf is not its one-rank round trip")
                elif s == "_children":
                    continue
                elif synced[k][s].shape != v.shape:  # fx=None: stacked (1, ...)
                    check(torch.equal(synced[k][s], v[None]), f"14(a) {k}.{s} not stacked")
                else:
                    check(torch.equal(synced[k][s], v), f"14(a) {k}.{s} changed by a world-1 sync")
    out["world1"] = {"backend": backend, "bundles": world1["bundle"], "sync_host_ms": world1["sync_ms"],
                     "seconds": time.perf_counter() - t0}

    # (b) gloo, world 2: two processes on the card, half the rows each
    t0 = time.perf_counter()
    ctx = tmp.get_context("spawn")
    queue = ctx.Queue()
    store = os.path.join(store_dir, "gloo")
    procs = [ctx.Process(target=sync_rank, args=(r, store, str(dev), queue)) for r in range(2)]
    for proc in procs:
        proc.start()
    try:
        got = {}
        for _ in procs:
            rank, ok, res = queue.get(timeout=300)
            check(ok, f"14(b) rank {rank} failed:\n{res}")
            got[rank] = tensor_tree(res)
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    check(all(proc.exitcode == 0 for proc in procs), "14(b): a rank did not exit cleanly")
    ranks = [got[0], got[1]]
    for i in range(2):
        same_tree(ranks[1]["synced"][i], ranks[0]["synced"][i], "14(b) ranks' synced states")
    # the flagship's counts and the capacity buffers: bit for bit
    b_cls, b_reg = ranks[0]["synced"]
    for k in cls_local:
        same_tree(b_cls[k], cls_local[k], f"14(b) {k}")
    errs = {}
    for k, member in reg_local.items():
        for s, want in member.items():
            if s == "_children":
                continue
            parts = torch.stack([r["local"][1][k][s] for r in ranks])
            gotv = b_reg[k][s]
            if not want.is_floating_point():
                check(torch.equal(gotv, want), f"14(b) {k}.{s} differs")
            elif k == "minmax":
                fold = parts.min(0).values if s == "min_val" else parts.max(0).values
                check(torch.equal(gotv, fold), f"14(b) {k}.{s} differs from the ranks' fold")
            elif k == "pearson":
                check(gotv.shape == (2,) + tuple(want.shape), f"14(b) pearson {s} not stacked")
            else:
                # four roundings apart: (a) summed four batch sums in a row, (b) two per rank then the ranks
                bound = 2.0**-22 * (parts.abs().sum(0).double() + want.abs().double())
                if k == "mse" and s == "sum_squared_error":
                    bound = bound + torch.from_numpy(q8_sum_error_bound(parts)).double()
                err = (gotv.double() - want.double()).abs()
                check(bool((err <= bound).all()), f"14(b) {k}.{s}: err {float(err.max())} > {float(bound.max())}")
                errs[f"{k}.{s}"] = float(err.max())
    for r in ranks:
        for i, want_vals in enumerate(world1["values"]):
            for k, v in want_vals.items():
                gotv = r["values"][i][k]
                if k == "minmax":  # its extremes follow each rank's own prefixes
                    gotv, v = gotv["raw"], v["raw"]
                e = tree_err(gotv, v)
                tol = 0.0 if i == 0 else 2e-5 * max(1.0, flat_tree_abs(v))
                check(e <= tol, f"14(b) compute() {k}: err {e} > {tol}")
    out["world2"] = {"backend": "gloo", "transport": f"gloo/{dev.type}", "bundles": ranks[0]["bundle"],
                     "sync_host_ms": [r["sync_ms"] for r in ranks], "f32_sum_max_abs_err": errs,
                     "seconds": time.perf_counter() - t0}
    out["nccl_world_gt_1"] = "not run: one card takes one NCCL rank"
    return out


def tree_err(got, want):
    """``max_abs_err`` over value trees (a list of per-class tensors stacks)."""
    if isinstance(want, dict):
        check(set(got) == set(want), f"value keys {sorted(got)} != {sorted(want)}")
        return max(tree_err(got[k], want[k]) for k in want)
    got = torch.stack(list(got)) if isinstance(got, (list, tuple)) else got
    want = torch.stack(list(want)) if isinstance(want, (list, tuple)) else want
    return max_abs_err(got, want)


def flat_tree_abs(x):
    """The largest |value| of a value tree (for a relative tolerance)."""
    if isinstance(x, dict):
        return max(flat_tree_abs(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return max(flat_tree_abs(v) for v in x)
    return float(torch.as_tensor(x).double().abs().max())

# --------------------------------------------------- phase 15: the compiled forward

FWD_BATCH = 1024  # a training loop's per-step call: 64 forwards over the 65 536 rows
FWD_SUFFIX = " (detected by a compiled forward step; raised deferred)"
# each signature's entry kind after the run, as the JAX package's forward leaves
# them (pinned on the CPU against JAX by tests/test_torch_forward.py)
FWD_REGRESSION_KINDS = {"collection": ["eager_only"], **{k: ["compiled"] for k in (
    "mse", "rmse", "mae", "msle", "mape", "smape", "explained_variance", "tweedie")}, "r2": ["eager_only"]}


def fwd_kinds(owner):
    """Each signature's entry of ``owner``'s compiled forward: compiled, eager_only or pending."""
    from metrics_tpu_torch.metric import forward_entry_kinds

    return forward_entry_kinds(owner)


def fwd_entry(owner):
    """``owner``'s one built forward step (a ``CapturedForward``)."""
    from metrics_tpu_torch.metric import compiled_forward_steps

    entries = compiled_forward_steps(owner)
    check(len(entries) == 1, f"expected one built forward step, got {len(entries)}")
    return entries[0]


def same_value_trees(got, want, what):
    """Bit-equal value trees (dicts, lists of per-class tensors, tensors)."""
    if isinstance(want, dict):
        check(set(got) == set(want), f"{what}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            same_value_trees(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        check(len(got) == len(want), f"{what}: length")
        for i, (g, w) in enumerate(zip(got, want)):
            same_value_trees(g, w, f"{what}[{i}]")
    else:
        check(got.shape == want.shape and got.dtype == want.dtype and torch.equal(got, want), f"{what} differs")


def eager_twin(owner):
    """``owner`` with the compiled forward off: every call the eager
    ``compute_from(update_state(init_state(), ...))`` and merge."""
    from metrics_tpu_torch.metric import keep_forward_eager

    return keep_forward_eager(owner)


def forward_run(owner, batches):
    """``owner(p, t)`` per batch: the values, host ms per call (the device
    drained after each), the launches of all calls and of the first, and the
    device memory the second call (the capture) kept."""
    before = counts()
    values, host_ms, mem = [], [], []
    for i, (p, t) in enumerate(batches):
        t0 = time.perf_counter()
        values.append(owner(p, t))
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        mem.append(torch.cuda.memory_allocated())
        if i == 0:
            first = delta(before)
    # (the capture empties PyTorch's cache of free blocks: reserved memory says nothing here)
    return values, host_ms, {"launches": delta(before), "first_call_launches": first,
                             "capture_allocated_bytes": mem[1] - mem[0]}


def forward_profile(owner, p, t):
    """Device launches and µs of one more forward of ``owner`` (profiler)."""
    trace = device_trace(lambda: owner(p, t), runs=10)
    return {"device_launches": sum(c for _, c in trace.values()), "device_us": sum(us for us, _ in trace.values())}


def forward_members_phase(owner, twin, batches, what, state_of, want_state):
    """One owner's forwards against its eager twin's: values bit-equal, final
    states bit-equal to the twin's and to ``want_state``; host ms per call
    (the median over the replays), launches and the capture's memory."""
    vals, host_ms, run = forward_run(owner, batches)
    twin_vals, twin_ms, _ = forward_run(twin, batches)
    for i, (g, w) in enumerate(zip(vals, twin_vals)):
        same_value_trees(g, w, f"15{what} batch {i} vs the eager twin")
    got = state_of(owner)
    same_value_trees(got, state_of(twin), f"15{what} state vs the eager twin")
    if want_state is not None:
        compare_states(got, want_state, f"15{what} vs phase 4")
    return {"host_ms_median": float(np.median(host_ms[2:])), "host_ms_eager_call": host_ms[0],
            "host_ms_capture_call": host_ms[1], "eager_twin_host_ms_median": float(np.median(twin_ms[2:])), **run}


def forward_phase(dev, preds, target, gpu_state, gpu_values):
    """Phase 15: ``Metric.forward`` and ``MetricCollection.forward`` as one
    CUDA graph per input signature (``engine/aot.py``'s ``CapturedForward``),
    against eager twins. Returns the phase's numbers."""
    from metrics_tpu_torch import BinnedAveragePrecision, ConfusionMatrix, Metric, R2Score, TweedieDevianceScore
    from metrics_tpu_torch.engine.aot import FORWARD_CACHE

    out = {}
    batches = [(preds[lo:lo + FWD_BATCH], target[lo:lo + FWD_BATCH]) for lo in range(0, N_ROWS, FWD_BATCH)]
    n = len(batches)
    cache0 = FORWARD_CACHE.stats()

    # (a) the flagship collection, fused into one graph
    state_of = lambda c: {k: {s: getattr(m, s) for s in m._defaults} for k, m in c.items(keep_base=True)}
    coll = make_collection(dev)
    a = forward_members_phase(coll, eager_twin(make_collection(dev)), batches, "(a) flagship", state_of, gpu_state)
    entry = fwd_entry(coll)
    check(fwd_kinds(coll) == ["compiled"] and entry.captures == 1 and entry.replays == n - 1,
          f"15(a): {fwd_kinds(coll)}, {entry.captures} captures, {entry.replays} replays")
    kept = coll.compute()  # the confusion matrix's is its state tensor: (e) forwards again and reads it
    same_value_trees(flat_values(kept), gpu_values, "15(a) compute() vs phase 4")
    per_forward = a.pop("first_call_launches")
    for k in ("histogram", "binned_counts"):
        # the eager call and the warm-up launch for real; each replay credits the captured launches
        check(per_forward[k] > 0 and a["launches"][k] == (n + 1) * per_forward[k],
              f"15(a) {k}: {a['launches'][k]} launches, {per_forward[k]} per forward")
    a.update({"forwards": n, "eager": 1, "captures": entry.captures, "replays": entry.replays,
              "eager_only": 0, "capture_seconds": entry.capture_seconds,
              "per_forward_launches": {k: v for k, v in per_forward.items() if v}})
    a["profile_captured"] = forward_profile(coll, *batches[0])
    a["profile_eager"] = forward_profile(eager_twin(make_collection(dev)), *batches[0])
    out["a_flagship"] = a

    # (b) BinnedAveragePrecision alone: the single metric's step
    make_ap = lambda: BinnedAveragePrecision(num_classes=NUM_CLASSES, thresholds=THRESHOLDS, device=dev)
    ap = make_ap()
    b = forward_members_phase(ap, eager_twin(make_ap()), batches, "(b) binned AP",
                                    lambda m: {"binned_ap": {s: getattr(m, s) for s in m._defaults}},
                                    {"binned_ap": gpu_state["binned_ap"]})
    entry = fwd_entry(ap)
    check(fwd_kinds(ap) == ["compiled"] and entry.captures == 1 and entry.replays == n - 1,
          f"15(b): {fwd_kinds(ap)}, {entry.captures} captures, {entry.replays} replays")
    b.pop("first_call_launches")
    check(b["launches"]["binned_counts"] == n + 1, f"15(b) K3: {b['launches']['binned_counts']} launches")
    b.update({"forwards": n, "captures": entry.captures, "replays": entry.replays, "eager_only": 0,
              "capture_seconds": entry.capture_seconds})
    b["profile_captured"] = forward_profile(ap, *batches[0])
    b["profile_eager"] = forward_profile(eager_twin(make_ap()), *batches[0])
    out["b_binned_ap"] = b

    # (c) phase 13's regression members and R2Score as a collection: the fused
    # step fails (R2Score's compute reads n_obs on the host), the members take their own
    def make_reg():
        c = make_regression_collection(dev)
        c["r2"] = R2Score(device=dev)
        return c

    rp, rt, _, _ = regression_rows(dev)
    reg_batches = [(rp[lo:lo + FWD_BATCH], rt[lo:lo + FWD_BATCH]) for lo in range(0, N_ROWS, FWD_BATCH)]
    reg = make_reg()
    eager_only0 = FORWARD_CACHE.eager_only
    c = forward_members_phase(reg, eager_twin(make_reg()), reg_batches, "(c) regression", state_of, None)
    c.pop("first_call_launches")
    kinds = {"collection": fwd_kinds(reg), **{k: fwd_kinds(m) for k, m in reg.items(keep_base=True)}}
    check(kinds == FWD_REGRESSION_KINDS, f"15(c) entry kinds {kinds}")
    members = [fwd_entry(m) for k, m in reg.items(keep_base=True) if k != "r2"]
    check(all(e.captures == 1 and e.replays == n - 1 for e in members), "15(c): a member's captures or replays")
    c.update({"forwards": n, "kinds": kinds, "captures": sum(e.captures for e in members),
              "replays": sum(e.replays for e in members), "eager_only": FORWARD_CACHE.eager_only - eager_only0,
              "capture_seconds": sum(e.capture_seconds for e in members)})
    check(c["eager_only"] == 2, f"15(c): {c['eager_only']} eager-only signatures, not 2")
    out["c_regression"] = c

    # (d) deferred checks on the card: forward returns, compute() raises JAX's message until reset()
    d = {}
    for name, make, good, bad, msg in (
            ("confmat", lambda: ConfusionMatrix(num_classes=NUM_CLASSES, device=dev), batches[0],
             (batches[0][0], torch.full_like(batches[0][1], NUM_CLASSES)),
             "The highest label in `target` should be smaller than the size of the `C` dimension of `preds`."),
            ("tweedie", lambda: TweedieDevianceScore(power=SERVED_POWER, device=dev), reg_batches[0],
             (reg_batches[0][0], -reg_batches[0][1]),
             "Tweedie deviance inputs violate the positivity domain for the chosen `power`.")):
        m = make()
        for _ in range(3):
            m(*good)
        check(fwd_kinds(m) == ["compiled"], f"15(d) {name}: {fwd_kinds(m)}")
        m(*bad)  # the captured step: no raise here
        raised = []
        for _ in range(3):
            try:
                m.compute()
                raised.append(None)
            except ValueError as e:
                raised.append(str(e))
        check(raised == [msg + FWD_SUFFIX] * 3, f"15(d) {name}: {raised}")
        m.reset()
        m(*good)
        m.compute()
        d[name] = raised[0]
    out["d_deferred"] = d

    # (e) steps that cannot be captured. A host read is found in the warm-up,
    # before any capture; one made only while a capture runs gets past the
    # warm-up and breaks the capture, which must leave the state, the card and
    # its random generator (shared with a graph of the user's) as they were
    def host_read_metric(only_while_capturing):
        class HostRead(Metric):
            def __init__(self, **kw):
                super().__init__(**kw)
                self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

            def update(self, x, y):
                read = (x - y.unsqueeze(1)).sum()
                if not only_while_capturing or torch.cuda.is_current_stream_capturing():
                    read.item()
                self.total = self.total + read

            def compute(self):
                return self.total

        return HostRead(device=dev), eager_twin(HostRead(device=dev))

    drawn = torch.empty(4096, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        drawn.uniform_()
    torch.cuda.current_stream(dev).wait_stream(side)
    users = torch.cuda.CUDAGraph()
    with torch.cuda.graph(users):
        drawn.uniform_()
    e = {}
    for name, only_while_capturing in (("refused_in_warm_up", False), ("capture_failed", True)):
        hr, hr_twin = host_read_metric(only_while_capturing)
        eager_only0, captures0 = FORWARD_CACHE.eager_only, FORWARD_CACHE.misses
        refusals0 = FORWARD_CACHE.host_sync_refusals
        for p, t in batches[:4]:
            hr(p, t)
            hr_twin(p, t)
        refused = FORWARD_CACHE.host_sync_refusals - refusals0
        check(fwd_kinds(hr) == ["eager_only"] and FORWARD_CACHE.eager_only == eager_only0 + 1
              and FORWARD_CACHE.misses == captures0 and refused == int(not only_while_capturing),
              f"15(e) {name}: {fwd_kinds(hr)}, {refused} warm-up refusals")
        check(torch.equal(hr.total, hr_twin.total), f"15(e) {name}: the failed try moved the state")
        e[name] = fwd_kinds(hr)
    torch.cuda.manual_seed(7)
    users.replay()
    first = drawn.clone()
    eager_draw = torch.rand(4096, device=dev)
    torch.cuda.manual_seed(7)
    users.replay()
    check(torch.equal(drawn, first), "15(e): manual_seed no longer reaches the user's random graph")
    check(not torch.equal(eager_draw, first), "15(e): eager draws repeat the user's graph's")
    replays = fwd_entry(coll).replays
    got = coll(*batches[5])
    want = eager_twin(make_collection(dev))(*batches[5])
    same_value_trees(got, want, "15(e) the flagship's graph after the failed capture")
    check(fwd_entry(coll).replays == replays + 1, "15(e): the flagship's forward did not replay")
    same_value_trees(flat_values(kept), gpu_values, "15(e) a compute() result kept across a forward")
    ap2, ap2_twin = make_ap(), eager_twin(make_ap())
    for p, t in batches[:3]:
        same_value_trees(ap2(p, t), ap2_twin(p, t), "15(e) a capture after the failed one")
    check(fwd_kinds(ap2) == ["compiled"], f"15(e): a later capture: {fwd_kinds(ap2)}")
    out["e_failed_capture"] = {**e, "state_equal": True, "user_random_graph_follows_seed": True,
                               "kept_compute_unchanged": True, "later_capture": fwd_kinds(ap2)}

    stats = FORWARD_CACHE.stats()
    out["forward_cache"] = {k: stats[k] - cache0[k] if isinstance(stats[k], (int, float)) else stats[k]
                            for k in stats}
    return out


# --------------------------------------------- phase 16: snapshots and the restore matrix

SNAP_EVERY = 16  # 16(a)'s cadence, in batches
SNAP_KILL = 80  # 16(a): the engine dies after this batch
SNAP_STAGED = 8  # 16(b): spilled streams staged as int8 codes when the snapshot is taken
SNAP_DIR = Path(__file__).resolve().parent / "build" / "phase16"  # gitignored; removed after the phase


def snap_dir(name):
    path = SNAP_DIR / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return str(path)


def state_ptrs(eng):
    return {k: v.data_ptr() for k, v in eng._state.items()}


def snapshot_streaming(dev, preds, target, gpu_state, gpu_values):
    """16(a), (c) and the megastep half of (d): phase 7's engine and traffic
    with ``snapshot_every=16``, killed after batch 80, restored into a fresh
    engine sharing the AotCache and replayed; ``corrupt_snapshot`` on LATEST
    and the fallback restore; host ms and bytes of one snapshot and one
    restore; host ms per captured step with the cadence against without."""
    from metrics_tpu_torch.engine import AotCache, EngineConfig, StreamingEngine
    from metrics_tpu_torch.engine.faults import corrupt_snapshot
    from metrics_tpu_torch.engine.snapshot import latest_snapshot

    aot = AotCache()
    batches = ragged_batches(SEED + 2, 16, BUCKET)

    def engine(snapdir=None, every=0):
        return StreamingEngine(make_collection(dev), EngineConfig(
            buckets=(256, BUCKET), kernel_backend="megastep", snapshot_every=every, snapshot_dir=snapdir),
            aot_cache=aot)

    def submit(e, b):
        e.submit(preds[b[0]:b[1]], target[b[0]:b[1]])

    d = snap_dir("a")
    killed = engine(d, SNAP_EVERY)
    run_engine(killed, True, batches[:SNAP_KILL], submit)
    check(killed.stats.snapshots == SNAP_KILL // SNAP_EVERY and killed.stats.snapshot_failures == 0,
          f"16(a): {killed.stats.snapshots} periodic snapshots, {killed.stats.snapshot_failures} failed")
    misses = aot.misses
    del killed  # the kill: the engine and its buffers are gone
    resumed = engine(d)
    ptrs = state_ptrs(resumed)
    t0 = time.perf_counter()
    meta = resumed.restore()
    restore_ms = (time.perf_counter() - t0) * 1e3
    check(meta["batches_done"] == SNAP_KILL and meta["generations_skipped"] == 0, f"16(a): restored {meta}")
    check(state_ptrs(resumed) == ptrs, "16(a): restore rebound a state buffer")
    run_engine(resumed, True, batches[SNAP_KILL:], submit)
    check(aot.misses == misses and resumed.stats.warmup_steps == 0,
          f"16(a): the resumed engine captured ({aot.misses - misses} misses)")
    # the flagship's states are counts: bit-exact however the dispatcher coalesced
    compare_states(resumed.state(), gpu_state, "16(a) resumed vs uninterrupted (one-shot)")
    values = flat_values(resumed.result())
    for k in gpu_values:
        check(max_abs_err(values[k], gpu_values[k]) <= 1e-6, f"16(a): value {k}")
    # (c) the newest generation rots: restore falls back one generation, replay is exact
    corrupt_snapshot(latest_snapshot(d), np.random.RandomState(SEED + 16))
    fallback = engine(d)
    meta_c = fallback.restore()
    check(meta_c["generations_skipped"] == 1 and meta_c["batches_done"] == SNAP_KILL - SNAP_EVERY
          and fallback.stats.snapshot_fallbacks == 1, f"16(c): {meta_c}")
    run_engine(fallback, True, batches[meta_c["batches_done"]:], submit)
    check(fallback.stats.warmup_steps == 0, "16(c): the fallback engine captured")
    compare_states(fallback.state(), gpu_state, "16(c) fallback vs uninterrupted")
    # (d) one snapshot and one restore of the whole flagship arena, into the live captured engine
    t0 = time.perf_counter()
    path = resumed.snapshot()
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    live_ptrs, misses = state_ptrs(resumed), aot.misses
    t0 = time.perf_counter()
    resumed.restore(path)
    live_restore_ms = (time.perf_counter() - t0) * 1e3
    check(state_ptrs(resumed) == live_ptrs and aot.misses == misses, "16(a): a live restore rebound or captured")
    compare_states(resumed.state(), gpu_state, "16(a) live restore")
    # the cadence's cost: host ms per captured step, warm (no capture), in turns
    cadence = {"without": [], "with": []}
    for name in ("without", "with", "with", "without"):
        every = SNAP_EVERY if name == "with" else 0
        eng = engine(snap_dir(f"d_{name}_{len(cadence[name])}") if every else None, every)
        seconds = run_engine(eng, True, batches, submit)
        check(eng.stats.warmup_steps == 0 and eng.stats.snapshot_failures == 0, f"16(d): {name} captured or failed")
        compare_states(eng.state(), gpu_state, f"16(d) {name} cadence")
        cadence[name].append({"ms_per_step": seconds / eng.steps * 1e3, "steps": eng.steps,
                              "snapshots": eng.stats.snapshots})
    return {"batches": len(batches), "killed_at": SNAP_KILL, "every": SNAP_EVERY,
            "resumed_steps": resumed.steps - meta["step"], "restore_ms": restore_ms, "live_restore_ms": live_restore_ms,
            "snapshot_ms": snapshot_ms, "snapshot_bytes": os.path.getsize(path),
            "fallback_cursor": meta_c["batches_done"], "captures": aot.misses, "cadence": cadence}


def stacked_host(eng):
    """Every stream's logical state as host numpy, ``(S, ...)`` per leaf."""
    return {k: {s: v.detach().cpu().numpy() for s, v in member.items()} for k, member in eng.state().items()}


def snapshot_paged(dev, preds, target):
    """16(b) and the paged half of (d): phase 9's q8-staged tenancy (10 000
    streams, 128 slots, ``compress_payloads=True``, ``coalesce=1``)
    snapshotted halfway with rows spilled and SNAP_STAGED spilled streams
    staged as int8 codes, then served to the end (the uninterrupted run); the
    snapshot restored into the same residency, into 256 slots and merged
    into an unsharded engine, each replaying the second half. Every integer
    state equals the uninterrupted run's bit for bit; the q8-policy float
    states (binned AP's counts) within the codec's bound: each encode moves an
    element by at most its block's absmax / 254, a stream's absmax is at most
    its row count n_s, and after the snapshot the two runs encode a stream's
    row at most 2 b_s + 4 times between them (b_s: its batches in the second
    half; one eviction per fault-in, plus the snapshot's and the re-homing's
    encodes)."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine

    batches = ragged_batches(SEED + 4, 8, 64)
    sids = zipf_stream_ids(PAGED_STREAMS, len(batches), ALPHA, SEED + 4)
    traffic = list(zip(sids, batches))
    half = len(traffic) // 2

    def engine(resident, snapdir=None):
        cfg = EngineConfig(buckets=PAGED_BUCKETS, kernel_backend="megastep", compress_payloads=True, coalesce=1,
                           snapshot_dir=snapdir)
        coll = make_collection(dev, ap_precision="q8_block")
        if resident is None:
            return MultiStreamEngine(coll, PAGED_STREAMS, cfg)
        return MultiStreamEngine(coll, PAGED_STREAMS, cfg, stream_shard=True, resident_streams=resident)

    def submit(e, b):
        e.submit(int(b[0]), preds[b[1][0]:b[1][1]], target[b[1][0]:b[1][1]])

    src = engine(RESIDENT, snap_dir("b"))
    src.start()
    for b in traffic[:half]:
        submit(src, b)
    src.flush()
    stage = sorted(src.pager.spilled_streams(0))[:SNAP_STAGED]
    want_staged = {sid: src.stream_state(sid) for sid in stage}  # read through the host decode, nothing seated
    with src._device_section():
        src._page_round(stage)  # seat them as a round would: int8 codes staged for K7, q8 columns zero
    flags = int(src._q8_stage["flags"].sum())
    check(flags == SNAP_STAGED, f"16(b): {flags} staged slots, want {SNAP_STAGED}")
    t0 = time.perf_counter()
    path = src.snapshot()
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    check(int(src._q8_stage["flags"].sum()) == 0, "16(b): the snapshot left staged slots unseated")
    staged_rows = src.stats.q8_staged_rows
    spilled_at_snapshot = src.pager.spilled_count()
    for b in traffic[half:]:
        submit(src, b)
    src.stop()
    want = stacked_host(src)
    want_values = src.results()
    rows = {sid: len(r) for sid, r in stream_rows(sids, batches).items()}
    tail = {}
    for sid in sids[half:]:
        tail[int(sid)] = tail.get(int(sid), 0) + 1
    bound = np.zeros(PAGED_STREAMS)
    for sid, n in rows.items():
        bound[sid] = (2 * tail.get(sid, 0) + 4) * n / 254.0
    out = {"streams": PAGED_STREAMS, "snapshot_at": half, "snapshot_ms": snapshot_ms,
           "snapshot_bytes": os.path.getsize(path), "spilled_at_snapshot": spilled_at_snapshot,
           "staged_at_snapshot": flags, "q8_staged_rows": staged_rows, "targets": {}}
    for name, resident in (("same_residency", RESIDENT), ("resident_256", 256), ("merged_unsharded", None)):
        eng = engine(resident)
        t0 = time.perf_counter()
        meta = eng.restore(path)
        restore_ms = (time.perf_counter() - t0) * 1e3
        check(meta["batches_done"] == half, f"16(b) {name}: cursor {meta['batches_done']}")
        for sid in stage:  # the staged rows survived the snapshot, bit for bit
            got = eng.stream_state(sid)
            for k, member in want_staged[sid].items():
                for s, w in member.items():
                    check(torch.equal(got[k][s], w), f"16(b) {name}: staged stream {sid} {k}.{s} lost")
        seconds = run_engine(eng, True, traffic[half:], submit)
        steps = eng.steps - meta["step"]  # the restored cursor counts the first half's steps
        got = stacked_host(eng)
        worst = 0.0
        for k, member in want.items():
            for s, w in member.items():
                g = got[k][s]
                check(g.dtype == w.dtype and g.shape == w.shape, f"16(b) {name}: {k}.{s} dtype/shape")
                if w.dtype.kind != "f":
                    check(np.array_equal(g, w), f"16(b) {name}: integer state {k}.{s} differs")
                    continue
                err = np.abs(g.astype(np.float64) - w).reshape(PAGED_STREAMS, -1).max(axis=1)
                worst = max(worst, float(err.max()))
                over = np.nonzero(err > bound + 1e-3)[0]
                check(over.size == 0, f"16(b) {name}: {k}.{s} of {over.size} streams past the q8 bound")
        values = eng.results()
        for sid in range(0, PAGED_STREAMS, 7):  # the count-derived values, exactly
            for k in ("acc", "f1", "confmat"):
                check(torch.equal(values[sid][k], want_values[sid][k]), f"16(b) {name}: stream {sid} {k}")
        out["targets"][name] = {"restore_ms": restore_ms, "replay_s": seconds, "steps": steps,
                                "ms_per_step": seconds / steps * 1e3, "q8_max_abs_err": worst,
                                "page_ins": eng.stats.page_ins}
    return out


def snapshot_phase(dev, preds, target, gpu_state, gpu_values):
    """Phase 16: kill/resume through the captured engines (module docstring)."""
    try:
        return {"streaming": snapshot_streaming(dev, preds, target, gpu_state, gpu_values),
                "paged": snapshot_paged(dev, preds, target)}
    finally:
        shutil.rmtree(SNAP_DIR, ignore_errors=True)


# ------------------------------------------------------- phase 17: the chaos sweep

CHAOS_DIR = Path(__file__).resolve().parent / "build" / "phase17"  # gitignored; removed after the phase
CHAOS_EVERY = 16  # 17(a)'s snapshot cadence, in batches
CHAOS_KERNEL_AT = 8  # 17(a): the kernel site's occurrence that fires (JAX's plan: 0, before any K5 could launch)
HANG_TIMEOUT_S = 0.1  # 17(c): the watchdog
HANG_S = 0.15  # 17(c): the hang enqueued ahead of the step, 1.5 x the watchdog


def chaos_dir(name):
    path = CHAOS_DIR / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return str(path)


def watch_steps(eng):
    """Record, at each step attempt of ``eng``, the kernel launch counts,
    the demotions so far and the q8 rows staged so far (host counters:
    nothing syncs)."""
    seen = []
    do_step = eng._do_step

    def watched(*a, **kw):
        seen.append(dict(counts(), demotions=eng.stats.kernel_demotions, staged=eng.stats.q8_staged_rows))
        return do_step(*a, **kw)

    eng._do_step = watched
    return seen


def recovery(st):
    return {k: getattr(st, k) for k in ("retries", "rollbacks", "kernel_demotions", "coalesce_degraded",
                                        "coalesce_shrinks", "watchdog_timeouts", "quarantined_batches",
                                        "quarantined_rows", "snapshots", "snapshot_failures", "snapshot_fallbacks")}


def demotion_split(seen, final):
    """Launches of each kernel before the demotion (the counts at the first
    attempt after it) and after it."""
    at = next(i for i, r in enumerate(seen) if r["demotions"])
    before = {k: seen[at][k] for k in final}
    return at, before, {k: final[k] - before[k] for k in final}


def chaos_megastep(dev, preds, target, gpu_state):
    """17(a): phase 7's engine and traffic, plus a 2-row NaN batch at cursor
    2, under JAX's chaos plan (``chaos_smoke.py:127-225``), then killed and
    restored past the corrupt LATEST with a transient ``snapshot_read``."""
    from metrics_tpu_torch.engine import EngineConfig, FaultInjector, FaultSpec, ScreenPolicy, StreamingEngine

    batches = ragged_batches(SEED + 2, 16, BUCKET)
    traffic = [(preds[a:b], target[a:b]) for a, b in batches]
    poison = torch.full((2, NUM_CLASSES), 0.1, device=dev)
    poison[0, 3] = float("nan")
    traffic.insert(2, (poison, torch.tensor([1, 0], device=dev)))
    good_saves = len(traffic) // CHAOS_EVERY - 1  # the first periodic save fails
    inj = FaultInjector(seed=7, plan={
        "coalesce": FaultSpec(rate=1.0), "ingest": FaultSpec(schedule=(1,)), "compile": FaultSpec(schedule=(1,)),
        "step": FaultSpec(schedule=(3,)), "kernel": FaultSpec(schedule=(CHAOS_KERNEL_AT,)),
        "watchdog": FaultSpec(schedule=(6,)), "snapshot_write": FaultSpec(schedule=(0,)),
        "snapshot_corrupt": FaultSpec(schedule=(good_saves - 1,)),  # the last good save rots
    })
    d = chaos_dir("a")
    screen = ScreenPolicy(non_finite="quarantine")
    eng = StreamingEngine(make_collection(dev), EngineConfig(
        buckets=(256, BUCKET), kernel_backend="megastep", coalesce=8, screen=screen, snapshot_every=CHAOS_EVERY,
        snapshot_dir=d, snapshot_keep=4, fault_injector=inj))
    ptrs = state_ptrs(eng)
    seen = watch_steps(eng)
    before = counts()
    seconds = run_engine(eng, True, traffic, lambda e, b: e.submit(*b))
    launches = delta(before)
    st = eng.stats
    check(state_ptrs(eng) == ptrs, "17(a): a state buffer moved")
    compare_states(eng.state(), gpu_state, "17(a) chaos vs phase 4 (the poisoned rows excluded)")
    at, pre, post = demotion_split([{**r, **{k: r[k] - before[k] for k in before}} for r in seen], launches)
    check(st.kernel_demotions == 1 and eng._kernel_tag() == "auto", f"17(a): {st.kernel_demotions} demotions")
    check(pre["megastep_fold"] > 0 and post["megastep_fold"] == 0 and pre["fold_rows"] == 0
          and post["fold_rows"] > 0, f"17(a): K5 {pre['megastep_fold']}/{post['megastep_fold']} and K1 "
          f"{pre['fold_rows']}/{post['fold_rows']} launches before/after the demotion")
    check(st.rollbacks >= 3 and st.retries >= 3 and st.watchdog_timeouts == 1 and st.coalesce_degraded >= 3
          and st.snapshot_failures == 1, f"17(a): recovery counters {recovery(st)}")
    ledger = [(r.cursor, r.rows, r.stream_id) for r in eng.quarantine()]
    check(ledger == [(2, 2, None)] and "non-finite" in eng.quarantine()[0].reason, f"17(a): ledger {ledger}")
    check(st.quarantined_batches == 1 and st.quarantined_rows == 2, "17(a): quarantine counts")
    out = {"batches": len(traffic), "steps": eng.steps, "seconds": seconds, "demoted_at_attempt": at,
           "recovery": recovery(st), "faults": st.faults_by_site(), "injector": inj.summary(),
           "launches_before_demotion": pre, "launches_after_demotion": post, "captures": eng.aot_cache.misses}
    del eng  # the kill
    read = FaultInjector(seed=11, plan={"snapshot_read": FaultSpec(schedule=(0,))})
    resumed = StreamingEngine(make_collection(dev), EngineConfig(
        buckets=(256, BUCKET), kernel_backend="megastep", coalesce=1, screen=screen, snapshot_dir=d,
        fault_injector=read))
    meta = resumed.restore()
    cursor = meta["batches_done"]
    want_cursor = (len(traffic) // CHAOS_EVERY - 1) * CHAOS_EVERY  # the generation before the rotten LATEST
    check(meta["generations_skipped"] == 1 and cursor == want_cursor and resumed.stats.retries == 1
          and resumed.stats.snapshot_fallbacks == 1, f"17(a) restore: {meta}, {recovery(resumed.stats)}")
    run_engine(resumed, True, traffic[cursor:], lambda e, b: e.submit(*b))
    compare_states(resumed.state(), gpu_state, "17(a) resumed past the corrupt LATEST vs phase 4")
    out["resumed"] = {"cursor": cursor, "replayed_batches": len(traffic) - cursor,
                      "recovery": recovery(resumed.stats)}
    return out


def chaos_paged(dev, preds, target):
    """17(b): phase 9's q8 tenancy (``coalesce=1``) under the paging and
    codec sites and a ``kernel`` fault at a mid-stream step that decodes
    staged rows: every stream bit-equal to its fault-free twin."""
    from metrics_tpu_torch.engine import EngineConfig, FaultInjector, FaultSpec, MultiStreamEngine

    batches = ragged_batches(SEED + 4, 8, 64)
    sids = zipf_stream_ids(PAGED_STREAMS, len(batches), ALPHA, SEED + 4)
    traffic = list(zip(sids, batches))

    def engine(inj=None):
        return MultiStreamEngine(make_collection(dev, ap_precision="q8_block"), PAGED_STREAMS, EngineConfig(
            buckets=PAGED_BUCKETS, kernel_backend="megastep", compress_payloads=True, coalesce=1,
            fault_injector=inj), stream_shard=True, resident_streams=RESIDENT)

    def submit(e, b):
        e.submit(int(b[0]), preds[b[1][0]:b[1][1]], target[b[1][0]:b[1][1]])

    twin = engine()
    twin_seen = watch_steps(twin)
    twin_s = run_engine(twin, True, traffic, submit)
    # the first step past the middle whose page round staged rows (attempt i sees round i's)
    at = next(i for i in range(len(twin_seen) // 2, len(twin_seen))
              if twin_seen[i]["staged"] > twin_seen[i - 1]["staged"])
    inj = FaultInjector(seed=19, plan={
        "page_out": FaultSpec(schedule=(0,)), "page_in": FaultSpec(schedule=(1,)),
        "quant_encode": FaultSpec(schedule=(0,)), "quant_decode": FaultSpec(schedule=(0,)),
        "kernel": FaultSpec(schedule=(at,))})
    eng = engine(inj)
    ptrs = state_ptrs(eng)
    seen = watch_steps(eng)
    before = counts()
    seconds = run_engine(eng, True, traffic, submit)
    launches = delta(before)
    st = eng.stats
    check(state_ptrs(eng) == ptrs, "17(b): a state buffer moved")
    check(inj.fired == {"page_out": 1, "page_in": 1, "quant_encode": 1, "quant_decode": 1, "kernel": 1},
          f"17(b): fired {inj.fired}")
    check(st.kernel_demotions == 1 and st.retries == 4 and st.rollbacks == 1, f"17(b): {recovery(st)}")
    demoted, pre, post = demotion_split([{**r, **{k: r[k] - before[k] for k in before}} for r in seen], launches)
    # the failed attempt (the step's first) and its demoted retry saw the staged rows
    check(demoted == at + 1 and seen[at]["staged"] > seen[at - 1]["staged"],
          f"17(b): demoted at attempt {demoted} for the kernel fault at {at}, or no rows were staged there")
    check(pre["megastep_segment"] > 0 and pre["megastep_segment_q8"] > 0 and pre["segment_reduce"] == 0
          and post["megastep_segment"] == 0 and post["megastep_segment_q8"] == 0 and post["segment_reduce"] > 0,
          f"17(b): K6/K7/K4 launches before {pre} and after {post} the demotion")
    want, got = stacked_host(twin), stacked_host(eng)  # every stream, reassembled once per engine
    for k, member in want.items():
        for name, w in member.items():
            check(got[k][name].dtype == w.dtype and np.array_equal(got[k][name], w),
                  f"17(b) chaos vs fault-free twin: {k}.{name}")
    return {"batches": len(traffic), "steps": eng.steps, "seconds": seconds, "twin_seconds": twin_s,
            "kernel_at": at, "recovery": recovery(st), "injector": inj.summary(),
            "q8_staged_rows": st.q8_staged_rows, "twin_q8_staged_rows": twin.stats.q8_staged_rows,
            "page_ins": st.page_ins, "page_outs": st.page_outs,
            "launches_before_demotion": pre, "launches_after_demotion": post}


def chaos_hang(dev, preds, target, aot):
    """17(c): a real hang. A warm engine with the watchdog at HANG_TIMEOUT_S
    serves a prefix of phase 7's traffic and drains; a device sleep of
    HANG_S is enqueued on its own stream; one more batch: one expiry, one
    rollback, one retry, the state bit-equal to the fault-free twin's."""
    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine

    batches = ragged_batches(SEED + 2, 16, BUCKET)[:24]
    # cycles of the device sleep per ms, on this card now
    cycles = 10_000_000
    per_ms = cycles / gpu_ms(lambda: torch.cuda._sleep(cycles), runs=3)

    def engine(timeout):
        return StreamingEngine(make_collection(dev), EngineConfig(
            buckets=(256, BUCKET), kernel_backend="megastep", step_timeout_s=timeout), aot_cache=aot)

    def submit(e, b):
        e.submit(preds[b[0]:b[1]], target[b[0]:b[1]])

    twin = engine(0.0)
    run_engine(twin, True, batches, submit)
    eng = engine(HANG_TIMEOUT_S)
    eng.start()
    for b in batches[:-1]:
        submit(eng, b)
    eng.flush()
    check(eng.stats.watchdog_timeouts == 0, "17(c): the watchdog expired before the hang")
    ptrs = state_ptrs(eng)
    with torch.cuda.stream(eng._stream):
        torch.cuda._sleep(int(HANG_S * 1e3 * per_ms))
    t0 = time.perf_counter()
    submit(eng, batches[-1])
    eng.flush()
    wall = time.perf_counter() - t0
    eng.stop()
    st = eng.stats
    check(st.watchdog_timeouts == 1 and st.rollbacks == 1 and st.retries == 1,
          f"17(c): {st.watchdog_timeouts} expiries, {st.rollbacks} rollbacks, {st.retries} retries")
    check(state_ptrs(eng) == ptrs, "17(c): a state buffer moved")
    check(eng.stats.warmup_steps == 0, "17(c): the warm engine captured")
    compare_states(eng.state(), twin.state(), "17(c) hang vs fault-free twin")
    return {"timeout_s": HANG_TIMEOUT_S, "hang_s": HANG_S, "sleep_cycles_per_ms": per_ms,
            "last_batch_wall_s": wall, "recovery": recovery(st)}


def chaos_dead(dev, preds, target, gpu_state, aot):
    """17(d): a fatal ``dispatcher_kill`` on the first group; ``submit(timeout=0.5)``
    raises the sticky error; ``reset()``, then phase 7's traffic gives phase 4's states."""
    from metrics_tpu_torch.engine import (
        BackpressureTimeout,
        EngineConfig,
        EngineDispatchError,
        FaultInjector,
        FaultSpec,
        StreamingEngine,
    )

    batches = ragged_batches(SEED + 2, 16, BUCKET)
    inj = FaultInjector(seed=17, plan={"dispatcher_kill": FaultSpec(schedule=(0,), transient=False, fatal=True)})
    eng = StreamingEngine(make_collection(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep",
                                                             max_queue=2, fault_injector=inj), aot_cache=aot)
    eng.start()
    eng.submit(preds[:100], target[:100])
    t0 = time.perf_counter()
    sticky = None
    while sticky is None and time.perf_counter() - t0 < 10.0:
        try:
            eng.submit(preds[:100], target[:100], timeout=0.5)
        except EngineDispatchError as e:
            sticky = e
        except BackpressureTimeout:
            continue
    raised_s = time.perf_counter() - t0
    check(sticky is not None and "dispatcher_kill" in str(sticky) and raised_s < 5.0,
          f"17(d): submit(timeout=0.5) gave {sticky!r} after {raised_s:.2f} s")
    eng.reset()
    run_engine(eng, True, batches, lambda e, b: e.submit(preds[b[0]:b[1]], target[b[0]:b[1]]))
    compare_states(eng.state(), gpu_state, "17(d) after reset vs phase 4")
    return {"raised_after_s": raised_s, "error": type(sticky.__cause__).__name__, "steps_after_reset": eng.steps}


def chaos_cost(dev, preds, target, gpu_state, aot):
    """17(e): host ms a captured (warm) step for phase 7's traffic without
    the fault layer, transactional (an empty-plan injector), drained (a plan
    naming the watchdog site at an occurrence never reached: every step is
    synchronized, no deadline) and with the watchdog armed
    (``step_timeout_s=1.0``: every step's event polled), in turns; and the
    device µs of one shadow copy of the flagship arena and of the paged
    tenancy's."""
    from metrics_tpu_torch.engine import EngineConfig, FaultInjector, FaultSpec, MultiStreamEngine, StreamingEngine

    batches = ragged_batches(SEED + 2, 16, BUCKET)
    configs = {"plain": {}, "transactional": {"fault_injector": FaultInjector(0, {})},
               "drained": {"fault_injector": FaultInjector(0, {"watchdog": FaultSpec(schedule=(1 << 30,))})},
               "watchdog": {"step_timeout_s": 1.0}}
    runs = {k: [] for k in configs}
    warm = StreamingEngine(make_collection(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep"),
                           aot_cache=aot)
    run_engine(warm, True, batches, lambda e, b: e.submit(preds[b[0]:b[1]], target[b[0]:b[1]]))  # the captures
    for name in ("plain", "transactional", "drained", "watchdog", "watchdog", "drained", "transactional", "plain"):
        eng = StreamingEngine(make_collection(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep",
                                                                 **configs[name]), aot_cache=aot)
        seconds = run_engine(eng, True, batches, lambda e, b: e.submit(preds[b[0]:b[1]], target[b[0]:b[1]]))
        check(eng.stats.warmup_steps == 0, f"17(e) {name}: the warm engine captured")
        check(eng._transactional == (name != "plain"), f"17(e) {name}: transactional={eng._transactional}")
        compare_states(eng.state(), gpu_state, f"17(e) {name}")
        runs[name].append({"ms_per_step": seconds / eng.steps * 1e3, "steps": eng.steps})
    flagship = eng._state
    paged = MultiStreamEngine(make_collection(dev), PAGED_STREAMS, EngineConfig(
        buckets=PAGED_BUCKETS, kernel_backend="megastep"), stream_shard=True, resident_streams=RESIDENT)._state
    shadow = {}
    for name, state in (("flagship", flagship), ("paged_128", paged)):
        copy = {k: torch.empty_like(v) for k, v in state.items()}
        nbytes = sum(v.numel() * v.element_size() for v in state.values())
        ms = gpu_ms(lambda: [copy[k].copy_(v) for k, v in state.items()])
        bound, by = bound_ms(2 * nbytes, 0)  # each byte read once and written once
        shadow[name] = {"bytes": nbytes, "us": ms * 1e3, "bound_us": bound * 1e3, "bound_by": by}
    return {"runs": runs, "shadow_copy": shadow}


def chaos_phase(dev, preds, target, gpu_state):
    """Phase 17: the chaos sweep through the captured engines (module docstring)."""
    from metrics_tpu_torch.engine import AotCache

    aot = AotCache()
    try:
        return {"megastep": chaos_megastep(dev, preds, target, gpu_state),
                "paged": chaos_paged(dev, preds, target),
                "cost": chaos_cost(dev, preds, target, gpu_state, aot),
                "hang": chaos_hang(dev, preds, target, aot),
                "dead": chaos_dead(dev, preds, target, gpu_state, aot)}
    finally:
        shutil.rmtree(CHAOS_DIR, ignore_errors=True)


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1
    from metrics_tpu_torch.ops.kernels import build

    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.library(name)
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {build.last_build_seconds:.2f} s) on {card}")

    rng = np.random.RandomState(SEED)
    t0 = time.perf_counter()
    fold_entries = fold_phase(dev, rng)
    hist_entries = hist_phase(dev, rng)
    binned_entries = binned_phase(dev, rng)
    print(f"kernel phases K1-K3: pass ({time.perf_counter() - t0:.2f} s on {card})")
    t0 = time.perf_counter()
    segment_entries = segment_phase(dev, rng)
    mega_fold_entries = megastep_fold_phase(dev, rng)
    mega_seg_entries, mega_q8_entries = megastep_segment_phase(dev, rng)
    print(f"kernel phases K4-K7: pass ({time.perf_counter() - t0:.2f} s on {card})")

    preds, target, preds_np, target_np = main_rows(dev)
    hist_cal_entry = hist_calibration_timing(dev, preds, target)
    hist_auroc_entry = hist_auroc_support_timing(dev, target)
    kernels = kernel_wrappers()
    for fn in kernels.values():
        fn.launches = 0
    gpu_state, gpu_values, one_shot_s = main_path(dev, preds, target)
    one_shot = counts()
    masked_state, masked_values, buckets, masked_s = masked_path(dev, preds_np, target_np, np.random.RandomState(SEED + 1))
    masked = delta(one_shot)
    for k in ("fold_rows", "histogram", "binned_counts"):
        check(masked[k] > 0, f"kernel {k} was not launched by the masked bucket step")
    check(one_shot["histogram"] > 0 and one_shot["binned_counts"] > 0, "one-shot update skipped a kernel")
    check(one_shot["histogram"] == N_ROWS // BATCH and masked["histogram"] == buckets,
          "K2: not one launch per batch and per masked bucket")

    phases = engine_phases(dev, preds, target, preds_np, target_np, gpu_state)
    launches = counts()
    profile = profile_bucket(dev, preds, target)
    phases_line = {"engine_phases": phases, "profile": profile, "card": card}
    print(json.dumps({"launches": {"one_shot_update": one_shot, "masked_buckets": masked}}))
    for k in kernels:
        check(launches[k] > 0, f"kernel {k} was not launched on the main path")

    # phase 10, its counts from 0: K1 (masked buckets), K2 (all three forms), K5 and K6 must launch
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    dashboard = dashboard_phase(dev, preds, target, preds_np, target_np)
    dashboard_launches = counts()
    for k in ("fold_rows", "histogram", "megastep_fold", "megastep_segment"):
        check(dashboard_launches[k] > 0, f"kernel {k} was not launched by the dashboard phase")
    launches = {k: launches[k] + dashboard_launches[k] for k in launches}
    print(json.dumps({"dashboard_phase": dashboard, "launches": dashboard_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 11, its counts from 0: K1 (the delta members, leaf by leaf), K2 and K3 must launch; no K5 (checked inside)
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    curves = curves_phase(dev, preds, target, preds_np, target_np)
    curve_launches = counts()
    for k in ("fold_rows", "histogram", "binned_counts"):
        check(curve_launches[k] > 0, f"kernel {k} was not launched by the curves phase")
    launches = {k: launches[k] + curve_launches[k] for k in launches}
    print(json.dumps({"curves_phase": curves, "launches": curve_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 12, its counts from 0: K2, K3, K5 (megastep engine) and K6 (paged engine) must launch
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    wrappers = wrapper_phase(dev, preds, target, preds_np, target_np)
    wrapper_launches = counts()
    for k in ("histogram", "binned_counts", "megastep_fold", "megastep_segment"):
        check(wrapper_launches[k] > 0, f"kernel {k} was not launched by the wrapper phase")
    launches = {k: launches[k] + wrapper_launches[k] for k in launches}
    print(json.dumps({"wrapper_phase": wrappers, "launches": wrapper_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 13, its counts from 0: K1 (masked buckets), K4 (unsharded), K5 (megastep) and K6 (paged) must launch
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    regression = regression_phase(dev)
    regression_launches = counts()
    for k in ("fold_rows", "segment_reduce", "megastep_fold", "megastep_segment"):
        check(regression_launches[k] > 0, f"kernel {k} was not launched by the regression phase")
    launches = {k: launches[k] + regression_launches[k] for k in launches}
    print(json.dumps({"regression_phase": regression, "launches": regression_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 14, its counts from 0: K2 and K3 (the flagship's rank-local update) must launch
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    sync = sync_phase(dev, gpu_state, gpu_values)
    sync_launches = counts()
    for k in ("histogram", "binned_counts"):
        check(sync_launches[k] > 0, f"kernel {k} was not launched by the sync phase")
    launches = {k: launches[k] + sync_launches[k] for k in launches}
    print(json.dumps({"sync_phase": sync, "launches": sync_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 15, its counts from 0: K2 and K3 (inside the flagship's captured forward) must launch
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    forward = forward_phase(dev, preds, target, gpu_state, gpu_values)
    forward_launches = counts()
    for k in ("histogram", "binned_counts"):
        check(forward_launches[k] > 0, f"kernel {k} was not launched by the forward phase")
    launches = {k: launches[k] + forward_launches[k] for k in launches}
    print(json.dumps({"forward_phase": forward, "launches": forward_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 16, its counts from 0: K2, K3, K5 (megastep engine), K6, K7 (paged q8) and K4 (merged) must launch
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    snapshots = snapshot_phase(dev, preds, target, gpu_state, gpu_values)
    snapshot_launches = counts()
    for k in ("histogram", "binned_counts", "segment_reduce", "megastep_fold", "megastep_segment",
              "megastep_segment_q8"):
        check(snapshot_launches[k] > 0, f"kernel {k} was not launched by the snapshot phase")
    launches = {k: launches[k] + snapshot_launches[k] for k in launches}
    print(json.dumps({"snapshot_phase": snapshots, "launches": snapshot_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 17, its counts from 0: K5 then K1 (the demoted megastep engine), K6, K7 then K4 (the
    # demoted paged engine), K2 and K3 must launch
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    chaos = chaos_phase(dev, preds, target, gpu_state)
    chaos_launches = counts()
    for k in kernels:
        check(chaos_launches[k] > 0, f"kernel {k} was not launched by the chaos phase")
    launches = {k: launches[k] + chaos_launches[k] for k in launches}
    print(json.dumps({"chaos_phase": chaos, "launches": chaos_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 4 against the CPU port (plain versions) and numpy
    cpu = torch.device("cpu")
    cpu_state, cpu_values, _ = main_path(cpu, torch.from_numpy(preds_np), torch.from_numpy(target_np))
    compare_states(gpu_state, cpu_state, "card vs CPU")
    compare_states(gpu_state, oracle_states(preds_np, target_np), "card vs numpy")
    for k in cpu_values:
        e = max_abs_err(gpu_values[k], cpu_values[k])
        check(e <= 1e-6, f"card vs CPU: value {k} err {e}")
    # phase 5 against phase 4
    compare_states(masked_state, gpu_state, "masked buckets vs one-shot")
    for k in gpu_values:
        check(max_abs_err(masked_values[k], gpu_values[k]) <= 1e-6, f"masked vs one-shot: value {k}")
    print(json.dumps({
        "main_path": {"rows": N_ROWS, "batch": BATCH, "classes": NUM_CLASSES, "thresholds": THRESHOLDS,
                      "one_shot_update_compute_s": one_shot_s, "masked_buckets": buckets,
                      "masked_update_compute_s": masked_s,
                      "accuracy": float(gpu_values["acc"]), "f1": float(gpu_values["f1"]),
                      "mean_ap": float(gpu_values["binned_ap"].mean())},
        "card": card,
    }))
    print(json.dumps(phases_line))

    entries = []
    hist_cal_entry["calibration_launches"] = dashboard["eager"]["calibration_k2_launches"]
    hist_auroc_entry["auroc_support_launches"] = curves["eager"]["auroc_support_k2_launches"]
    for e in (*fold_entries, *hist_entries, hist_cal_entry, hist_auroc_entry, *binned_entries, *segment_entries, *mega_fold_entries,
              *mega_seg_entries, *mega_q8_entries):
        e["launches"] = launches[e["name"]]
        e["card"] = card
        entries.append(e)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
