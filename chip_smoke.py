#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``metrics_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs a CUDA device and ``nvcc`` (``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``)
and exits non-zero, printing no result, without them. Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the three CUDA kernels from ``metrics_tpu_torch/ops/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card: at the shapes
   the main path gives it, on edge cases, and through its ``torch.func.vmap``
   rule at a 1024-row bucket; then time kernel, plain version and (where one
   PyTorch call computes the same function) that call;
4. the main path: the flagship collection (Accuracy, macro F1, binned AP over
   100 thresholds, confusion matrix; 10 classes) updated over 65 536 rows in
   batches, then computed; held against the same collection on the CPU and
   against numpy oracles for every count;
5. the masked bucket step: the same rows as ragged 1024-row buckets padded
   with garbage through ``update_state_masked``; its state must equal phase 4's.

Every kernel's launch count is set to 0 before phase 4 and read after phase 5;
each must be non-zero. The line before the last is the ``kernels`` JSON
object; the last line is ``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import sys
import time
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


# --------------------------------------------------------------------------- kernels

def fold_phase(dev, rng):
    from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda, fold_rows_plain

    i32 = torch.iinfo(torch.int32)
    err = 0.0
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
        rows, state, m = rows.to(dev), state.to(dev), m.to(dev)
        got = fold_rows_cuda(state, rows, m, fx)
        want = fold_rows_plain(state, rows, m, fx)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype, f"fold {dt}/{fx}: dtype {got.dtype} != {want.dtype}")
        e = max_abs_err(got, want)
        scale = float(want.double().abs().nan_to_num(posinf=0, neginf=0).max()) if want.numel() else 0.0
        if dt == "int32" or fx != "sum":
            check(e == 0.0, f"fold {dt}/{fx}/{n}x{f}/{pattern}: not exact (err {e})")
        elif dt == "float32":
            check(e <= 1e-5 + 1e-6 * scale, f"fold f32 sum {n}x{f}/{pattern}: err {e}")
        else:  # bf16: both round one f32 sum once, so at most one bf16 step apart
            check(e <= 2.0 ** -7 * max(scale, 1.0), f"fold bf16 sum {n}x{f}/{pattern}: err {e}")
        if dt != "bfloat16":
            err = max(err, e)

    # timed at the masked step's widest leaf: binned AP's (10, 100) f32 counts over 1024 rows
    n, f = BUCKET, NUM_CLASSES * THRESHOLDS
    rows = torch.from_numpy(rng.randint(0, 2, (n, f)).astype(np.float32)).to(dev)
    state = torch.zeros(f, device=dev)
    m = torch.from_numpy((rng.rand(n) > 0.1).astype(np.int32)).to(dev)
    mf = m.to(torch.float32)
    check(max_abs_err(fold_rows_cuda(state, rows, m, "sum"), torch.addmv(state, rows.t(), mf)) == 0.0,
          "fold: kernel disagrees with addmv on 0/1 rows")
    entry = {
        "name": "fold_rows", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/fold.cu",
        "replaces": "metrics_tpu/ops/kernels/pallas_fold.py:48", "shape": f"rows ({n}, {f}) f32, sum",
        "max_abs_err": err,
        "ms": gpu_ms(lambda: fold_rows_cuda(state, rows, m, "sum")),
        "plain_ms": gpu_ms(lambda: fold_rows_plain(state, rows, m, "sum")),
        "library_ms": gpu_ms(lambda: torch.addmv(state, rows.t(), mf)),
    }
    entry["bound_ms"], entry["bound_by"] = bound_ms(4 * n * f + 4 * n + 2 * 4 * f, n * f)
    return entry


def hist_phase(dev, rng):
    from metrics_tpu_torch.ops.kernels import histogram_accumulate
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda, histogram_plain

    err = 0.0
    # counts: the one-shot confmat shape, short/long histograms (shared and global
    # paths), out-of-range indices on both sides, empty input
    for n, length in ((BATCH, 100), (1037, 1), (1037, 7), (4099, 12289), (BUCKET, 102400), (0, 5), (1, 3)):
        idx = torch.from_numpy(rng.randint(-3, length + 3, n).astype(np.int32)).to(dev)
        got = histogram_cuda(idx, length)
        want = histogram_plain(idx, length)
        oracle = np.bincount(np.clip(idx.cpu().numpy(), 0, None), minlength=length + 3)[:length]
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and torch.equal(got.cpu(), want.cpu()), f"hist counts {n}/{length}")
        check(np.array_equal(got.cpu().numpy(), oracle), f"hist counts {n}/{length} vs np.bincount")
    # weighted sums, f32 and bf16, shared and global paths
    for n, length, k, wdt in ((2000, 19, 1, torch.float32), (2000, 19, 3, torch.float32),
                              (3001, 5000, 3, torch.float32), (2000, 64, 2, torch.bfloat16)):
        idx = torch.from_numpy(rng.randint(-2, length + 2, n).astype(np.int32)).to(dev)
        w = torch.from_numpy(rng.rand(n, k).astype(np.float32)).to(dev, wdt)
        got = histogram_cuda(idx, length, w)
        want = histogram_plain(idx, length, w)
        e = max_abs_err(got, want)
        # f32 atomics add in no fixed order: reassociation error of sums of <= n terms in [0, 1)
        check(e <= 1e-4, f"hist weights {n}/{length}/{k}/{wdt}: err {e}")
        err = max(err, e)
    # the vmap rule at one 1024-row bucket: one launch over B * L bins
    rows_idx = torch.from_numpy(rng.randint(-2, 102, (BUCKET, 1)).astype(np.int32))
    before = histogram_cuda.launches
    got = torch.func.vmap(lambda i: histogram_accumulate(i, 100))(rows_idx.to(dev))
    check(histogram_cuda.launches == before + 1, "hist vmap rule: expected exactly one launch")
    want = torch.func.vmap(lambda i: histogram_accumulate(i, 100))(rows_idx)
    oracle = np.zeros((BUCKET, 100), np.int32)
    for b, v in enumerate(rows_idx[:, 0].numpy()):
        if max(v, 0) < 100:
            oracle[b, max(v, 0)] += 1
    check(torch.equal(got.cpu(), want) and np.array_equal(want.numpy(), oracle), "hist vmap rule")

    n, length = BATCH, NUM_CLASSES * NUM_CLASSES
    idx = torch.from_numpy(rng.randint(0, length, n).astype(np.int32)).to(dev)
    entry = {
        "name": "histogram", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/hist.cu",
        "replaces": "metrics_tpu/ops/kernels/pallas_hist.py:55", "shape": f"idx ({n},) int32, L={length} counts",
        "max_abs_err": err,
        "ms": gpu_ms(lambda: histogram_cuda(idx, length)),
        "plain_ms": gpu_ms(lambda: histogram_plain(idx, length)),
        "library_ms": gpu_ms(lambda: torch.bincount(idx, minlength=length)),
    }
    entry["bound_ms"], entry["bound_by"] = bound_ms(4 * n + 4 * length, n)
    # the masked step's shape: the vmapped confmat over one bucket, B * L bins
    vidx = torch.from_numpy(rng.randint(0, BUCKET * length, BUCKET).astype(np.int32)).to(dev)
    extra = {"name": "histogram", "shape": f"idx ({BUCKET},) int32, L={BUCKET * length} (vmapped bucket)",
             "ms": gpu_ms(lambda: histogram_cuda(vidx, BUCKET * length)),
             "plain_ms": gpu_ms(lambda: histogram_plain(vidx, BUCKET * length))}
    extra["bound_ms"], extra["bound_by"] = bound_ms(4 * BUCKET + 4 * BUCKET * length, BUCKET)
    return entry, extra


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

    n, c, t = BATCH, NUM_CLASSES, THRESHOLDS
    p, y = data(n, c, False)
    th = thr(t)
    entry = {
        "name": "binned_counts", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/binned.cu",
        "replaces": "metrics_tpu/ops/binned_update.py:69", "shape": f"preds ({n}, {c}) f32, T={t}",
        "max_abs_err": 0.0,
        "ms": gpu_ms(lambda: binned_counts_cuda(p, y, th)),
        "plain_ms": gpu_ms(lambda: binned_counts_torch(p, y, th)),
        "library_ms": None,
    }
    entry["bound_ms"], entry["bound_by"] = bound_ms(n * c * 5 + 4 * t + 3 * 4 * c * t, n * c * t)
    wp, wy = p[:BUCKET].reshape(1, -1).contiguous(), y[:BUCKET].reshape(1, -1).contiguous()
    extra = {"name": "binned_counts", "shape": f"preds (1, {BUCKET * c}) f32, T={t} (vmapped bucket)",
             "ms": gpu_ms(lambda: binned_counts_cuda(wp, wy, th)),
             "plain_ms": gpu_ms(lambda: binned_counts_torch(wp, wy, th))}
    extra["bound_ms"], extra["bound_by"] = bound_ms(BUCKET * c * 5 + 4 * t + 3 * 4 * BUCKET * c * t,
                                                    BUCKET * c * t)
    return entry, extra


# ------------------------------------------------------------------------- main path

def make_collection(device):
    from metrics_tpu_torch import Accuracy, BinnedAveragePrecision, ConfusionMatrix, F1Score, MetricCollection

    return MetricCollection({
        "acc": Accuracy(device=device),
        "f1": F1Score(num_classes=NUM_CLASSES, average="macro", device=device),
        "binned_ap": BinnedAveragePrecision(num_classes=NUM_CLASSES, thresholds=THRESHOLDS, device=device),
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


def masked_path(dev, preds, target, rng):
    coll = make_collection(dev)
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


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1
    from metrics_tpu_torch.ops.binned_update import binned_counts_cuda
    from metrics_tpu_torch.ops.kernels import build
    from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda

    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.library(name)
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {build.last_build_seconds:.2f} s)")

    rng = np.random.RandomState(SEED)
    t0 = time.perf_counter()
    fold_entry = fold_phase(dev, rng)
    hist_entry, hist_extra = hist_phase(dev, rng)
    binned_entry, binned_extra = binned_phase(dev, rng)
    print(f"kernel phases: pass ({time.perf_counter() - t0:.2f} s)")

    data_rng = np.random.RandomState(SEED)
    preds_np = data_rng.rand(N_ROWS, NUM_CLASSES).astype(np.float32)
    preds_np /= preds_np.sum(axis=1, keepdims=True)
    target_np = data_rng.randint(0, NUM_CLASSES, N_ROWS)
    preds, target = torch.from_numpy(preds_np).to(dev), torch.from_numpy(target_np).to(dev)

    kernels = {"fold_rows": fold_rows_cuda, "histogram": histogram_cuda, "binned_counts": binned_counts_cuda}
    for fn in kernels.values():
        fn.launches = 0
    gpu_state, gpu_values, one_shot_s = main_path(dev, preds, target)
    one_shot = {k: fn.launches for k, fn in kernels.items()}
    masked_state, masked_values, buckets, masked_s = masked_path(dev, preds_np, target_np, np.random.RandomState(SEED + 1))
    launches = {k: fn.launches for k, fn in kernels.items()}
    masked = {k: launches[k] - one_shot[k] for k in kernels}
    print(json.dumps({"launches": {"one_shot_update": one_shot, "masked_buckets": masked}}))
    for k in kernels:
        check(launches[k] > 0, f"kernel {k} was not launched on the main path")
        check(masked[k] > 0, f"kernel {k} was not launched by the masked bucket step")
    check(one_shot["histogram"] > 0 and one_shot["binned_counts"] > 0, "one-shot update skipped a kernel")

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
        "kernel_shapes": [hist_extra, binned_extra], "card": card,
    }))

    entries = []
    for e in (fold_entry, hist_entry, binned_entry):
        e["launches"] = launches[e["name"]]
        entries.append(e)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
