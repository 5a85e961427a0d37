"""A pool of ``torch.distributed`` (gloo) ranks for the port's sync tests.

This module imports no JAX: the ranks are spawned processes, and a spawned
process imports the module that holds its target. ``tests/test_torch_sync.py``
starts one :class:`RankPool` of three ranks per test module and sends it
every case by name; each rank runs ``CASES[name](ctx, **kwargs)`` and sends
back numpy results, or the traceback of what it raised.

Every rank builds a group over all three ranks (``ctx.groups["world"]``),
one over ranks 0 and 1 (``"pair"``), and one holding rank 2 alone
(``"solo"``); a case run on ``"pair"`` leaves rank 2 idle.
"""
import os
import pickle
import tempfile
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional

import numpy as np

WORLD = 3
C = 4
N_ROWS = 96
GROUP_RANKS = {"world": [0, 1, 2], "pair": [0, 1], "solo": [2]}

#: the dtypes and reductions the fused-bundle case covers
DTYPES = ("float32", "float16", "bfloat16", "float64", "int8", "uint8", "int16", "int32", "int64", "uint32", "bool")
FXS = ("sum", "mean", "min", "max", "cat", None, "max_fn")
#: float leaves that also ride the q8 carrier, and their length
Q8_DTYPES = ("float32", "float16", "bfloat16")
Q8_LEN = 200


# ------------------------------------------------------------------ the data


def leaf_values(dtype: str, rank: int) -> np.ndarray:
    """Rank ``rank``'s (2, 5) input for ``dtype``: seeded values with
    negatives, and for the 32-bit ints values whose sum overflows."""
    rng = np.random.RandomState(100 + 7 * rank + DTYPES.index(dtype))
    if dtype == "bool":
        return rng.rand(2, 5) > 0.5
    if dtype in ("float32", "float16", "bfloat16", "float64"):
        return (rng.randn(2, 5) * 4).astype(np.float32 if dtype == "bfloat16" else dtype)
    info = np.iinfo(dtype)
    lo, hi = (max(info.min, -(2**31)), min(info.max, 2**31 - 1))
    vals = rng.randint(lo, hi, size=(2, 5), dtype=np.int64)
    vals[0, 0], vals[1, 4] = hi, lo  # the extremes: sums overflow, min/max hit them
    return vals.astype(dtype)


def q8_values(dtype: str, rank: int) -> np.ndarray:
    """A (Q8_LEN,) float leaf: mixed magnitudes, an outlier block and a block
    below the flush threshold."""
    rng = np.random.RandomState(500 + 11 * rank + Q8_DTYPES.index(dtype))
    v = rng.randn(Q8_LEN).astype(np.float32) * 3
    v[40] = 250.0
    if dtype == "float32":
        v[64:96] = rng.randn(32).astype(np.float32) * 1e-37
    return v


def cls_rows(n: int, seed: int, heads: Optional[int] = None):
    rng = np.random.RandomState(seed)
    p = rng.rand(n, C).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    return p, rng.randint(0, C, (n,))


def reg_rows(n: int, seed: int, cols: Optional[int] = None):
    rng = np.random.RandomState(seed)
    shape = (n,) if cols is None else (n, cols)
    t = rng.gamma(2.0, 1.0, shape).astype(np.float32) + 0.05
    return (t * rng.lognormal(0.0, 0.3, shape)).astype(np.float32), t


def suite(pkg: Any, capacity: int = 64, **kw: Any) -> Dict[str, Any]:
    """The metrics the metric-level cases sync, built from ``pkg``
    (``metrics_tpu`` or ``metrics_tpu_torch``), and the rows each takes:
    name -> (metric or collection, row kind)."""
    def composed():
        p = pkg.Precision(num_classes=C, average="macro", **kw)
        r = pkg.Recall(num_classes=C, average="macro", **kw)
        return 2 * p * r / (p + r)

    return {
        "flagship": (pkg.MetricCollection({
            "acc": pkg.Accuracy(**kw),
            "f1": pkg.F1Score(num_classes=C, average="macro", **kw),
            "ap": pkg.BinnedAveragePrecision(num_classes=C, thresholds=9, **kw),
            "cm": pkg.ConfusionMatrix(num_classes=C, **kw),
        }), "cls"),
        "capacity": (pkg.MetricCollection({
            "auroc": pkg.AUROC(num_classes=C, capacity=capacity, **kw),
            "ap": pkg.AveragePrecision(num_classes=C, capacity=capacity, **kw),
        }), "cls"),
        "regression": (pkg.MetricCollection({
            "mse": pkg.MeanSquaredError(**kw),
            "rmse": pkg.MeanSquaredError(squared=False, **kw),
            "mae": pkg.MeanAbsoluteError(**kw),
            "msle": pkg.MeanSquaredLogError(**kw),
            "mape": pkg.MeanAbsolutePercentageError(**kw),
            "smape": pkg.SymmetricMeanAbsolutePercentageError(**kw),
            "explained_variance": pkg.ExplainedVariance(**kw),
            "tweedie": pkg.TweedieDevianceScore(power=1.5, **kw),
        }), "reg"),
        "mse_q8": (pkg.MeanSquaredError(sync_precision="q8_block", **kw), "reg"),
        "pearson": (pkg.PearsonCorrCoef(**kw), "reg"),
        "minmax": (pkg.MinMaxMetric(pkg.Accuracy(**kw)), "cls"),
        "multioutput": (pkg.MultioutputWrapper(pkg.MeanSquaredError(**kw), num_outputs=2), "reg2"),
        "bootstrap": (pkg.BootStrapper(pkg.Accuracy(num_classes=C, **kw), num_bootstraps=3, seed=1), "cls"),
        "composition": (composed(), "cls"),
    }


def rows_for(kind: str, lo: int, hi: int):
    """Rows ``lo:hi`` of the seeded ``N_ROWS`` rows of ``kind``."""
    p, t = {"cls": lambda: cls_rows(N_ROWS, 0), "reg": lambda: reg_rows(N_ROWS, 1),
            "reg2": lambda: reg_rows(N_ROWS, 2, cols=2)}[kind]()
    return p[lo:hi], t[lo:hi]


def shard(world: int, pos: int):
    """The row range of position ``pos`` among ``world`` ranks."""
    step = N_ROWS // world
    return pos * step, (pos + 1) * step


# ---------------------------------------------------------------- numpy trees


def to_np(x: Any) -> Any:
    """Tensors to ``("tensor", dtype name, numpy array)`` (bf16 widened to
    f32, exactly); containers recurse."""
    import torch

    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        return ("tensor", name, (t.float() if t.dtype == torch.bfloat16 else t).numpy())
    if isinstance(x, dict):
        return {k: to_np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_np(v) for v in x]
    return x


# -------------------------------------------------------------------- the cases


class Ctx:
    def __init__(self, rank: int, groups: Dict[str, Any]):
        self.rank = rank
        self.groups = groups

    def member(self, name: str) -> bool:
        return self.rank in GROUP_RANKS[name]

    def pos(self, name: str) -> int:
        return GROUP_RANKS[name].index(self.rank)


def _torch_leaves(rank: int):
    """``(fx, tensor)`` leaves and precisions of the fused-bundle case: every
    dtype under every reduction, then the q8 leaves."""
    import torch

    from metrics_tpu_torch.ops.kernels.common import combine

    def max_fn(a, b):
        return combine(a, b, "max") if a.dtype != torch.bool else torch.logical_or(a, b)

    leaves, precs = [], []
    for dt in DTYPES:
        v = torch.from_numpy(leaf_values(dt, rank)).to(getattr(torch, dt))
        for fx in FXS:
            leaves.append((max_fn if fx == "max_fn" else fx, v.clone()))
            precs.append("exact")
    for dt in Q8_DTYPES:
        leaves.append(("sum", torch.from_numpy(q8_values(dt, rank)).to(getattr(torch, dt))))
        precs.append("q8_block")
    return leaves, precs


def case_fused(ctx: Ctx, group: str) -> Any:
    """One ``fused_axis_sync`` of every leaf on ``group``: the results, the
    collectives counted, and the plan."""
    if not ctx.member(group):
        return None
    from metrics_tpu_torch.parallel import collectives as col

    leaves, precs = _torch_leaves(ctx.rank)
    g = ctx.groups[group]
    col.reset_collective_counts()
    out = col.fused_axis_sync(leaves, g, precisions=precs)
    counts = col.collective_counts()
    plan = col.fused_sync_plan([(fx, v, p) for (fx, v), p in zip(leaves, precs)], len(GROUP_RANKS[group]))
    exact_bytes = col.sync_payload_bytes([(fx, v, None) for fx, v in leaves], len(GROUP_RANKS[group]))
    q8_bytes = col.sync_payload_bytes([(fx, v, p) for (fx, v), p in zip(leaves, precs)], len(GROUP_RANKS[group]))
    one = col.sync_axis_state("sum", leaves[0][1], g)
    return {"out": to_np(out), "counts": counts, "plan": plan, "exact_bytes": exact_bytes,
            "q8_bytes": q8_bytes, "one": to_np(one)}


def _update(metric: Any, kind: str, lo: int, hi: int) -> None:
    import torch

    p, t = rows_for(kind, lo, hi)
    mid = (hi - lo) // 2
    for a, b in ((0, mid), (mid, hi - lo)):
        metric.update(torch.from_numpy(p[a:b]), torch.from_numpy(t[a:b]))


def case_suite(ctx: Ctx, group: str) -> Any:
    """Each rank updates every suite metric on its shard; returns its local
    states, the port's ``sync_states`` of them, ``compute_synced`` and the
    eager ``compute()`` under ``sync_context``."""
    if not ctx.member(group):
        return None
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.parallel import metric_axis

    g = ctx.groups[group]
    lo, hi = shard(len(GROUP_RANKS[group]), ctx.pos(group))
    out = {}
    with metric_axis(g):
        for name, (metric, kind) in suite(mp, device="cpu").items():
            _update(metric, kind, lo, hi)
            local = ({k: m._pack_state() for k, m in metric.items(keep_base=True)}
                     if isinstance(metric, mp.MetricCollection) else metric._pack_state())
            synced = metric.sync_states(local)
            out[name] = {
                "local": to_np(local),
                "synced": to_np(synced),
                "compute_synced": to_np(metric.compute_synced(local)),
                "compute": to_np(metric.compute()),
            }
        tracker = mp.MetricTracker(mp.Accuracy(device="cpu"))
        tracker.increment()
        _update(tracker, "cls", lo, hi)
        out["tracker"] = {"compute": to_np(tracker.compute())}
    return out


def case_errors(ctx: Ctx) -> Any:
    """The refusals, on the full group: already synced, un-synced twice,
    update/forward while synced, list states of differing lengths."""
    import torch

    import metrics_tpu_torch as mp
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    g = ctx.groups["world"]
    p, t = rows_for("cls", *shard(WORLD, ctx.rank))
    msgs = {}

    def expect(name: str, fn: Callable[[], Any]) -> None:
        try:
            fn()
        except MetricsTPUUserError as e:
            msgs[name] = str(e)
        else:
            msgs[name] = None

    m = mp.Accuracy(device="cpu", process_group=g)
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    m.sync()
    expect("sync_twice", m.sync)
    expect("update_synced", lambda: m.update(torch.from_numpy(p), torch.from_numpy(t)))
    expect("forward_synced", lambda: m(torch.from_numpy(p), torch.from_numpy(t)))
    m.unsync()
    expect("unsync_twice", m.unsync)
    # the list state (eager AUROC) of differing lengths, eagerly and purely
    rows = 8 + 4 * ctx.rank
    a = mp.AUROC(device="cpu", process_group=g)
    a.update(torch.from_numpy(p[:rows, 1]), torch.from_numpy((t[:rows] == 1).astype(np.int64)))
    expect("list_lengths_compute", a.compute)
    expect("list_lengths_sync_states", lambda: a.sync_states(a._pack_state()))
    # equal lengths gather, as one-element lists
    b = mp.CatMetric(device="cpu", process_group=g)
    b.update(torch.arange(3, dtype=torch.float32) + 10 * ctx.rank)
    b.update(torch.tensor([-1.0 - ctx.rank]))
    b.sync()
    gathered = to_np(b.value)
    b.unsync()
    return {"msgs": msgs, "synced_flag": m._is_synced, "cat": gathered, "local_cat": to_np(b.value)}


def case_forward_on_step(ctx: Ctx, group: str) -> Any:
    """``dist_sync_on_step`` forward values over ``group``: the delta path
    (Accuracy, MeanSquaredError) and the snapshot path (Pearson)."""
    if not ctx.member(group):
        return None
    import torch

    import metrics_tpu_torch as mp

    g = ctx.groups[group]
    world = len(GROUP_RANKS[group])
    out: Dict[str, List[Any]] = {"acc": [], "mse": [], "pearson": [], "acc_local": []}
    acc = mp.Accuracy(device="cpu", dist_sync_on_step=True, process_group=g)
    local = mp.Accuracy(device="cpu", process_group=g)
    mse = mp.MeanSquaredError(device="cpu", dist_sync_on_step=True, process_group=g)
    pearson = mp.PearsonCorrCoef(device="cpu", dist_sync_on_step=True, process_group=g)
    for step in range(2):
        lo, hi = shard(world * 2, 2 * ctx.pos(group) + step)
        p, t = rows_for("cls", lo, hi)
        out["acc"].append(to_np(acc(torch.from_numpy(p), torch.from_numpy(t))))
        out["acc_local"].append(to_np(local(torch.from_numpy(p), torch.from_numpy(t))))
        rp, rt = rows_for("reg", lo, hi)
        out["mse"].append(to_np(mse(torch.from_numpy(rp), torch.from_numpy(rt))))
        out["pearson"].append(to_np(pearson(torch.from_numpy(rp), torch.from_numpy(rt))))
    out["acc_compute"] = to_np(acc.compute())
    out["pearson_compute"] = to_np(pearson.compute())
    out["acc_local_state"] = to_np(acc._pack_state())
    out["local_state"] = to_np(local._pack_state())
    return out


def case_group_handling(ctx: Ctx) -> Any:
    """A metric holding a group: ``clone()`` shares it, pickling forgets it,
    ``state_dict`` ignores it; the solo group (world 1) runs the bundle;
    the ambient group applies; a string group is refused."""
    import torch

    import metrics_tpu_torch as mp
    from metrics_tpu_torch.parallel import collectives as col
    from metrics_tpu_torch.parallel import metric_axis

    out: Dict[str, Any] = {}
    p, t = rows_for("cls", *shard(WORLD, ctx.rank))
    if ctx.member("pair"):
        g = ctx.groups["pair"]
        m = mp.Accuracy(device="cpu", sync_axis=g)
        m.update(torch.from_numpy(p), torch.from_numpy(t))
        twin = m.clone()
        out["clone_shares_group"] = twin.sync_axis is g
        out["unpickled_group"] = pickle.loads(pickle.dumps(m)).sync_axis
        out["state_dict"] = sorted(m.state_dict())
        out["clone_compute"] = to_np(twin.compute())
        out["compute"] = to_np(m.compute())
    if ctx.member("solo"):
        s = mp.MetricCollection({"acc": mp.Accuracy(device="cpu"), "cm": mp.ConfusionMatrix(num_classes=C, device="cpu")})
        s.update(torch.from_numpy(p), torch.from_numpy(t))
        state = s.init_state()
        state = s.update_state(state, torch.from_numpy(p), torch.from_numpy(t))
        col.reset_collective_counts()
        with metric_axis(ctx.groups["solo"]):
            synced = s.sync_states(state)
            out["solo_counts"] = col.collective_counts()
            out["solo_compute"] = to_np(s.compute())  # world 1: no eager sync
        out["solo_equal"] = all(torch.equal(synced[k][n], state[k][n]) for k in state for n in state[k])
    try:
        mp.Accuracy(device="cpu", process_group="dp")
        out["string_group"] = None
    except TypeError as e:
        out["string_group"] = str(e)
    return out


def case_list_refusal(ctx: Ctx, device: str) -> Any:
    """Eager list states (AUROC) of differing lengths on ``device``, over the
    default group: every rank raises, naming the state."""
    import torch

    import metrics_tpu_torch as mp
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    p, t = rows_for("cls", 0, 8 + 4 * ctx.rank)
    a = mp.AUROC(device=device)
    a.update(torch.from_numpy(p[:, 1]), torch.from_numpy((t == 1).astype(np.int64)))
    try:
        a.compute()
    except MetricsTPUUserError as e:
        return str(e)
    return None


RETRIEVAL_DOCS = 10  # documents per query; each rank owns two queries


def retrieval_rows(rank: int, interleaved: bool = False):
    """Rank ``rank``'s retrieval shard: ``(preds, target, indexes)`` of two
    queries of :data:`RETRIEVAL_DOCS` documents, each with a positive and a
    negative; its query ids are ``{2 rank, 2 rank + 1}``, or with
    ``interleaved`` ``{rank, rank + 2}`` (ids spread over the ranks)."""
    rng = np.random.RandomState(100 + rank)
    preds = np.round(rng.rand(2 * RETRIEVAL_DOCS), 1).astype(np.float32)
    target = rng.randint(0, 2, 2 * RETRIEVAL_DOCS)
    target[[0, RETRIEVAL_DOCS]] = 1
    target[[1, RETRIEVAL_DOCS + 1]] = 0
    ids = (rank, rank + 2) if interleaved else (2 * rank, 2 * rank + 1)
    return preds, target, np.repeat(np.asarray(ids), RETRIEVAL_DOCS)


def retrieval_suite(pkg: Any, **kw: Any) -> Dict[str, Any]:
    """The retrieval metrics of the gather case, by name."""
    return {"map": pkg.RetrievalMAP(**kw), "mrr": pkg.RetrievalMRR(**kw),
            "ndcg": pkg.RetrievalNormalizedDCG(**kw), "precision_at_3": pkg.RetrievalPrecision(k=3, **kw)}


def case_retrieval(ctx: Ctx, group: str, interleaved: bool) -> Any:
    """Each rank updates the retrieval suite on its shard; returns its
    ``sync_states`` (the gathered cat lists) and the eager ``compute()``
    under ``sync_context``, both over ``group``."""
    if not ctx.member(group):
        return None
    import torch

    import metrics_tpu_torch as mp
    from metrics_tpu_torch.parallel import metric_axis

    p, t, i = retrieval_rows(ctx.pos(group), interleaved)
    out = {}
    with metric_axis(ctx.groups[group]):
        for name, metric in retrieval_suite(mp, device="cpu").items():
            metric.update(torch.from_numpy(p), torch.from_numpy(t), indexes=torch.from_numpy(i))
            out[name] = {"synced": to_np(metric.sync_states(metric._pack_state())),
                         "compute": to_np(metric.compute())}
    return out


#: the grouped-state case: the group universe, the capacity, rows a rank
GROUPED_G, GROUPED_CAP, GROUPED_ROWS = 12, 16, 24


def grouped_rows(rank: int):
    """Rank ``rank``'s retrieval rows ``(preds, target, group ids)``, preds
    tied at one decimal."""
    rng = np.random.RandomState(300 + rank)
    return (np.round(rng.rand(GROUPED_ROWS), 1).astype(np.float32), rng.randint(0, 2, GROUPED_ROWS),
            rng.randint(0, GROUPED_G, GROUPED_ROWS))


def case_grouped(ctx: Ctx, group: str) -> Any:
    """Each rank serves its rows through a world-1 ``RaggedEngine``; returns
    its local grouped state and ``GroupedStateMetric.sync_states`` of it over
    ``group`` (one gather bundle, then the compaction merge)."""
    if not ctx.member(group):
        return None
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.engine import EngineConfig, RaggedEngine

    eng = RaggedEngine(mp.RetrievalMAP(device="cpu"), GROUPED_G, config=EngineConfig(buckets=(32,)),
                       capacity=GROUPED_CAP)
    with eng:
        eng.submit_update(*grouped_rows(ctx.pos(group)))
        eng.flush()
        local = eng.state()
    return {"local": to_np(local), "synced": to_np(eng._metric.sync_states(local, ctx.groups[group]))}


#: the text metrics of the gather case, by name: their constructor keywords
TEXT_SUITE = {
    "WordErrorRate": {},
    "BLEUScore": {"n_gram": 4},
    "CHRFScore": {"return_sentence_level_score": True},
    "ROUGEScore": {},
    "TranslationEditRate": {"return_sentence_level_score": True},
    "SQuAD": {},
}
TEXT_WORDS = ("the", "cat", "sat", "on", "mat", "a", "dog", "ran", "in", "park", "hello", "world", "it's", "3.5")


def text_rows(cls: str, rank: int):
    """Rank ``rank``'s update arguments for text metric ``cls``: five seeded
    reference sentences and their hypotheses (words dropped), as SQuAD
    dicts with ids unique to the rank, or BLEU's reference lists."""
    rng = np.random.RandomState(200 + rank)
    refs = [" ".join(TEXT_WORDS[i] for i in rng.randint(0, len(TEXT_WORDS), int(rng.randint(1, 10))))
            for _ in range(5)]
    hyps = [" ".join(w for w in r.split() if rng.rand() > 0.25) for r in refs]
    if cls == "SQuAD":
        return ([{"prediction_text": h, "id": f"r{rank}q{i}"} for i, h in enumerate(hyps)],
                [{"answers": {"text": [r]}, "id": f"r{rank}q{i}"} for i, r in enumerate(refs)])
    if cls == "BLEUScore":
        return hyps, [[r] for r in refs]
    return hyps, refs


def case_text(ctx: Ctx, group: str) -> Any:
    """Each rank updates :data:`TEXT_SUITE` on its shard; returns each
    metric's ``sync_states`` and its eager ``compute()`` over ``group``."""
    if not ctx.member(group):
        return None
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.parallel import metric_axis

    out = {}
    with metric_axis(ctx.groups[group]):
        for name, kw in TEXT_SUITE.items():
            metric = getattr(mp, name)(device="cpu", **kw)
            metric.update(*text_rows(name, ctx.pos(group)))
            out[name] = {"synced": to_np(metric.sync_states(metric._pack_state())),
                         "compute": to_np(metric.compute())}
    return out


#: the signal metrics of the sync case, by name: (class, constructor keywords, rows of ``signal_rows``)
SIGNAL_SUITE = {
    "SignalNoiseRatio": ("SignalNoiseRatio", {}, "audio"),
    "PSNR": ("PSNR", {}, "image"),
    "PSNR_data_range": ("PSNR", {"data_range": 1.0}, "image"),
    "SSIM": ("SSIM", {"kernel_size": (5, 5)}, "image"),
}


def signal_rows(kind: str, rank: int):
    """Rank ``rank``'s ``(preds, target)``: ``(rank + 2, 2, 256)`` noisy
    signals, or ``(2, 3, 24, 20)`` noisy images with a different range on
    each rank (the min/max differ; a ``cat`` list gathers equal row counts)."""
    rng = np.random.RandomState(300 + rank)
    if kind == "audio":
        t = rng.randn(rank + 2, 2, 256).astype(np.float32)
        return (t + 0.3 * rng.randn(*t.shape)).astype(np.float32), t
    t = (rng.rand(2, 3, 24, 20) * (1.0 + rank) - 0.25 * rank).astype(np.float32)
    return (t + 0.05 * rng.randn(*t.shape)).astype(np.float32), t


def case_signal(ctx: Ctx, group: str) -> Any:
    """Each rank updates :data:`SIGNAL_SUITE` on its shard; returns each
    metric's ``sync_states`` and its eager ``compute()`` over ``group``."""
    if not ctx.member(group):
        return None
    import warnings

    import metrics_tpu_torch as mp
    from metrics_tpu_torch.parallel import metric_axis

    out = {}
    with metric_axis(ctx.groups[group]), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # SSIM's warning of its buffers
        for name, (cls, kw, kind) in SIGNAL_SUITE.items():
            metric = getattr(mp, cls)(device="cpu", **kw)
            metric.update(*signal_rows(kind, ctx.pos(group)))
            out[name] = {"synced": to_np(metric.sync_states(metric._pack_state())),
                         "compute": to_np(metric.compute())}
    return out


IMAGE_MODEL_DIM = 6
IMAGE_MODEL_PROJ = np.random.RandomState(700).randn(5, IMAGE_MODEL_DIM).astype(np.float32)
IMAGE_MODEL_KID = {"subsets": 4, "subset_size": 7, "seed": 9}


def image_model_rows(rank: int):
    """Rank ``rank``'s ``(real, fake)`` ``(6, 5)`` rows (a common offset; a list state gathers equal row
    counts), the input of a linear feature."""
    rng = np.random.RandomState(710 + rank)
    return ((rng.randn(6, 5) + 3.0).astype(np.float32), (rng.randn(6, 5) * 1.3 + 3.2).astype(np.float32))


def case_image_models(ctx: Ctx, group: str) -> Any:
    """Each rank updates a streaming FID, a list FID and a KID on a linear
    feature of its shard; returns each synced ``compute()`` over ``group``
    and the synced shape of FID's scatter state."""
    if not ctx.member(group):
        return None
    import torch

    import metrics_tpu_torch as mp
    from metrics_tpu_torch.parallel import metric_axis

    def feat(x: Any) -> Any:
        return torch.as_tensor(x) @ torch.from_numpy(IMAGE_MODEL_PROJ)

    real, fake = image_model_rows(ctx.pos(group))
    out = {}
    with metric_axis(ctx.groups[group]):
        metrics = {"fid": mp.FID(feature=feat, feature_dim=IMAGE_MODEL_DIM, device="cpu"),
                   "fid_list": mp.FID(feature=feat, streaming=False, device="cpu"),
                   "kid": mp.KID(feature=feat, device="cpu", **IMAGE_MODEL_KID)}
        for name, metric in metrics.items():
            metric.update(real, real=True)
            metric.update(fake, real=False)
            if name == "fid":
                out["fid_state_shape"] = list(metric.sync_states(metric._pack_state())["real_m2_hi"].shape)
            out[name] = to_np(metric.compute())
    return out


CASES: Dict[str, Callable[..., Any]] = {
    "image_models": case_image_models,
    "signal": case_signal,
    "text": case_text,
    "retrieval": case_retrieval,
    "grouped": case_grouped,
    "list_refusal": case_list_refusal,
    "fused": case_fused,
    "suite": case_suite,
    "errors": case_errors,
    "forward_on_step": case_forward_on_step,
    "group_handling": case_group_handling,
}


# --------------------------------------------------------------------- the pool


def _serve(rank: int, world: int, store: str, cuda: bool, tasks: Any, results: Any) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                           timeout=timedelta(seconds=60))
    groups = {"world": None}
    if world == WORLD:
        for name in ("pair", "solo"):  # every rank creates every group, in one order
            groups[name] = dist.new_group(GROUP_RANKS[name])
    ctx = Ctx(rank, groups)
    while True:
        task = tasks.get()
        if task is None:
            break
        name, kwargs = task
        try:
            results.put((rank, True, CASES[name](ctx, **kwargs)))
        except BaseException:  # noqa: BLE001 - the test reports it
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` spawned gloo ranks serving :data:`CASES` (three, with the
    ``pair`` and ``solo`` groups, unless told otherwise); ``cuda`` sets each
    rank's device to the first card before the group starts."""

    def __init__(self, world: int = WORLD, cuda: bool = False) -> None:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world = world
        self._dir = tempfile.mkdtemp(prefix="torch_sync_")
        store = os.path.join(self._dir, "store")
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_serve, args=(r, world, store, cuda, self._tasks[r], self._results),
                                   daemon=True)
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, name: str, timeout: float = 120.0, **kwargs: Any) -> List[Any]:
        """Run case ``name`` on every rank; its results by rank. Raises with
        the ranks' tracebacks if any failed."""
        for q in self._tasks:
            q.put((name, kwargs))
        got: Dict[int, Any] = {}
        errors = []
        for _ in range(self.world):
            rank, ok, value = self._results.get(timeout=timeout)
            (got.__setitem__(rank, value) if ok else errors.append(f"rank {rank}:\n{value}"))
        if errors:
            raise RuntimeError(f"case {name!r} failed:\n" + "\n".join(errors))
        return [got[r] for r in range(self.world)]

    def close(self) -> None:
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=20)
            if p.is_alive():
                p.kill()
