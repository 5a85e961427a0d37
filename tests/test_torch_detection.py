"""The port's detection (``MAP``, K9's plain matcher) against the JAX package's, on the CPU.

The same seeded numpy scenes go through ``metrics_tpu``'s ``MAP`` and the
port's ``MAP(device="cpu")``: the three box formats, ``class_metrics``,
``matching="device"`` and ``"host"``, empty images, classes with
detections and no ground truth and the reverse, score ties (scores drawn
from a handful of values), boxes exactly at the 32² and 96² area
boundaries, and custom IoU, recall and ``max_det`` thresholds. The box
helpers and the greedy matcher are held against JAX's functions directly.

Tolerances: none. IoUs and areas are bit-equal (the same f32 operations in
the same order); the matcher's ``(dm, mi)`` are equal; every result key is
equal as float32 (the same float64 numpy accumulation on equal inputs).
JAX compiles ``_match_all_pairs`` once per padded shape and its eager scan
per input shape, so the scenes reuse a few sizes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.detection.map as jmap
import metrics_tpu_torch as mp
import metrics_tpu_torch.detection.map as pmap
from metrics_tpu.engine import EngineConfig as JC
from metrics_tpu.engine import MultiStreamEngine as JMulti
from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine
from metrics_tpu_torch.ops.kernels.match_cuda import greedy_match, greedy_match_plain
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utils.state_bridge import state_from_numpy, state_to_numpy

FORMATS = ("xyxy", "xywh", "cxcywh")
# sides that put areas exactly on the small/medium (32²) and medium/large (96²) boundaries
SIDES = np.asarray([6.0, 20.0, 32.0, 32.0, 50.0, 96.0, 96.0, 140.0], np.float32)
SCORES = np.asarray([0.0, 0.25, 0.5, 0.5, 0.75, 0.9, 0.9], np.float32)


def to_format(xyxy, fmt):
    x1, y1, x2, y2 = (xyxy[:, i] for i in range(4))
    if fmt == "xywh":
        return np.stack([x1, y1, x2 - x1, y2 - y1], axis=1).astype(np.float32)
    if fmt == "cxcywh":
        return np.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], axis=1).astype(np.float32)
    return xyxy


def scene(rng, n_img=10, n_cls=4, fmt="xyxy", max_gt=5, fp=3):
    """``(preds, targets)``: gts at boundary-hitting sizes, dets as jittered
    (some exact, some class-flipped) copies plus false positives, tie-heavy
    scores; image 1 empty, image 2 detections only, image 3 gts only."""
    preds, targets = [], []
    for i in range(n_img):
        n_gt = 0 if i in (1, 2) else int(rng.randint(1, max_gt + 1))
        xy = np.round(rng.uniform(0, 300, (n_gt, 2))).astype(np.float32)
        gt = np.concatenate([xy, xy + rng.choice(SIDES, (n_gt, 2))], axis=1)
        gl = rng.randint(0, n_cls, n_gt)
        jitter = rng.choice(np.asarray([0.0, 0.0, 1.0, 3.0, -2.0], np.float32), (n_gt, 4))
        db = gt + jitter
        dl = gl.copy()
        flip = rng.rand(n_gt) < 0.2
        dl[flip] = (dl[flip] + 1) % n_cls
        n_fp = 0 if i in (1, 3) else fp
        fxy = np.round(rng.uniform(0, 300, (n_fp, 2))).astype(np.float32)
        db = np.concatenate([db, np.concatenate([fxy, fxy + rng.choice(SIDES, (n_fp, 2))], axis=1)])
        dl = np.concatenate([dl, rng.randint(0, n_cls, n_fp)])
        if i == 3:
            db, dl = db[:0], dl[:0]
        if i == 2:
            gt, gl = gt[:0], gl[:0]
        preds.append({"boxes": to_format(db.astype(np.float32), fmt),
                      "scores": rng.choice(SCORES, db.shape[0]).astype(np.float32), "labels": dl})
        targets.append({"boxes": to_format(gt.astype(np.float32), fmt), "labels": gl})
    return preds, targets


def run(pkg, preds, targets, batch=4, **kw):
    m = pkg.MAP(**kw) if pkg is mt else pkg.MAP(device="cpu", **kw)
    for i in range(0, len(preds), batch):
        m.update(preds[i:i + batch], targets[i:i + batch])
    return m


def assert_results_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def port_values(res):
    return {k: v.numpy() for k, v in res.items()}


# ------------------------------------------------------------------ box helpers


def test_box_helpers_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    b = rng.uniform(0, 200, (40, 4)).astype(np.float32)
    b[:, 2:] = b[:, :2] + rng.choice(np.asarray([0.0, 0.5, 3.0, 32.0, 96.0, 117.3], np.float32), (40, 2))
    b[5] = b[6]  # identical boxes
    b[7, 2:] = b[7, :2] - 4.0  # inverted (negative area)
    b[8, 2] = b[8, 0]  # zero width
    for fmt in FORMATS:
        got = pmap.box_convert(torch.from_numpy(b), fmt).numpy()
        np.testing.assert_array_equal(got, np.asarray(jmap.box_convert(jnp.asarray(b), fmt)))
        np.testing.assert_array_equal(pmap._box_convert_np(b, fmt), jmap._box_convert_np(b, fmt))
    with pytest.raises(ValueError, match="Unsupported box format"):
        pmap.box_convert(b, "yxyx", "xywh")
    np.testing.assert_array_equal(pmap.box_area(torch.from_numpy(b)).numpy(), np.asarray(jmap.box_area(jnp.asarray(b))))
    got = pmap.box_iou(torch.from_numpy(b[:20]), torch.from_numpy(b[20:])).numpy()
    want = np.asarray(jmap.box_iou(jnp.asarray(b[:20]), jnp.asarray(b[20:])))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    same = pmap.box_iou(torch.from_numpy(b[5:7]), torch.from_numpy(b[5:7])).numpy()
    assert same[0, 1] == 1.0 and same[1, 0] == 1.0
    # batched over a leading axis, as the packed pairs use it
    batched = pmap.box_iou(torch.from_numpy(b[:20].reshape(2, 10, 4)), torch.from_numpy(b[20:].reshape(2, 10, 4)))
    want = np.asarray(jax.vmap(jmap.box_iou)(jnp.asarray(b[:20].reshape(2, 10, 4)), jnp.asarray(b[20:].reshape(2, 10, 4))))
    np.testing.assert_array_equal(batched.numpy().view(np.int32), want.view(np.int32))


# ------------------------------------------------------------------ the matcher


# vmap(vmap(_greedy_match_single)) over problems and areas: what K9 computes, compiled once a shape
_JAX_MATCH = jax.jit(jax.vmap(jax.vmap(jmap._greedy_match_single, in_axes=(None, None, None, 0, None)),
                              in_axes=(0, 0, 0, 0, None)))


def jax_match(iou, dv, gv, gi, thr):
    """JAX's matcher over ``(P, D, G)`` blocks and ``(P, A, G)`` ignore flags."""
    dm, mi = _JAX_MATCH(jnp.asarray(iou, jnp.float32), jnp.asarray(dv), jnp.asarray(gv), jnp.asarray(gi),
                        jnp.asarray(thr, jnp.float32))
    return np.asarray(dm), np.asarray(mi)


@pytest.mark.parametrize("seed", range(6))
def test_greedy_match_plain_bit_equal_to_jax(seed):
    """Quantized IoUs (dense ties, exact 1.0, zeros), invalid det and gt rows,
    area-ignored gts (ignored-only pools included) and a threshold of 1.0: the
    plain matcher over (P, A) equals JAX's scan per problem and area."""
    rng = np.random.RandomState(seed)
    d, g, a = 6, 5, 3  # fixed per seed: JAX's eager scan compiles once per shape
    thr = np.asarray([0.0, 0.5, 0.55, 0.75, 1.0], np.float32)
    p = 4
    iou = rng.choice(np.asarray([0.0, 0.25, 0.5, 0.5, 0.55, 0.75, 0.75, 1.0], np.float32), (p, d, g))
    dv = rng.rand(p, d) > 0.2
    gv = rng.rand(p, g) > 0.2
    gi = rng.rand(p, a, g) > 0.5
    gi[0, 0] = True  # an ignored-only pool
    dm, mi = greedy_match_plain(torch.from_numpy(iou), torch.arange(p, dtype=torch.int32), torch.from_numpy(dv),
                                torch.from_numpy(gv), torch.from_numpy(gi), torch.from_numpy(thr))
    jdm, jmi = jax_match(iou, dv, gv, gi, thr)
    np.testing.assert_array_equal(dm.numpy().astype(bool), jdm)
    np.testing.assert_array_equal(mi.numpy(), jmi)
    # the port's single-cell entry goes through the dispatcher to the same matcher
    sdm, smi = pmap._greedy_match_single(torch.from_numpy(iou[0]), torch.from_numpy(dv[0]), torch.from_numpy(gv[0]),
                                         torch.from_numpy(gi[0, 0]), torch.from_numpy(thr))
    np.testing.assert_array_equal(sdm.numpy(), jdm[0, 0])
    np.testing.assert_array_equal(smi.numpy(), jmi[0, 0])


def test_greedy_match_index_names_the_block():
    """``iou_index`` picks each problem's block (the corpus path's sharing):
    the result equals the matcher over the gathered blocks; an index out of
    range matches nothing."""
    rng = np.random.RandomState(3)
    iou = torch.from_numpy(rng.choice(np.asarray([0.0, 0.5, 0.75, 1.0], np.float32), (3, 4, 5)))
    idx = torch.tensor([2, 0, 2, 1, 5, -1], dtype=torch.int32)
    dv, gv = torch.ones(6, 4, dtype=torch.bool), torch.ones(6, 5, dtype=torch.bool)
    gi = torch.from_numpy(rng.rand(6, 2, 5) > 0.5)
    thr = torch.tensor([0.5, 0.9])
    dm, mi = greedy_match(iou, idx, dv, gv, gi, thr)
    live = idx[:4].long()
    gdm, gmi = greedy_match_plain(iou[live], torch.arange(4, dtype=torch.int32), dv[:4], gv[:4], gi[:4], thr)
    assert torch.equal(dm[:4], gdm) and torch.equal(mi[:4], gmi)
    assert not dm[4:].any() and bool((mi[4:] == -1).all())


def test_greedy_match_tie_pins():
    """JAX's pins (``tests/detection/test_greedy_tiebreak.py``): a tie goes to
    the later gt; the matched mask carries; a regular gt beats a tied ignored
    one in either order; an ignored-only pool still matches its best."""
    one = torch.zeros(1, dtype=torch.int32)
    thr = torch.tensor([0.5, 0.75])

    def run1(iou, gi, dv=None):
        iou = torch.tensor(iou, dtype=torch.float32)
        d, g = iou.shape
        dv = torch.ones(1, d, dtype=torch.bool) if dv is None else dv
        return greedy_match_plain(iou[None], one, dv, torch.ones(1, g, dtype=torch.bool),
                                  torch.tensor(gi)[None, None], thr)

    assert run1([[0.8, 0.8]], [False, False])[1][0, 0, 0, 0] == 1
    assert run1([[0.7, 0.7], [0.7, 0.7]], [False, False])[1][0, 0, 0].tolist() == [1, 0]
    for ignored_first in (True, False):
        dm, mi = run1([[0.6, 0.6]], [ignored_first, not ignored_first])
        assert mi[0, 0, 0, 0] == (1 if ignored_first else 0) and dm[0, 0, 0, 0] == 1
    assert run1([[0.9, 0.55]], [True, True])[1][0, 0, 0, 0] == 0
    dm, mi = run1([[0.9]], [False], dv=torch.zeros(1, 1, dtype=torch.bool))  # an invalid det marks nothing
    assert dm.sum() == 0 and bool((mi == -1).all())


# ------------------------------------------------------------------ the metric


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("class_metrics", [False, True])
def test_map_matches_jax_key_for_key(fmt, class_metrics):
    preds, targets = scene(np.random.RandomState(11), fmt=fmt)
    want = run(mt, preds, targets, box_format=fmt, class_metrics=class_metrics).compute()
    got = run(mp, preds, targets, box_format=fmt, class_metrics=class_metrics).compute()
    assert_results_equal(port_values(got), want)
    assert all(v.device.type == "cpu" and v.dtype == torch.float32 for v in got.values())
    assert float(got["map"]) > 0.1  # the matching engaged


def test_host_matching_matches_jax_host_and_the_device_path():
    preds, targets = scene(np.random.RandomState(5), n_img=5, n_cls=3, max_gt=3, fp=2)
    want = run(mt, preds, targets, matching="host", class_metrics=True).compute()
    got = run(mp, preds, targets, matching="host", class_metrics=True).compute()
    assert_results_equal(port_values(got), want)
    dev = run(mp, preds, targets, matching="device", class_metrics=True).compute()
    assert_results_equal(port_values(dev), port_values(got))


@pytest.mark.parametrize("kw", [
    {"iou_thresholds": [0.3, 0.5, 0.75, 1.0]},
    {"rec_thresholds": [0.0, 0.2, 0.5, 0.9, 1.0]},
    {"max_detection_thresholds": [5, 100, 2]},
    {"iou_thresholds": [0.5, 0.75], "max_detection_thresholds": [1, 3, 100], "class_metrics": True},
])
def test_custom_thresholds_match_jax(kw):
    preds, targets = scene(np.random.RandomState(23))
    want = run(mt, preds, targets, **kw).compute()
    assert_results_equal(port_values(run(mp, preds, targets, **kw).compute()), want)


def test_max_det_list_without_100_raises_as_jax():
    """``map`` summarizes at ``max_dets=100``: a list without 100 raises the
    same error in both packages."""
    preds, targets = scene(np.random.RandomState(23), n_img=4)
    with pytest.raises(ValueError) as pe:
        run(mp, preds, targets, max_detection_thresholds=[2, 1, 5]).compute()
    with pytest.raises(ValueError) as je:
        run(mt, preds, targets, max_detection_thresholds=[2, 1, 5]).compute()
    assert str(pe.value) == str(je.value)


def test_identical_boxes_match_at_iou_one():
    """A threshold of 1.0 clamps to 1 - 1e-10, which is 1.0 in float32:
    identical boxes match on both matching paths, as in JAX."""
    box = np.asarray([[10, 10, 42, 42], [60, 60, 156, 156]], np.float32)
    preds = [{"boxes": box, "scores": np.asarray([0.5, 0.5], np.float32), "labels": np.asarray([0, 0])}]
    targets = [{"boxes": box, "labels": np.asarray([0, 0])}]
    for matching in ("device", "host"):
        kw = {"iou_thresholds": [0.5, 0.75, 1.0], "matching": matching}
        got = run(mp, preds, targets, **kw).compute()
        assert float(got["map"]) == 1.0
        assert_results_equal(port_values(got), run(mt, preds, targets, **kw).compute())


def test_empty_and_single_class_corners_match_jax():
    empty = {"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32), "labels": np.zeros(0, int)}
    no_gt = {"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros(0, int)}
    # nothing at all: every value -1
    got = mp.MAP(device="cpu")
    got.update([empty], [no_gt])
    ref = mt.MAP()
    ref.update([empty], [no_gt])
    assert_results_equal(port_values(got.compute()), ref.compute())
    # detections of a class without ground truth, and ground truth without detections
    preds = [{"boxes": np.asarray([[0, 0, 10, 10]], np.float32), "scores": np.asarray([0.9], np.float32),
              "labels": np.asarray([3])}]
    targets = [{"boxes": np.asarray([[50, 50, 90, 90]], np.float32), "labels": np.asarray([7])}]
    for cm in (False, True):
        assert_results_equal(port_values(run(mp, preds, targets, class_metrics=cm).compute()),
                             run(mt, preds, targets, class_metrics=cm).compute())


def test_vectorized_packing_equals_the_per_pair_form():
    """``_pack_pairs`` builds the padded batch from two sorts over the corpus;
    it equals the per-pair form JAX builds (``_img_class_arrays`` for every
    (class, image) pair, the empty ones dropped), padding included."""
    preds, targets = scene(np.random.RandomState(2), n_img=12, n_cls=5)
    m = run(mp, preds, targets)
    classes = m._get_classes()
    for max_det in (100, 2):
        packed = m._pack_pairs(classes, max_det)
        per_pair = [(c, i, m._img_class_arrays(i, classes[c], max_det))
                    for c in range(len(classes)) for i in range(len(preds))]
        live = [(c, gt, det, sc) for c, _, (gt, det, sc) in per_pair if len(gt) or len(det)]
        assert packed.rows == len(live)
        for r, (c, gt, det, sc) in enumerate(live):
            assert packed.row_class[r] == c and packed.nd[r] == len(det) and packed.ng[r] == len(gt)
            np.testing.assert_array_equal(packed.det_boxes[r, :len(det)], det.reshape(-1, 4))
            np.testing.assert_array_equal(packed.det_scores[r, :len(det)], sc)
            np.testing.assert_array_equal(packed.gt_boxes[r, :len(gt)], gt.reshape(-1, 4))
        assert not packed.det_boxes[packed.rows:].any() and packed.det_boxes.shape[0] % 64 == 0
        assert packed.det_boxes.shape[1] % 8 == 0 and packed.gt_boxes.shape[1] % 8 == 0


def test_update_stages_on_the_host():
    """``update`` keeps numpy arrays (tensor inputs read off), moves nothing;
    ``.to()`` leaves the lists as they are; the values land on the metric's
    device."""
    preds, targets = scene(np.random.RandomState(4), n_img=4)
    tp = [{k: torch.from_numpy(np.asarray(v)) for k, v in p.items()} for p in preds]
    tt = [{k: torch.from_numpy(np.asarray(v)) for k, v in t.items()} for t in targets]
    m = mp.MAP(device="cpu")
    m.update(tp, tt)
    assert all(isinstance(x, np.ndarray) for name in m._host_list_states for x in getattr(m, name))
    m.to(torch.device("cpu"))
    assert all(isinstance(x, np.ndarray) for x in m.detection_boxes)
    assert_results_equal(port_values(m.compute()), run(mt, preds, targets).compute())
    m.reset()
    assert m.detection_boxes == [] and m.groundtruth_labels == []


def test_argument_and_input_checks_match_jax():
    for kw in ({"box_format": "yxyx"}, {"matching": "gpu"}, {"class_metrics": 1}):
        with pytest.raises(ValueError) as pe:
            mp.MAP(device="cpu", **kw)
        with pytest.raises(ValueError) as je:
            mt.MAP(**kw)
        assert str(pe.value) == str(je.value)
    good_p = {"boxes": np.zeros((1, 4), np.float32), "scores": np.zeros(1, np.float32), "labels": np.zeros(1, int)}
    good_t = {"boxes": np.zeros((1, 4), np.float32), "labels": np.zeros(1, int)}
    bad = [([good_p], [good_t, good_t]), ([{"boxes": good_p["boxes"], "labels": good_p["labels"]}], [good_t]),
           ([good_p], [{"boxes": good_t["boxes"]}]), ([good_p], [{"boxes": np.zeros((2, 4)), "labels": [0]}]),
           ([{**good_p, "scores": np.zeros(2)}], [good_t])]
    for p, t in bad:
        with pytest.raises(ValueError) as pe:
            mp.MAP(device="cpu").update(p, t)
        with pytest.raises(ValueError) as je:
            mt.MAP().update(p, t)
        assert str(pe.value) == str(je.value)


def test_forward_matches_jax():
    """``metric(preds, target)``: the batch's value, then the accumulated
    state's, as JAX's forward gives them."""
    preds, targets = scene(np.random.RandomState(1), n_img=6)
    port, ref = mp.MAP(device="cpu"), mt.MAP()
    assert_results_equal(port_values(port(preds[:3], targets[:3])), ref(preds[:3], targets[:3]))
    port.update(preds[3:], targets[3:])
    ref.update(preds[3:], targets[3:])
    assert len(port.detection_boxes) == 6
    assert_results_equal(port_values(port.compute()), ref.compute())


def test_exports():
    assert "MAP" in mp.__all__ and "MeanAveragePrecision" in mp.__all__
    assert mp.MAP is mp.MeanAveragePrecision is pmap.MAP
    from metrics_tpu_torch.detection import MAP

    assert MAP is mp.MAP


# ------------------------------------------------------- states across replicas and packages


def test_jax_state_carried_by_state_from_numpy():
    """A JAX ``MAP`` fed halfway, its state seated in the port's by the bridge
    (the lists stay host numpy), fed the rest by the port: equal to JAX's
    metric fed everything."""
    preds, targets = scene(np.random.RandomState(8))
    ref = run(mt, preds, targets, class_metrics=True)
    half = run(mt, preds[:5], targets[:5], class_metrics=True)
    np_state = {k: [np.asarray(x) for x in v] for k, v in half._pack_state().items()}
    port = mp.MAP(class_metrics=True, device="cpu")
    state = state_from_numpy(port, np_state, device="cpu")
    assert all(isinstance(x, np.ndarray) for v in state.values() for x in v)
    port._load_state(state)
    port.update(preds[5:], targets[5:])
    assert_results_equal(port_values(port.compute()), ref.compute())
    back = state_to_numpy(port._pack_state())
    assert len(back["detection_boxes"]) == len(preds)
    assert_results_equal(port_values(port.compute_from(back)), ref.compute())


@pytest.mark.parametrize("counts", [(2, 2, 2, 2), (0, 1, 3, 0, 2, 1, 0, 4)])
def test_merge_states_over_replicas(counts):
    """``tests/detection/test_map_ddp.py``'s merge: lists extend, image
    boundaries kept, an empty replica the identity; equal to one metric fed
    every image, and to JAX's merge of the same replicas."""
    preds, targets = scene(np.random.RandomState(9), n_img=sum(counts))
    replicas, jreplicas, lo = [], [], 0
    for c in counts:
        replicas.append(run(mp, preds[lo:lo + c], targets[lo:lo + c]) if c else mp.MAP(device="cpu"))
        jreplicas.append(run(mt, preds[lo:lo + c], targets[lo:lo + c]) if c else mt.MAP())
        lo += c
    merged = replicas[0]._pack_state()
    jmerged = jreplicas[0]._pack_state()
    for m, j in zip(replicas[1:], jreplicas[1:]):
        merged = replicas[0].merge_states(merged, m._pack_state())
        jmerged = jreplicas[0].merge_states(jmerged, j._pack_state())
    assert len(merged["detection_boxes"]) == sum(counts)
    got = port_values(replicas[0].compute_from(merged))
    assert_results_equal(got, run(mt, preds, targets).compute())
    assert_results_equal(got, jreplicas[0].compute_from(jmerged))


def test_multistream_engine_refuses_map_naming_the_ragged_engine():
    with pytest.raises(MetricsTPUUserError) as pe:
        MultiStreamEngine(mp.MAP(device="cpu"), num_streams=2, config=EngineConfig(buckets=(8,)))
    with pytest.raises(Exception) as je:
        JMulti(mt.MAP(), num_streams=2, config=JC(buckets=(8,)))
    msg = str(pe.value)
    assert "MAP" in msg and "'detection_boxes'" in msg and "'groundtruth_boxes'" in msg and "RaggedEngine" in msg
    assert msg == str(je.value).replace("metrics_tpu.engine", "metrics_tpu_torch.engine")
