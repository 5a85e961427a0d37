"""Mean Average Precision / Recall for object detection (COCO semantics).

Port of ``metrics_tpu/detection/map.py``: dict-of-tensors input validation,
the five per-image list states, per-image per-class IoU, COCO's greedy
IoU-threshold matching with area-ignore handling, the 101-point
interpolated precision, ``_summarize`` and the ``COCOMetricResults`` dict
of 12+ entries with the per-class options.

The states are STAGED ON THE HOST: ``update`` keeps numpy arrays and makes
no transfer, whatever device its inputs lie on. ``matching="device"`` (the
default): ``compute`` packs every non-empty (class, image) pair into one
padded batch on the host (vectorized: one sort of all detections and one of
all ground truths, not a call per pair), ships it to the metric's device
once, computes the IoUs and the area tests with PyTorch's elementwise ops
(JAX's ``box_iou``/``box_area``, op for op), matches with K9, the greedy
matcher (``ops/kernels/match_cuda.py``: the CUDA kernel on the card, its
plain loop on the CPU), gathers the ignore flags and brings ONE packed
uint8 bundle back. The 101-point accumulation stays host numpy
(``_pr_accumulate``, float64), read straight off the bundle's arrays per
(class, area, max_det) cell in the order the per-image evals concatenate
them. ``matching="host"`` is the per-image numpy matcher, the oracle.

The grouped hooks serve MAP through the ragged engine (an image id is a
group key); the corpus aggregate (``grouped_corpus_plan``,
``grouped_corpus_device``, ``grouped_corpus_finish``) runs K9 over every
(class, image) problem of the stacked buffers in one launch, each problem
reading its image's one IoU block through ``iou_index``.
"""
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.metric import (
    GroupedAggregateSpec,
    GroupedField,
    GroupedUpdateSpec,
    Metric,
    _squeeze_if_scalar,
)
from metrics_tpu_torch.ops.kernels.match_cuda import greedy_match

Tensor = torch.Tensor

__all__ = ["MAP", "MeanAveragePrecision", "box_area", "box_convert", "box_iou"]


class BaseMetricResults(dict):
    """Dict with attribute access. Parity: reference ``map.py:31-46``."""

    def __getattr__(self, key: str):
        if key in self:
            return self[key]
        raise AttributeError(f"No such attribute: {key}")

    def __setattr__(self, key: str, value) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        if key in self:
            del self[key]


class MAPMetricResults(BaseMetricResults):
    __slots__ = ("map", "map_50", "map_75", "map_small", "map_medium", "map_large")


class MARMetricResults(BaseMetricResults):
    __slots__ = ("mar_1", "mar_10", "mar_100", "mar_small", "mar_medium", "mar_large")


class COCOMetricResults(BaseMetricResults):
    __slots__ = (
        "map", "map_50", "map_75", "map_small", "map_medium", "map_large",
        "mar_1", "mar_10", "mar_100", "mar_small", "mar_medium", "mar_large",
        "map_per_class", "mar_100_per_class",
    )


def box_convert(boxes: Any, in_fmt: str, out_fmt: str = "xyxy") -> Tensor:
    """Convert between xyxy / xywh / cxcywh box formats (float32 ``(N, 4)``)."""
    boxes = (boxes if isinstance(boxes, Tensor) else torch.as_tensor(np.asarray(boxes))).to(torch.float32).reshape(-1, 4)
    if in_fmt == out_fmt:
        return boxes
    if in_fmt == "xywh":
        x, y, w, h = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
        return torch.stack([x, y, x + w, y + h], dim=1)
    if in_fmt == "cxcywh":
        cx, cy, w, h = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
        return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=1)
    if in_fmt == "xyxy":
        return boxes
    raise ValueError(f"Unsupported box format {in_fmt}")


def box_area(boxes: Tensor) -> Tensor:
    """Areas of ``(..., N, 4)`` xyxy boxes."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise IoU of ``(..., N, 4)`` and ``(..., M, 4)`` xyxy box sets, batched
    over leading axes: JAX's ``box_iou`` op for op (a product, a sum then a
    difference, one correctly rounded division), so the IoUs are bit-equal."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def _to_numpy(x: Any) -> np.ndarray:
    """A host array of ``x``: a tensor is read off its device, anything else
    goes through ``np.asarray``."""
    if isinstance(x, Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _input_validator(preds: Sequence[Dict[str, Any]], targets: Sequence[Dict[str, Any]]) -> None:
    """Parity: reference ``map.py:82-122``."""
    if not isinstance(preds, Sequence):
        raise ValueError("Expected argument `preds` to be of type List")
    if not isinstance(targets, Sequence):
        raise ValueError("Expected argument `target` to be of type List")
    if len(preds) != len(targets):
        raise ValueError("Expected argument `preds` and `target` to have the same length")

    for k in ("boxes", "scores", "labels"):
        if any(k not in p for p in preds):
            raise ValueError(f"Expected all dicts in `preds` to contain the `{k}` key")
    for k in ("boxes", "labels"):
        if any(k not in p for p in targets):
            raise ValueError(f"Expected all dicts in `target` to contain the `{k}` key")
    for item in targets:
        if np.shape(item["boxes"])[0] != np.shape(item["labels"])[0]:
            raise ValueError("Input boxes and labels of sample in targets have a different length")
    for item in preds:
        if not (np.shape(item["boxes"])[0] == np.shape(item["scores"])[0] == np.shape(item["labels"])[0]):
            raise ValueError("Input boxes, scores and labels of sample in predictions have a different length")


def _box_convert_np(boxes: Any, in_fmt: str) -> np.ndarray:
    """Host-side box conversion for ``update()``: the states are staged on the
    host, so per-image updates cost no device round trip."""
    boxes = np.asarray(_to_numpy(boxes), dtype=np.float32).reshape(-1, 4)
    if in_fmt == "xyxy":
        return boxes
    if in_fmt == "xywh":
        x, y, w, h = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
        return np.stack([x, y, x + w, y + h], axis=1)
    if in_fmt == "cxcywh":
        cx, cy, w, h = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
        return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=1)
    raise ValueError(f"Unsupported box format {in_fmt}")


def _bucket(n: int, mult: int) -> int:
    """Round up to a multiple of ``mult`` (the JAX package's padded shapes)."""
    return ((n + mult - 1) // mult) * mult


def _pr_accumulate(
    det_scores: np.ndarray,  # (N,) corpus det scores, image-major
    det_matches: np.ndarray,  # (T, N) bool
    det_ignore: np.ndarray,  # (T, N) bool
    npig: int,
    rec_thresholds: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The 101-point PR accumulation for ONE (class, area, max_det) cell.

    Exactly the reference inner math (``map.py:616``), float64 numpy, shared
    by ``_calculate`` (eager states) and ``grouped_corpus_finish`` (ragged
    device bundle). Inputs are the corpus-concatenated per-detection columns
    in image order; the global mergesort by descending score happens here.
    Returns ``(recall (T,), precision (T, R), scores (T, R))``.
    """
    nb_rec_thrs = len(rec_thresholds)
    inds = np.argsort(-det_scores, kind="mergesort")
    det_scores_sorted = det_scores[inds]
    det_matches = det_matches[:, inds]
    det_ignore = det_ignore[:, inds]
    tps = det_matches & ~det_ignore
    fps = ~det_matches & ~det_ignore
    tp_sum = np.cumsum(tps, axis=1, dtype=np.float64)
    fp_sum = np.cumsum(fps, axis=1, dtype=np.float64)
    nb_iou_thrs = det_matches.shape[0]
    recall_out = np.zeros(nb_iou_thrs)
    prec_out = np.zeros((nb_iou_thrs, nb_rec_thrs))
    score_out = np.zeros((nb_iou_thrs, nb_rec_thrs))
    for idx_thr, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
        nd = len(tp)
        rc = tp / npig
        pr = tp / (fp + tp + np.finfo(np.float64).eps)
        recall_out[idx_thr] = rc[-1] if nd else 0
        # remove zigzags (right-to-left running max) for AUC
        pr = np.maximum.accumulate(pr[::-1])[::-1]
        inds_rc = np.searchsorted(rc, rec_thresholds, side="left")
        prec_at = np.zeros(nb_rec_thrs)
        score_at = np.zeros(nb_rec_thrs)
        valid = inds_rc < nd
        prec_at[valid] = pr[inds_rc[valid]]
        score_at[valid] = det_scores_sorted[inds_rc[valid]]
        prec_out[idx_thr] = prec_at
        score_out[idx_thr] = score_at
    return recall_out, prec_out, score_out


def _greedy_match_single(iou: Tensor, det_valid: Tensor, gt_valid: Tensor, gt_ignore: Tensor,
                         thresholds: Tensor) -> Tuple[Tensor, Tensor]:
    """COCO greedy matching for one (image, class, area) cell, all thresholds:
    ``iou`` ``(D, G)``, ``det_valid`` ``(D,)``, ``gt_valid`` and ``gt_ignore``
    ``(G,)``, ``thresholds`` ``(T,)``. Returns ``(det_matches (T, D) bool,
    match_idx (T, D) int32, -1 = unmatched)``, through K9 (one problem, one
    area)."""
    one = torch.zeros((1,), dtype=torch.int32, device=iou.device)
    dm, mi = greedy_match(iou[None].to(torch.float32), one, det_valid[None], gt_valid[None], gt_ignore[None, None],
                          thresholds.to(torch.float32))
    return dm[0, 0].to(torch.bool), mi[0, 0]


def _pair_geometry(det_boxes: Tensor, det_valid: Tensor, gt_boxes: Tensor, gt_valid: Tensor,
                   area_ranges: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """K9's inputs of the packed pairs: the masked IoUs ``(P, D, G)``, each
    gt's area-ignore flags ``(P, A, G)`` and each det's out-of-range flags
    ``(P, A, D)``, as JAX's ``_match_all_pairs`` forms them."""
    ious = box_iou(det_boxes, gt_boxes)  # (P, D, G)
    ious = torch.where(det_valid[:, :, None] & gt_valid[:, None, :], ious, 0.0)
    gt_areas = box_area(gt_boxes)  # (P, G)
    det_areas = box_area(det_boxes)  # (P, D)
    lo, hi = area_ranges[:, 0], area_ranges[:, 1]
    gt_ign = (gt_areas[:, None, :] < lo[None, :, None]) | (gt_areas[:, None, :] > hi[None, :, None])
    det_area_out = (det_areas[:, None, :] < lo[None, :, None]) | (det_areas[:, None, :] > hi[None, :, None])
    return ious, gt_ign, det_area_out


def _match_all_pairs(
    det_boxes: Tensor,  # (P, D, 4) score-sorted
    det_valid: Tensor,  # (P, D)
    gt_boxes: Tensor,  # (P, G, 4)
    gt_valid: Tensor,  # (P, G)
    thresholds: Tensor,  # (T,)
    area_ranges: Tensor,  # (A, 2)
) -> Tensor:
    """IoU + greedy matching for every (image, class) pair and every area range.

    Returns ONE packed uint8 tensor ``(P, 2*A*T*D + A*G)``: det_matches
    ``(P, A, T, D)``, det_ignore ``(P, A, T, D)`` and gt_ignore ``(P, A, G)``
    flattened and concatenated along axis 1, so the three outputs cross to
    the host in one copy (unpacked by ``_device_eval_imgs``).
    """
    ious, gt_ign, det_area_out = _pair_geometry(det_boxes, det_valid, gt_boxes, gt_valid, area_ranges)
    p, num_t = ious.shape[0], thresholds.shape[0]
    index = torch.arange(p, dtype=torch.int32, device=ious.device)
    dm, mi = greedy_match(ious, index, det_valid, gt_valid, gt_ign, thresholds)  # (P, A, T, D)
    # det_ignore: matched an area-ignored gt, or unmatched and outside the range
    gt_ign_b = gt_ign[:, :, None, :].expand(gt_ign.shape[:2] + (num_t, gt_ign.shape[2]))
    matched_gt_ign = torch.gather(gt_ign_b, 3, mi.clamp(min=0).to(torch.int64))
    det_ignore = torch.where(dm.to(torch.bool), matched_gt_ign, det_area_out[:, :, None, :])
    gt_ign_valid = gt_ign & gt_valid[:, None, :]
    return torch.cat([dm.reshape(p, -1), det_ignore.to(torch.uint8).reshape(p, -1),
                      gt_ign_valid.to(torch.uint8).reshape(p, -1)], dim=1)


class CorpusProblems(NamedTuple):
    """The corpus aggregate's problems before the match (``C`` padded
    classes, ``G`` images of ``cap`` rows, ``A`` area ranges)."""

    match_args: Tuple[Tensor, ...]  # K9's (iou, iou_index, det_valid, gt_valid, gt_ignore, thresholds)
    scores: Tensor  # (G, cap) det scores, each image's rows sorted by descending score
    active: Tensor  # (C, G, cap) in-class dets within the largest max_det, sorted order
    rank: Tensor  # (C, G, cap) int32 1-based in-class rank, sorted order
    det_c: Tensor  # (C, G, cap) in-class dets, sorted order
    gt_c: Tensor  # (C, G, cap) in-class gts, ingest order
    gt_area_out: Tensor  # (G, A, cap) gt area-ignore flags, ingest order
    det_area_out: Tensor  # (G, A, cap) det out-of-range flags, sorted order


class PackedPairs(NamedTuple):
    """The host-packed batch of non-empty (class, image) pairs, class-major
    then image order (JAX's ``pairs`` list with the empty pairs dropped):
    ``rows`` live rows of ``(n_rows, ...)`` arrays padded to buckets of 64
    rows and 8 detections / ground truths."""

    det_boxes: np.ndarray  # (n_rows, D, 4) f32, each pair's dets score-sorted
    det_scores: np.ndarray  # (n_rows, D) f32
    det_valid: np.ndarray  # (n_rows, D) bool
    gt_boxes: np.ndarray  # (n_rows, G, 4) f32
    gt_valid: np.ndarray  # (n_rows, G) bool
    nd: np.ndarray  # (rows,) dets a pair (at most the largest max_det)
    ng: np.ndarray  # (rows,) gts a pair
    row_class: np.ndarray  # (rows,) class index of each pair
    rows: int


class DeviceEvals(NamedTuple):
    """The host view of the one packed bundle ``_match_all_pairs`` returns."""

    pairs: PackedPairs
    dm: np.ndarray  # (rows, A, T, D) bool
    det_ignore: np.ndarray  # (rows, A, T, D) bool
    gt_ign: np.ndarray  # (rows, A, G) bool


def _flat(parts: List[np.ndarray], dtype: Any, trailing: Tuple[int, ...] = ()) -> Tuple[np.ndarray, np.ndarray]:
    """``parts`` concatenated, and each row's part index."""
    sizes = np.asarray([len(x) for x in parts], np.int64)
    if not parts or int(sizes.sum()) == 0:
        return np.zeros((0,) + trailing, dtype), np.zeros(0, np.int64)
    flat = np.concatenate([np.asarray(x, dtype).reshape((-1,) + trailing) for x in parts])
    return flat, np.repeat(np.arange(len(parts), dtype=np.int64), sizes)


def _class_index(labels: np.ndarray, classes: np.ndarray) -> np.ndarray:
    """The position of each label in the sorted ``classes``, -1 where it
    equals none (the per-pair filter's ``labels == class_id``)."""
    if classes.size == 0 or labels.size == 0:
        return -np.ones(labels.shape, np.int64)
    pos = np.minimum(np.searchsorted(classes, labels), classes.size - 1)
    return np.where(classes[pos] == labels, pos, -1)


def _rank_in_runs(keys: np.ndarray) -> np.ndarray:
    """Each element's offset in its run of equal ``keys`` (``keys`` sorted)."""
    n = keys.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    start = np.ones(n, bool)
    start[1:] = keys[1:] != keys[:-1]
    pos = np.arange(n)
    return pos - np.maximum.accumulate(np.where(start, pos, 0))


class MAP(Metric):
    """COCO mean average precision/recall for object detection.

    ``device`` is where ``compute`` matches (the card by default); the states
    stay on the host whatever it is.
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        matching: str = "device",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        if matching not in ("device", "host"):
            raise ValueError("Expected argument `matching` to be 'device' or 'host'")
        self.matching = matching
        self.box_format = box_format
        self.iou_thresholds = list(iou_thresholds) if iou_thresholds is not None else list(
            np.round(np.arange(0.5, 1.0, 0.05), 2)
        )
        self.rec_thresholds = list(rec_thresholds) if rec_thresholds is not None else list(
            np.round(np.linspace(0.0, 1.00, int(np.round((1.00 - 0.0) / 0.01)) + 1), 2)
        )
        self.max_detection_thresholds = sorted(max_detection_thresholds or [1, 10, 100])
        self.bbox_area_ranges = OrderedDict(
            all=(0.0, 1e10),
            small=(0.0, 32.0 ** 2),
            medium=(32.0 ** 2, 96.0 ** 2),
            large=(96.0 ** 2, 1e10),
        )
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics

        self.add_state("detection_boxes", default=[], dist_reduce_fx=None)
        self.add_state("detection_scores", default=[], dist_reduce_fx=None)
        self.add_state("detection_labels", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_boxes", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_labels", default=[], dist_reduce_fx=None)

    #: the list states hold numpy arrays on the host (``update`` moves nothing)
    _host_list_states = ("detection_boxes", "detection_scores", "detection_labels", "groundtruth_boxes",
                         "groundtruth_labels")

    def _inner_update(self, *args: Any, **kwargs: Any) -> None:
        """The subclass update on the inputs as given: the states are staged on
        the host, so nothing moves to the metric's device."""
        type(self).update(self, *args, **kwargs)

    def update(self, preds: List[Dict[str, Any]], target: List[Dict[str, Any]]) -> None:
        """Add one batch of per-image detection/groundtruth dicts."""
        _input_validator(preds, target)
        for item in preds:
            self.detection_boxes.append(_box_convert_np(item["boxes"], self.box_format))
            self.detection_labels.append(np.ravel(_to_numpy(item["labels"])))
            self.detection_scores.append(np.ravel(_to_numpy(item["scores"])))
        for item in target:
            self.groundtruth_boxes.append(_box_convert_np(item["boxes"], self.box_format))
            self.groundtruth_labels.append(np.ravel(_to_numpy(item["labels"])))

    # ------------------------------------------------------------ ragged serving
    #
    # An image id IS a group key: detection rows (boxes) and groundtruth rows
    # share one per-image capacity buffer, discriminated by an ``is_gt`` flag
    # column. Eager ``update`` identifies images positionally (every call
    # appends new images); ragged ingestion accumulates rows under an explicit
    # image id across calls.

    # per-image row budget (dets + gts share it); override the attribute or
    # pass capacity= to RaggedEngine for denser scenes
    grouped_capacity: int = 128

    def grouped_update_spec(self) -> Optional[GroupedUpdateSpec]:
        return GroupedUpdateSpec(
            fields=(
                GroupedField("box", (4,), torch.float32),
                GroupedField("score", (), torch.float32),
                GroupedField("label", (), torch.int32),
                GroupedField("is_gt", (), torch.int32),
            ),
            capacity=int(self.grouped_capacity),
        )

    def grouped_encode(
        self,
        preds: List[Dict[str, Any]],
        target: List[Dict[str, Any]],
        image_ids: Sequence[int],
    ) -> Tuple[Any, ...]:
        """Flatten one eager ``update`` call to per-row arrays keyed by image
        id: each image contributes its detection rows (xyxy box, score, label,
        is_gt=0) then its groundtruth rows (xyxy box, score 0, label, is_gt=1),
        validated exactly like ``update``."""
        _input_validator(preds, target)
        if len(image_ids) != len(preds):
            raise ValueError(
                "Expected `image_ids` to list one group key per image "
                f"(got {len(image_ids)} ids for {len(preds)} images)"
            )
        gids: List[np.ndarray] = []
        boxes: List[np.ndarray] = []
        scores: List[np.ndarray] = []
        labels: List[np.ndarray] = []
        is_gt: List[np.ndarray] = []
        for gid, p, t in zip(image_ids, preds, target):
            db = _box_convert_np(p["boxes"], self.box_format)
            gb = _box_convert_np(t["boxes"], self.box_format)
            nd, ng = db.shape[0], gb.shape[0]
            gids.append(np.full(nd + ng, int(gid), np.int32))
            boxes.append(db)
            boxes.append(gb)
            scores.append(np.ravel(_to_numpy(p["scores"])).astype(np.float32))
            scores.append(np.zeros(ng, np.float32))
            labels.append(np.ravel(_to_numpy(p["labels"])).astype(np.int32))
            labels.append(np.ravel(_to_numpy(t["labels"])).astype(np.int32))
            is_gt.append(np.zeros(nd, np.int32))
            is_gt.append(np.ones(ng, np.int32))
        return (
            np.concatenate(gids) if gids else np.zeros(0, np.int32),
            np.concatenate(boxes) if boxes else np.zeros((0, 4), np.float32),
            np.concatenate(scores) if scores else np.zeros(0, np.float32),
            np.concatenate(labels) if labels else np.zeros(0, np.int32),
            np.concatenate(is_gt) if is_gt else np.zeros(0, np.int32),
        )

    def grouped_group_value(self, fields: Dict[str, Tensor], count: Tensor, capacity: int) -> Dict[str, Tensor]:
        """The per-image occupancy read (``result(image_id)``, batched over a
        leading group axis for ``results()``): detection and groundtruth row
        counts in the image's buffer. The COCO value itself is corpus-level,
        so the per-group read reports the ingested shape, not a per-image AP."""
        count = torch.as_tensor(count).to(torch.int32)
        valid = torch.arange(capacity, device=count.device) < torch.clamp_max(count, capacity)[..., None]
        gt = fields["is_gt"].to(torch.int32) == 1
        return {
            "detections": (valid & ~gt).sum(dim=-1, dtype=torch.int32),
            "groundtruths": (valid & gt).sum(dim=-1, dtype=torch.int32),
        }

    def grouped_finalize(
        self,
        counts: np.ndarray,
        fields: Dict[str, np.ndarray],
        group_ids: np.ndarray,
    ) -> Dict[str, Any]:
        """Rebuild the five eager list states from reconstructed per-image
        rows, one entry per non-empty image in image-id order (rows keep
        submission order per image; ``is_gt`` splits the shared buffer).
        Images with no rows contribute nothing, as the eager no-op an empty
        image is."""
        counts = np.asarray(counts)
        state: Dict[str, List[np.ndarray]] = {name: [] for name in self._host_list_states}
        for gid in np.asarray(group_ids):
            c = int(counts[gid])
            if c == 0:
                continue
            gt = np.asarray(fields["is_gt"][gid][:c]) == 1
            box = np.asarray(fields["box"][gid][:c], np.float32)
            state["detection_boxes"].append(box[~gt])
            state["detection_scores"].append(np.asarray(fields["score"][gid][:c], np.float32)[~gt])
            state["detection_labels"].append(np.asarray(fields["label"][gid][:c], np.int32)[~gt])
            state["groundtruth_boxes"].append(box[gt])
            state["groundtruth_labels"].append(np.asarray(fields["label"][gid][:c], np.int32)[gt])
        return state

    # ---------------------------------------------------------- corpus aggregate
    #
    # COCO's aggregate is corpus-level (global score ranking, class axes), so
    # the ragged engine's per-group fold does not apply. The metric plans the
    # device pass off host-cheap vectors (counts and the label buffer), one
    # device pass computes greedy matches for every (image, class, area,
    # threshold) cell straight from the stacked (G, capacity) buffers, one
    # copy ships the match bundle, and the host keeps only the PR
    # interpolation.

    def grouped_aggregate_spec(self) -> Optional[GroupedAggregateSpec]:
        if self.matching != "device":
            return None  # the host matcher is the oracle; replay eagerly
        return GroupedAggregateSpec(kind="corpus")

    def grouped_corpus_scan_fields(self) -> Tuple[str, ...]:
        """Buffers the host plan needs: the class universe comes from the
        label column (dets and gts both contribute, as ``_get_classes``)."""
        return ("label",)

    def grouped_corpus_plan(self, counts: np.ndarray, scan: Dict[str, np.ndarray]) -> Optional[Dict[str, Any]]:
        """Host-side plan for the device pass: the distinct-label class list
        (padded to a bucket of 4) and a device-memory budget check. ``None``
        declines (empty corpus, or a match bundle past 2^26 elements) and the
        engine reroutes to the host oracle."""
        counts = np.asarray(counts)
        label = np.asarray(scan["label"])
        num_groups, cap = label.shape
        valid = np.arange(cap)[None, :] < np.minimum(counts, cap)[:, None]
        labels = label[valid]
        if labels.size == 0:
            return None
        classes = np.unique(labels).astype(np.int32)  # unique() sorts
        c_pad = _bucket(int(classes.size), 4)
        nb_areas = len(self.bbox_area_ranges)
        nb_thrs = len(self.iou_thresholds)
        footprint = max(
            num_groups * c_pad * nb_areas * nb_thrs * cap,  # match bundle
            num_groups * cap * cap,  # per-image IoU block
        )
        if footprint > (1 << 26):
            return None
        classes_padded = np.zeros(c_pad, np.int32)
        classes_padded[: classes.size] = classes
        return {
            "classes_padded": classes_padded,
            "n_classes": int(classes.size),
            "c_pad": c_pad,
        }

    def grouped_corpus_device(
        self,
        counts: Tensor,
        fields: Dict[str, Tensor],
        classes: Tensor,
        cls_valid: Tensor,
        capacity: int,
    ) -> Dict[str, Tensor]:
        """The corpus match bundle from the stacked ragged buffers, on their
        device.

        Per image: one stable descending-score sort of the det rows (gt and
        pad rows sink; a score of 0 negates to -0.0, which the sort key folds
        into +0.0, so every tie keeps ingest order as XLA's comparison sort
        does) and one ``(capacity, capacity)`` IoU block against the
        ORIGINAL-order rows; per class: validity masks and in-class ranks
        over the shared sort, then K9 over the ``C * G`` (class, image)
        problems in one launch, problem ``(c, g)`` reading block ``g``.
        Returns (all to cross in one copy):

        * ``scores`` ``(G*cap,)``: sorted det scores, image-major;
        * ``det_valid`` / ``rank`` ``(C, G*cap)``: class membership and
          1-based in-class rank (the ``max_det`` slice is a host ``rank <= m``);
        * ``dm`` / ``dign`` ``(C, A, T, G*cap)``: match and ignore flags;
        * ``npig`` ``(C, A)``: non-area-ignored gt totals;
        * ``n_gt`` / ``n_det`` ``(C,)``: the eval-exists guard.
        """
        pr = self._corpus_problems(counts, fields, classes, cls_valid, capacity)
        dm, mi = greedy_match(*pr.match_args)
        c_pad, n_img, nb_areas, cap = pr.gt_c.shape[0], pr.gt_c.shape[1], pr.gt_area_out.shape[1], pr.gt_c.shape[2]
        shape5 = (c_pad, n_img, nb_areas, pr.match_args[5].shape[0], cap)
        dm, mi = dm.reshape(shape5), mi.reshape(shape5)
        gt_ign_b = pr.gt_area_out[None, :, :, None, :].expand(shape5)
        matched_gt_ign = torch.gather(gt_ign_b, 4, mi.clamp(min=0).to(torch.int64))
        dign = torch.where(dm.to(torch.bool), matched_gt_ign, pr.det_area_out[None, :, :, None, :])
        npig = (pr.gt_c[:, :, None, :] & ~pr.gt_area_out[None]).sum(dim=(1, 3), dtype=torch.int32)  # (C, A)
        image_major = shape5[:1] + shape5[2:4] + (n_img * cap,)
        return {
            "scores": pr.scores.reshape(-1),
            "det_valid": pr.active.reshape(c_pad, -1).to(torch.uint8),
            "rank": pr.rank.reshape(c_pad, -1),
            "dm": dm.permute(0, 2, 3, 1, 4).reshape(image_major),
            "dign": dign.permute(0, 2, 3, 1, 4).to(torch.uint8).reshape(image_major),
            "npig": npig,
            "n_gt": pr.gt_c.sum(dim=(1, 2), dtype=torch.int32),
            "n_det": pr.det_c.sum(dim=(1, 2), dtype=torch.int32),
        }

    def _corpus_problems(self, counts: Tensor, fields: Dict[str, Tensor], classes: Tensor, cls_valid: Tensor,
                         capacity: int) -> "CorpusProblems":
        """Everything of ``grouped_corpus_device`` before the match: the
        per-image sort, the IoU blocks, the area tests, the class masks and
        ranks, and K9's arguments over the ``C * G`` problems."""
        cap = int(capacity)
        box = fields["box"].to(torch.float32)  # (G, cap, 4)
        dev = box.device
        counts = counts.to(device=dev, dtype=torch.int32)
        score = fields["score"].to(torch.float32)  # (G, cap)
        label = fields["label"].to(torch.int32)
        is_gt = fields["is_gt"].to(torch.int32) == 1
        valid = torch.arange(cap, device=dev)[None, :] < torch.clamp_max(counts, cap)[:, None]
        det_row = valid & ~is_gt
        gt_row = valid & is_gt

        key = torch.where(det_row, -score, float("inf")) + 0.0  # -0.0 + 0.0 is +0.0: one zero for the sort
        order = torch.argsort(key, dim=1, stable=True)
        s_score = torch.gather(score, 1, order)
        s_label = torch.gather(label, 1, order)
        s_det = torch.gather(det_row, 1, order)
        s_box = torch.gather(box, 1, order[..., None].expand(box.shape))

        ious = box_iou(s_box, box)  # (G, cap det, cap gt)

        thresholds = torch.tensor(self.iou_thresholds, dtype=torch.float32, device=dev)  # (T,)
        area_ranges = torch.tensor([list(r) for r in self.bbox_area_ranges.values()], dtype=torch.float32,
                                   device=dev)  # (A, 2)
        lo, hi = area_ranges[:, 0], area_ranges[:, 1]
        gt_areas = box_area(box)  # (G, cap) original order
        det_areas = box_area(s_box)  # (G, cap) sorted order
        gt_area_out = (gt_areas[:, None, :] < lo[None, :, None]) | (gt_areas[:, None, :] > hi[None, :, None])
        det_area_out = (det_areas[:, None, :] < lo[None, :, None]) | (det_areas[:, None, :] > hi[None, :, None])
        max_det = int(self.max_detection_thresholds[-1])

        classes = classes.to(device=dev, dtype=torch.int32)[:, None, None]  # (C, 1, 1)
        cvalid = cls_valid.to(device=dev, dtype=torch.bool)[:, None, None]
        det_c = s_det[None] & (s_label[None] == classes) & cvalid  # (C, G, cap)
        rank = torch.cumsum(det_c.to(torch.int32), dim=2, dtype=torch.int32)  # 1-based where det_c
        active = det_c & (rank <= max_det)
        gt_c = gt_row[None] & (label[None] == classes) & cvalid  # (C, G, cap) original order

        c_pad, n_img = det_c.shape[:2]
        nb_areas = area_ranges.shape[0]
        problems = c_pad * n_img
        index = (torch.arange(problems, device=dev) % n_img).to(torch.int32)  # problem (c, g) reads block g
        gt_ign = gt_area_out[None].expand(c_pad, n_img, nb_areas, cap).reshape(problems, nb_areas, cap)
        return CorpusProblems(
            match_args=(ious, index, active.reshape(problems, cap), gt_c.reshape(problems, cap), gt_ign, thresholds),
            scores=s_score, active=active, rank=rank, det_c=det_c, gt_c=gt_c, gt_area_out=gt_area_out,
            det_area_out=det_area_out,
        )

    def grouped_corpus_finish(self, bundle: Dict[str, np.ndarray], plan: Dict[str, Any]) -> dict:
        """Host finish of the device bundle: per (class, area, max_det) the
        ``rank <= m`` mask selects the eval's detections and the SAME
        ``_pr_accumulate`` / ``_results_from_tensors`` / ``_finish_compute``
        helpers the eager path runs produce the ``COCOMetricResults``."""
        nb_classes = int(plan["n_classes"])
        scores = np.asarray(bundle["scores"])
        det_valid = np.asarray(bundle["det_valid"]).view(bool)  # 0/1 bytes: a view, no copy
        rank = np.asarray(bundle["rank"])
        dm = np.asarray(bundle["dm"]).view(bool)
        dign = np.asarray(bundle["dign"]).view(bool)
        npig = np.asarray(bundle["npig"])
        n_gt = np.asarray(bundle["n_gt"])
        n_det = np.asarray(bundle["n_det"])

        def cells() -> Iterator[Tuple[Any, ...]]:
            for idx_cls in range(nb_classes):
                if n_gt[idx_cls] == 0 and n_det[idx_cls] == 0:
                    continue  # no (image, class) eval exists: its cells stay -1
                cols = np.flatnonzero(det_valid[idx_cls])  # the class's detections, in image-major order
                cls_rank = rank[idx_cls, cols]
                for idx_area in range(len(self.bbox_area_ranges)):
                    if int(npig[idx_cls, idx_area]) == 0:
                        continue
                    cls_dm, cls_dign = dm[idx_cls, idx_area][:, cols], dign[idx_cls, idx_area][:, cols]
                    for idx_mdet, max_det in enumerate(self.max_detection_thresholds):
                        sel = cls_rank <= max_det
                        yield (idx_cls, idx_area, idx_mdet, scores[cols[sel]], cls_dm[:, sel], cls_dign[:, sel],
                               int(npig[idx_cls, idx_area]))

        overall, map_metrics, mar_metrics = self._accumulate(cells(), nb_classes)
        # the eager path returns through compute's scalar squeeze: the same
        # normalization gives both reads identical leaves
        return _squeeze_if_scalar(self._finish_compute(overall, map_metrics, mar_metrics, nb_classes))

    # ------------------------------------------------------------------ internals

    def _get_classes(self) -> List[int]:
        if len(self.detection_labels) > 0 or len(self.groundtruth_labels) > 0:
            all_labels = np.concatenate([np.asarray(x) for x in (self.detection_labels + self.groundtruth_labels)])
            return sorted(set(int(x) for x in all_labels))
        return []

    def _img_class_arrays(self, idx: int, class_id: int, max_det: int):
        """Per-image per-class (gt, det, scores) sorted the COCO way (numpy)."""
        gt = np.asarray(self.groundtruth_boxes[idx])
        det = np.asarray(self.detection_boxes[idx])
        gt_mask = np.asarray(self.groundtruth_labels[idx]) == class_id
        det_mask = np.asarray(self.detection_labels[idx]) == class_id
        gt = gt[gt_mask]
        det = det[det_mask]
        scores = np.asarray(self.detection_scores[idx])[det_mask]
        dtind = np.argsort(-scores, kind="stable")[:max_det]
        return gt, det[dtind], scores[dtind]

    def _evaluate_image(
        self, idx: int, class_id: int, area_range: Tuple[float, float], max_det: int, ious: Dict
    ) -> Optional[Dict]:
        """Greedy matching for one (image, class). Parity: reference ``:378-451``."""
        gt, det, scores_sorted = self._img_class_arrays(idx, class_id, max_det)
        if len(gt) == 0 and len(det) == 0:
            return None

        gt2 = np.asarray(gt).reshape(-1, 4)
        areas = (gt2[:, 2] - gt2[:, 0]) * (gt2[:, 3] - gt2[:, 1]) if len(gt) else np.zeros(0)
        ignore_area = (areas < area_range[0]) | (areas > area_range[1])
        gtind = np.argsort(ignore_area.astype(np.uint8), kind="stable")  # ignored gts last
        gt = gt[gtind]
        gt_ignore = ignore_area[gtind]

        iou_mat = ious[(idx, class_id)]
        iou_mat = iou_mat[:, gtind] if iou_mat.size else iou_mat

        nb_iou_thrs = len(self.iou_thresholds)
        nb_gt, nb_det = len(gt), len(det)
        gt_matches = np.zeros((nb_iou_thrs, nb_gt), dtype=bool)
        det_matches = np.zeros((nb_iou_thrs, nb_det), dtype=bool)
        det_ignore = np.zeros((nb_iou_thrs, nb_det), dtype=bool)

        if iou_mat.size > 0:
            for idx_iou, thr in enumerate(self.iou_thresholds):
                for idx_det in range(nb_det):
                    best_iou = min(thr, 1 - 1e-10)
                    match_id = -1
                    for idx_gt in range(nb_gt):
                        if gt_matches[idx_iou, idx_gt]:
                            continue
                        # once matched to a regular gt, never trade down to an ignored one
                        if match_id > -1 and not gt_ignore[match_id] and gt_ignore[idx_gt]:
                            break
                        if iou_mat[idx_det, idx_gt] < best_iou:
                            continue
                        best_iou = iou_mat[idx_det, idx_gt]
                        match_id = idx_gt
                    if match_id != -1:
                        det_ignore[idx_iou, idx_det] = gt_ignore[match_id]
                        det_matches[idx_iou, idx_det] = True
                        gt_matches[idx_iou, match_id] = True

        # unmatched detections outside the area range are ignored
        det2 = np.asarray(det).reshape(-1, 4)
        det_areas = (det2[:, 2] - det2[:, 0]) * (det2[:, 3] - det2[:, 1]) if nb_det else np.zeros(0)
        det_ignore_area = (det_areas < area_range[0]) | (det_areas > area_range[1])
        det_ignore = det_ignore | (~det_matches & det_ignore_area[None, :])

        return {
            "dtMatches": det_matches,
            "gtMatches": gt_matches,
            "dtScores": scores_sorted,
            "gtIgnore": gt_ignore,
            "dtIgnore": det_ignore,
        }

    def _summarize(
        self,
        results: Dict,
        avg_prec: bool = True,
        iou_threshold: Optional[float] = None,
        area_range: str = "all",
        max_dets: int = 100,
    ) -> np.float32:
        area_idx = list(self.bbox_area_ranges.keys()).index(area_range)
        mdet_idx = self.max_detection_thresholds.index(max_dets)
        if avg_prec:
            prec = results["precision"]
            if iou_threshold is not None:
                thr = self.iou_thresholds.index(iou_threshold)
                prec = prec[thr:thr + 1]
            prec = prec[:, :, :, area_idx, mdet_idx]
        else:
            prec = results["recall"]
            if iou_threshold is not None:
                thr = self.iou_thresholds.index(iou_threshold)
                prec = prec[thr:thr + 1]
            prec = prec[:, :, area_idx, mdet_idx]
        valid = prec[prec > -1]
        return np.float32(-1.0) if valid.size == 0 else np.float32(float(np.mean(valid)))

    def _pack_pairs(self, class_ids: List[int], max_detections: int) -> PackedPairs:
        """Every non-empty (class, image) pair's dets and gts, padded into one
        batch on the host.

        The same arrays as ``_img_class_arrays`` per pair (dets of a pair by
        descending score, ties in input order, cut at ``max_detections``; gts
        in input order), built from two sorts over all the corpus's rows
        instead of a call per pair: the detections sort by (class, image,
        -score) with numpy's stable ``lexsort``, the ground truths by
        (class, image)."""
        n_img = len(self.groundtruth_boxes)
        classes = np.asarray(class_ids)
        d_box, d_img = _flat(self.detection_boxes, np.float32, (4,))
        d_score, _ = _flat(self.detection_scores, np.float32)
        d_lab, _ = _flat([np.asarray(x) for x in self.detection_labels], None)
        g_box, g_img = _flat(self.groundtruth_boxes, np.float32, (4,))
        g_lab, _ = _flat([np.asarray(x) for x in self.groundtruth_labels], None)

        d_cls = _class_index(d_lab, classes)
        keep = d_cls >= 0
        d_key = d_cls[keep] * n_img + d_img[keep]
        d_box, d_score = d_box[keep], d_score[keep]
        order = np.lexsort((-d_score, d_key))  # stable: equal scores keep input order
        d_key, d_box, d_score = d_key[order], d_box[order], d_score[order]
        d_rank = _rank_in_runs(d_key)
        kept = d_rank < max_detections
        d_key, d_box, d_score, d_rank = d_key[kept], d_box[kept], d_score[kept], d_rank[kept]

        g_cls = _class_index(g_lab, classes)
        keep = g_cls >= 0
        g_key = g_cls[keep] * n_img + g_img[keep]
        g_box = g_box[keep]
        order = np.argsort(g_key, kind="stable")
        g_key, g_box = g_key[order], g_box[order]
        g_rank = _rank_in_runs(g_key)

        keys = np.union1d(d_key, g_key).astype(np.int64)  # sorted: class-major, then image
        rows = keys.shape[0]
        d_row = np.searchsorted(keys, d_key)
        g_row = np.searchsorted(keys, g_key)
        nd = np.bincount(d_row, minlength=rows).astype(np.int64)
        ng = np.bincount(g_row, minlength=rows).astype(np.int64)
        # bucketed padded dims, as the JAX package's (the valid masks and the
        # row map ignore the padding)
        dim_d = _bucket(max(1, int(nd.max(initial=0))), 8)
        dim_g = _bucket(max(1, int(ng.max(initial=0))), 8)
        n_rows = _bucket(max(1, rows), 64)
        det_boxes = np.zeros((n_rows, dim_d, 4), np.float32)
        det_scores = np.zeros((n_rows, dim_d), np.float32)
        gt_boxes = np.zeros((n_rows, dim_g, 4), np.float32)
        det_boxes[d_row, d_rank] = d_box
        det_scores[d_row, d_rank] = d_score
        gt_boxes[g_row, g_rank] = g_box
        nd_padded = np.zeros(n_rows, np.int64)
        nd_padded[:rows] = nd
        ng_padded = np.zeros(n_rows, np.int64)
        ng_padded[:rows] = ng
        return PackedPairs(
            det_boxes=det_boxes,
            det_scores=det_scores,
            det_valid=np.arange(dim_d)[None, :] < nd_padded[:, None],
            gt_boxes=gt_boxes,
            gt_valid=np.arange(dim_g)[None, :] < ng_padded[:, None],
            nd=nd,
            ng=ng,
            row_class=keys // max(n_img, 1),
            rows=rows,
        )

    def _upload_pairs(self, pairs: PackedPairs) -> Tuple[Tensor, ...]:
        """``_match_all_pairs``' arguments on the metric's device: the packed
        pairs, the thresholds and the area ranges."""
        dev = self.device
        return (
            torch.from_numpy(pairs.det_boxes).to(dev),
            torch.from_numpy(pairs.det_valid).to(dev),
            torch.from_numpy(pairs.gt_boxes).to(dev),
            torch.from_numpy(pairs.gt_valid).to(dev),
            torch.tensor(self.iou_thresholds, dtype=torch.float32, device=dev),
            torch.tensor([list(r) for r in self.bbox_area_ranges.values()], dtype=torch.float32, device=dev),
        )

    def _unpack_evals(self, pairs: PackedPairs, packed: np.ndarray) -> DeviceEvals:
        """The host bundle ``packed`` ``(rows, 2*A*T*D + A*G)`` split into its
        three flag arrays."""
        nb_areas, num_t = len(self.bbox_area_ranges), len(self.iou_thresholds)
        dim_d, dim_g = pairs.det_boxes.shape[1], pairs.gt_boxes.shape[1]
        sz_d = nb_areas * num_t * dim_d
        flags = packed.view(bool)  # 0/1 bytes: views, no copies
        return DeviceEvals(
            pairs=pairs,
            dm=flags[:, :sz_d].reshape(-1, nb_areas, num_t, dim_d),
            det_ignore=flags[:, sz_d:2 * sz_d].reshape(-1, nb_areas, num_t, dim_d),
            gt_ign=flags[:, 2 * sz_d:].reshape(-1, nb_areas, dim_g),
        )

    def _device_eval_imgs(self, class_ids: List[int], max_detections: int) -> DeviceEvals:
        """All (image, class) matching in one device pass and ONE copy back:
        host packing, ``_match_all_pairs``, the bundle's copy, its unpacking."""
        pairs = self._pack_pairs(class_ids, max_detections)
        packed = _match_all_pairs(*self._upload_pairs(pairs))[: pairs.rows]  # pad rows dropped on the device
        return self._unpack_evals(pairs, packed.cpu().numpy())

    def _device_cells(self, ev: DeviceEvals, nb_classes: int) -> Iterator[Tuple[Any, ...]]:
        """The PR inputs of every (class, area, max_det) cell off the device
        bundle: a class's pairs are contiguous rows in image order, so each
        cell's columns are one boolean selection, in the order the per-image
        evals concatenate (``dtMatches[:, :max_det]`` image after image)."""
        pairs = ev.pairs
        bounds = np.searchsorted(pairs.row_class, np.arange(nb_classes + 1))
        dim_d, dim_g = pairs.det_boxes.shape[1], pairs.gt_boxes.shape[1]
        for idx_cls in range(nb_classes):
            lo, hi = int(bounds[idx_cls]), int(bounds[idx_cls + 1])
            if lo == hi:
                continue  # no eval exists: its cells stay -1
            gvalid = np.arange(dim_g)[None, :] < pairs.ng[lo:hi, None]
            scores = pairs.det_scores[lo:hi]
            for idx_area in range(len(self.bbox_area_ranges)):
                npig = int(np.count_nonzero(gvalid & ~ev.gt_ign[lo:hi, idx_area]))
                if npig == 0:
                    continue
                dm = ev.dm[lo:hi, idx_area].transpose(1, 0, 2)  # (T, rows, D)
                dign = ev.det_ignore[lo:hi, idx_area].transpose(1, 0, 2)
                for idx_mdet, max_det in enumerate(self.max_detection_thresholds):
                    sel = np.arange(dim_d)[None, :] < np.minimum(pairs.nd[lo:hi], max_det)[:, None]
                    yield idx_cls, idx_area, idx_mdet, scores[sel], dm[:, sel], dign[:, sel], npig

    def _host_cells(self, class_ids: List[int], max_detections: int) -> Iterator[Tuple[Any, ...]]:
        """The host oracle: per-image IoU on the CPU and the reference's python
        greedy loop (``_evaluate_image``), then each cell's concatenation."""
        img_ids = list(range(len(self.groundtruth_boxes)))
        area_ranges = list(self.bbox_area_ranges.values())
        ious = {}
        for idx in img_ids:
            for class_id in class_ids:
                gt, det, _ = self._img_class_arrays(idx, class_id, max_detections)
                if len(gt) and len(det):
                    ious[(idx, class_id)] = box_iou(torch.from_numpy(np.asarray(det, np.float32).reshape(-1, 4)),
                                                    torch.from_numpy(np.asarray(gt, np.float32).reshape(-1, 4))).numpy()
                else:
                    ious[(idx, class_id)] = np.zeros((len(det), len(gt)))
        eval_imgs = [
            self._evaluate_image(img_id, class_id, area, max_detections, ious)
            for class_id in class_ids
            for area in area_ranges
            for img_id in img_ids
        ]
        nb_imgs = len(img_ids)
        nb_bbox_areas = len(area_ranges)
        for idx_cls in range(len(class_ids)):
            for idx_area in range(nb_bbox_areas):
                for idx_mdet, max_det in enumerate(self.max_detection_thresholds):
                    base = idx_cls * nb_bbox_areas * nb_imgs + idx_area * nb_imgs
                    evals = [e for e in eval_imgs[base:base + nb_imgs] if e is not None]
                    if not evals:
                        continue
                    gt_ignore = np.concatenate([e["gtIgnore"] for e in evals])
                    npig = int(np.count_nonzero(~gt_ignore))
                    if npig == 0:
                        continue
                    yield (idx_cls, idx_area, idx_mdet,
                           np.concatenate([e["dtScores"][:max_det] for e in evals]),
                           np.concatenate([e["dtMatches"][:, :max_det] for e in evals], axis=1),
                           np.concatenate([e["dtIgnore"][:, :max_det] for e in evals], axis=1),
                           npig)

    def _accumulate(self, cells: Iterator[Tuple[Any, ...]],
                    nb_classes: int) -> Tuple[Dict, MAPMetricResults, MARMetricResults]:
        """``_pr_accumulate`` over every cell ``cells`` yields; the cells it
        skips stay -1."""
        nb_iou_thrs = len(self.iou_thresholds)
        nb_rec_thrs = len(self.rec_thresholds)
        nb_bbox_areas = len(self.bbox_area_ranges)
        nb_max_det_thrs = len(self.max_detection_thresholds)
        precision = -np.ones((nb_iou_thrs, nb_rec_thrs, nb_classes, nb_bbox_areas, nb_max_det_thrs))
        recall = -np.ones((nb_iou_thrs, nb_classes, nb_bbox_areas, nb_max_det_thrs))
        scores = -np.ones((nb_iou_thrs, nb_rec_thrs, nb_classes, nb_bbox_areas, nb_max_det_thrs))
        rec_thresholds = np.asarray(self.rec_thresholds)
        for idx_cls, idx_area, idx_mdet, det_scores, det_matches, det_ignore, npig in cells:
            rec_t, prec_t, score_t = _pr_accumulate(det_scores, det_matches, det_ignore, npig, rec_thresholds)
            recall[:, idx_cls, idx_area, idx_mdet] = rec_t
            precision[:, :, idx_cls, idx_area, idx_mdet] = prec_t
            scores[:, :, idx_cls, idx_area, idx_mdet] = score_t
        return self._results_from_tensors(precision, recall, scores, nb_classes)

    def _calculate(self, class_ids: List[int]) -> Tuple[Dict, MAPMetricResults, MARMetricResults]:
        max_detections = self.max_detection_thresholds[-1]
        if self.matching == "device" and class_ids:
            cells = self._device_cells(self._device_eval_imgs(class_ids, max_detections), len(class_ids))
        else:
            cells = self._host_cells(class_ids, max_detections)
        return self._accumulate(cells, len(class_ids))

    def _results_from_tensors(
        self,
        precision: np.ndarray,
        recall: np.ndarray,
        scores: np.ndarray,
        nb_classes: int,
    ) -> Tuple[Dict, MAPMetricResults, MARMetricResults]:
        """Summarize the accumulated PR tensors: shared tail of
        ``_calculate`` and ``grouped_corpus_finish``."""
        results = {
            "dimensions": [
                len(self.iou_thresholds), len(self.rec_thresholds), nb_classes,
                len(self.bbox_area_ranges), len(self.max_detection_thresholds),
            ],
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }

        map_metrics = MAPMetricResults()
        map_metrics.map = self._summarize(results, True)
        last_max_det = self.max_detection_thresholds[-1]
        map_metrics.map_50 = self._summarize(results, True, iou_threshold=0.5, max_dets=last_max_det)
        map_metrics.map_75 = self._summarize(results, True, iou_threshold=0.75, max_dets=last_max_det)
        map_metrics.map_small = self._summarize(results, True, area_range="small", max_dets=last_max_det)
        map_metrics.map_medium = self._summarize(results, True, area_range="medium", max_dets=last_max_det)
        map_metrics.map_large = self._summarize(results, True, area_range="large", max_dets=last_max_det)

        mar_metrics = MARMetricResults()
        for max_det in self.max_detection_thresholds:
            mar_metrics[f"mar_{max_det}"] = self._summarize(results, False, max_dets=max_det)
        mar_metrics.mar_small = self._summarize(results, False, area_range="small", max_dets=last_max_det)
        mar_metrics.mar_medium = self._summarize(results, False, area_range="medium", max_dets=last_max_det)
        mar_metrics.mar_large = self._summarize(results, False, area_range="large", max_dets=last_max_det)

        return results, map_metrics, mar_metrics

    def compute(self) -> dict:
        """Compute the COCO metric dict (map, map_50, ..., per-class options)."""
        classes = self._get_classes()
        overall, map_metrics, mar_metrics = self._calculate(classes)
        return self._finish_compute(overall, map_metrics, mar_metrics, len(classes))

    def _finish_compute(
        self,
        overall: Dict,
        map_metrics: MAPMetricResults,
        mar_metrics: MARMetricResults,
        nb_classes: int,
    ) -> dict:
        """Assemble the final ``COCOMetricResults`` (per-class slices included)
        as float32 tensors on the metric's device, all of them views of one
        upload: shared tail of ``compute`` and ``grouped_corpus_finish``."""
        map_per_class_values = np.asarray([-1.0], np.float32)
        mar_max_dets_per_class_values = np.asarray([-1.0], np.float32)
        if self.class_metrics:
            # per-class summaries slice the class axis of the precision/recall
            # tensors already computed: each class's matching and
            # accumulation is independent of the others
            map_per_class_list = []
            mar_per_class_list = []
            last_max_det = self.max_detection_thresholds[-1]
            for idx_cls in range(nb_classes):
                cls_results = {
                    "precision": overall["precision"][:, :, idx_cls:idx_cls + 1],
                    "recall": overall["recall"][:, idx_cls:idx_cls + 1],
                }
                map_per_class_list.append(self._summarize(cls_results, True))
                mar_per_class_list.append(self._summarize(cls_results, False, max_dets=last_max_det))
            map_per_class_values = np.stack(map_per_class_list)
            mar_max_dets_per_class_values = np.stack(mar_per_class_list)

        values: Dict[str, Any] = {**map_metrics, **mar_metrics}
        values["map_per_class"] = map_per_class_values
        values[f"mar_{self.max_detection_thresholds[-1]}_per_class"] = mar_max_dets_per_class_values
        flat = np.concatenate([np.ravel(np.asarray(v, np.float32)) for v in values.values()])
        uploaded = torch.from_numpy(flat).to(self.device)
        metrics = COCOMetricResults()
        offset = 0
        for key, v in values.items():
            shape = np.shape(v)
            size = int(np.prod(shape, dtype=np.int64))
            metrics[key] = uploaded[offset:offset + size].reshape(shape)
            offset += size
        return metrics


MeanAveragePrecision = MAP
