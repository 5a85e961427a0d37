"""metrics_tpu_torch: the PyTorch/CUDA port of ``metrics_tpu``.

The same update/compute/reset + ``add_state(dist_reduce_fx)`` contract, with
metrics as ``nn.Module``s on an explicit device (``"cuda"`` by default) and
the JAX package's Pallas kernels replaced by hand-written CUDA kernels for
Hopper (``ops/kernels/csrc``), built with ``nvcc`` on first use.
"""
from metrics_tpu_torch.classification import (
    Accuracy,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    CalibrationError,
    CohenKappa,
    ConfusionMatrix,
    F1Score,
    FBeta,
    HammingDistance,
    Hinge,
    HingeLoss,
    IoU,
    JaccardIndex,
    KLDivergence,
    MatthewsCorrCoef,
    MatthewsCorrcoef,
    Precision,
    Recall,
    Specificity,
    StatScores,
)
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric

__all__ = [
    "Accuracy",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "CalibrationError",
    "CohenKappa",
    "ConfusionMatrix",
    "F1Score",
    "FBeta",
    "HammingDistance",
    "Hinge",
    "HingeLoss",
    "IoU",
    "JaccardIndex",
    "KLDivergence",
    "MatthewsCorrCoef",
    "MatthewsCorrcoef",
    "Metric",
    "MetricCollection",
    "Precision",
    "Recall",
    "Specificity",
    "StatScores",
]
