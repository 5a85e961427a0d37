"""metrics_tpu_torch: the PyTorch/CUDA port of ``metrics_tpu``.

The same update/compute/reset + ``add_state(dist_reduce_fx)`` contract, with
metrics as ``nn.Module``s on an explicit device (``"cuda"`` by default) and
the JAX package's Pallas kernels replaced by hand-written CUDA kernels for
Hopper (``ops/kernels/csrc``), built with ``nvcc`` on first use.
"""
from metrics_tpu_torch.aggregation import BaseAggregator, CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
from metrics_tpu_torch.classification import (
    AUC,
    AUROC,
    Accuracy,
    AveragePrecision,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
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
    PrecisionRecallCurve,
    ROC,
    Recall,
    Specificity,
    StatScores,
)
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import CompositionalMetric, Metric
from metrics_tpu_torch.wrappers import BootStrapper, MetricTracker, MinMaxMetric, MultioutputWrapper

__all__ = [
    "AUC",
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BaseAggregator",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "BinnedRecallAtFixedPrecision",
    "BootStrapper",
    "CalibrationError",
    "CatMetric",
    "CohenKappa",
    "CompositionalMetric",
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
    "MaxMetric",
    "MeanMetric",
    "Metric",
    "MetricCollection",
    "MetricTracker",
    "MinMaxMetric",
    "MinMetric",
    "MultioutputWrapper",
    "Precision",
    "PrecisionRecallCurve",
    "ROC",
    "Recall",
    "Specificity",
    "StatScores",
    "SumMetric",
]
