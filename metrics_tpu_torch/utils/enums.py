"""Case-insensitive string enums used by the input-format layer.

A copy of ``metrics_tpu/utils/enums.py``: the port imports nothing of the JAX package.

Parity: reference ``torchmetrics/utilities/enums.py:18-83`` (EnumStr, DataType,
AverageMethod, MDMCAverageMethod). Values and member names mirror the reference so user
code ports verbatim; implementation is plain Python (host-side only, never traced).
"""
from enum import Enum
from typing import Optional


class EnumStr(str, Enum):
    """String enum with case-insensitive ``from_str`` lookup."""

    @classmethod
    def from_str(cls, value: str) -> Optional["EnumStr"]:
        try:
            return cls[value.replace("-", "_").upper()]
        except KeyError:
            return None

    def __eq__(self, other) -> bool:
        if other is None:
            return False
        if isinstance(other, Enum):
            return self.value.lower() == other.value.lower()
        return self.value.lower() == str(other).lower()

    def __hash__(self) -> int:
        return hash(self.value.lower())


class DataType(EnumStr):
    """Inferred type of classification inputs."""

    BINARY = "binary"
    MULTILABEL = "multi-label"
    MULTICLASS = "multi-class"
    MULTIDIM_MULTICLASS = "multi-dim multi-class"


class AverageMethod(EnumStr):
    """Reduction over classes."""

    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = "none"
    SAMPLES = "samples"


class MDMCAverageMethod(EnumStr):
    """Reduction for multidim-multiclass inputs."""

    GLOBAL = "global"
    SAMPLEWISE = "samplewise"
