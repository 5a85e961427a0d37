"""Runtime probing of optional packages (port of ``metrics_tpu/utils/imports.py``).

A flag says whether a package can be imported, without importing it. A
metric that needs a missing package raises when it is constructed, never
when the port is imported. The port's own optional packages are those of
the text domain (``transformers`` for a BERTScore checkpoint, ``nltk`` for
ROUGE's stemmer, ``regex`` for SacreBLEU's ``intl`` tokenizer); the other
flags keep the JAX package's names.
"""
import importlib.util
from functools import lru_cache


@lru_cache(maxsize=None)
def _module_available(module_path: str) -> bool:
    """True if ``module_path`` (dotted) can be imported without importing it."""
    try:
        parts = module_path.split(".")
        probe = parts[0]
        if importlib.util.find_spec(probe) is None:
            return False
        for part in parts[1:]:
            probe = f"{probe}.{part}"
            if importlib.util.find_spec(probe) is None:
                return False
        return True
    except (ModuleNotFoundError, ValueError):
        return False


_TRANSFORMERS_AVAILABLE = _module_available("transformers")
_TORCH_AVAILABLE = _module_available("torch")
_SKLEARN_AVAILABLE = _module_available("sklearn")
_SCIPY_AVAILABLE = _module_available("scipy")
_NLTK_AVAILABLE = _module_available("nltk")
_ROUGE_SCORE_AVAILABLE = _module_available("rouge_score")
_REGEX_AVAILABLE = _module_available("regex")
_PESQ_AVAILABLE = _module_available("pesq")
_PYSTOI_AVAILABLE = _module_available("pystoi")
_PYCOCOTOOLS_AVAILABLE = _module_available("pycocotools")
