"""BootStrapper wrapper: bootstrapped confidence estimates for any metric.

Port of ``metrics_tpu/wrappers/bootstrapping.py``. ``poisson`` resampling
draws from a host ``np.random.RandomState(seed)``, as the JAX package does,
so the two packages' poisson replicas are equal bit for bit. ``multinomial``
draws its indices from the metric's own seeded ``torch.Generator`` (the JAX
package's draws come from its PRNG and cannot be matched), and counts its
updates in the registered ``draw_count``. The resample of one row is that
row, so a batch of one row draws nothing: the engines' per-row updates (under
``torch.func.vmap``, inside a captured step) take no random op, and every
replica sees each valid row once, as the JAX package's served BootStrapper
does.

Both strategies stay off the compiled forward (``_forward_jit_safe``): their
draws come from the host, and a captured step would replay the one draw it
was captured with. The JAX package keeps poisson eager too, but compiles
multinomial, whose key it traces from ``draw_count``; the port's draws differ
from the JAX package's anyway, so no value changes.
"""
from copy import deepcopy
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.kernels.common import int32_bits
from metrics_tpu_torch.utils.data import apply_to_collection

Tensor = torch.Tensor


def _bootstrap_sampler(size: int, sampling_strategy: str = "poisson",
                       rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Host resampling indices for one poisson bootstrap draw."""
    rng = rng or np.random
    if sampling_strategy == "poisson":
        n = rng.poisson(1, size)
        return np.repeat(np.arange(size), n)
    raise ValueError("Unknown sampling strategy")


def _resample(x: Tensor, idx: np.ndarray) -> Tensor:
    """``x`` at rows ``idx`` (host indices). One row repeated is an
    ``expand``: no host data reaches the device inside a captured step."""
    if x.shape[0] == 1:
        return x.expand((len(idx),) + tuple(x.shape[1:]))
    return x.index_select(0, torch.from_numpy(idx).to(x.device))


class BootStrapper(Metric):
    """Computes the bootstrapped mean/std/quantile of a base metric.

    The wrapper runs on its base metric's device unless ``device`` says
    otherwise.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, BootStrapper
        >>> boot = BootStrapper(Accuracy(device="cpu"), num_bootstraps=4, sampling_strategy="multinomial", seed=0)
        >>> _ = boot(torch.tensor([0, 1, 1, 0]), torch.tensor([0, 1, 0, 0]))
        >>> sorted(boot.compute().keys())
        ['mean', 'std']
    """

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Tensor]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of `metrics_tpu_torch.Metric` but received {base_metric}"
            )
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self.metrics = nn.ModuleList([deepcopy(base_metric) for _ in range(num_bootstraps)])
        self.num_bootstraps = num_bootstraps

        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw

        allowed_sampling = ("poisson", "multinomial")
        if sampling_strategy not in allowed_sampling:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed_sampling}"
                f" but received {sampling_strategy}"
            )
        self.sampling_strategy = sampling_strategy
        self._rng = np.random.RandomState(seed)
        # seed=None draws OS entropy, as RandomState(None) does
        self._generator = torch.Generator()
        if seed is None:
            self._generator.seed()
        else:
            self._generator.manual_seed(seed)
        self.add_state("draw_count", torch.tensor(0, dtype=torch.uint32), dist_reduce_fx="sum")

    def _forward_jit_safe(self) -> bool:
        # host draws (poisson from numpy, multinomial from a CPU generator):
        # a captured step would bake one draw in and replay it every batch
        return False

    @staticmethod
    def _batch_size(args: Any, kwargs: Any) -> int:
        args_sizes = apply_to_collection(args, Tensor, lambda x: x.shape[0])
        kwargs_sizes = apply_to_collection(kwargs, Tensor, lambda x: x.shape[0])
        if len(args_sizes) > 0:
            return args_sizes[0]
        if len(kwargs_sizes) > 0:
            return next(iter(kwargs_sizes.values()))
        raise ValueError("None of the input contained tensors, so could not determine the sampling size")

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Resample the batch per bootstrap replica and update it."""
        size = self._batch_size(args, kwargs)
        if self.sampling_strategy == "multinomial":
            self.draw_count = (int32_bits(self.draw_count) + 1).view(torch.uint32)
            for m in self.metrics:
                if size == 1:
                    m.update(*args, **kwargs)
                    continue
                idx = torch.randint(0, size, (size,), generator=self._generator).numpy()
                m.update(*apply_to_collection(args, Tensor, _resample, idx),
                         **apply_to_collection(kwargs, Tensor, _resample, idx))
            return
        for m in self.metrics:
            idx = _bootstrap_sampler(size, self.sampling_strategy, self._rng)
            if idx.size == 0:
                continue
            m.update(*apply_to_collection(args, Tensor, _resample, idx),
                     **apply_to_collection(kwargs, Tensor, _resample, idx))

    def compute(self) -> Dict[str, Tensor]:
        """Mean/std/quantile/raw over the bootstrap dim."""
        computed_vals = torch.stack([m.compute() for m in self.metrics], dim=0)
        output_dict = {}
        if self.mean:
            output_dict["mean"] = computed_vals.mean(dim=0)
        if self.std:
            output_dict["std"] = computed_vals.std(dim=0, correction=1)
        if self.quantile is not None:
            q = self.quantile
            q = q if isinstance(q, float) else torch.as_tensor(q, dtype=computed_vals.dtype, device=computed_vals.device)
            output_dict["quantile"] = torch.quantile(computed_vals, q, dim=0)
        if self.raw:
            output_dict["raw"] = computed_vals
        return output_dict

    def reset(self) -> None:
        for m in self.metrics:
            m.reset()
        super().reset()
