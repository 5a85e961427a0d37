"""Inception Score (port of ``metrics_tpu/image/inception.py``).

List mode keeps the logits and, at compute, permutes them with
``np.random.RandomState(seed)``, splits them with ``np.array_split``'s rule
and takes ``std`` with ddof 1, as JAX. Streaming mode keeps a per-split
``(sum p, sum p log p, n)`` triple in float-float pairs and assigns each
sample to a split as JAX does, bit for bit: ``randint(fold_in(PRNGKey(seed),
n_seen), (n,), 0, splits)`` with the port's threefry (``utils/prng.py``),
``n_seen`` the device sum of ``split_n``, so an update reads nothing on the
host. The split matmuls run under :func:`full_f32`.
"""
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops import floatfloat as ff
from metrics_tpu_torch.utils import prng
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.precision import full_f32

Tensor = torch.Tensor


class IS(Metric):
    """Inception Score: the exp of the mean split KL between ``p(y|x)`` and ``p(y)``.

    Args:
        feature: an int/str naming an InceptionV3 tap or a callable ``imgs -> (N, C)``.
        splits: number of splits for the mean and std.
        params: weights of the built-in InceptionV3.
        seed: the seed of the split assignment (drawn at random when None).
        streaming: per-split statistics instead of a feature list.
        feature_dim: logits width ``C``, needed for streaming with a callable.
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        feature: Union[int, str, Callable] = "logits_unbiased",
        splits: int = 10,
        params: Optional[Any] = None,
        seed: Optional[int] = None,
        streaming: bool = False,
        feature_dim: Optional[int] = None,
        mesh: Optional[Any] = None,
        mesh_axis: Any = "dp",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        from metrics_tpu_torch.models.inception import resolve_feature_extractor

        self.inception, builtin_dim = resolve_feature_extractor(
            "InceptionScore", feature, params, mesh, mesh_axis,
            ("logits_unbiased", "64", "192", "768", "2048"), device=self.device,
        )
        if feature_dim is None:
            feature_dim = builtin_dim
        self.splits = splits
        # seed=None: a fresh assignment seed, as list mode's shuffle is fresh each run
        self._seed = int(np.random.randint(0, 2**31 - 1)) if seed is None else int(seed)
        self._rng = np.random.RandomState(seed)
        self._key = prng.prng_key(self._seed, self.device)  # made once: a host copy per update would sync
        self.streaming = bool(streaming)
        if self.streaming:
            # the assignment key reads sum(split_n): forward snapshots and restores
            self.full_state_update = True
            if feature_dim is None:
                raise ValueError(
                    "InceptionScore(streaming=True) with a callable `feature` needs "
                    "`feature_dim=` (the logits width) to allocate the statistic buffers."
                )
            c = int(feature_dim)
            self.add_state("prob_sum_hi", default=torch.zeros(splits, c), dist_reduce_fx="sum")
            self.add_state("prob_sum_lo", default=torch.zeros(splits, c), dist_reduce_fx="sum")
            self.add_state("plogp_sum_hi", default=torch.zeros(splits), dist_reduce_fx="sum")
            self.add_state("plogp_sum_lo", default=torch.zeros(splits), dist_reduce_fx="sum")
            self.add_state("split_n", default=torch.zeros(splits), dist_reduce_fx="sum")
        else:
            self.add_state("features", default=[], dist_reduce_fx=None)

    def update(self, imgs: Tensor) -> None:
        features = self.inception(imgs)
        if not self.streaming:
            self.features.append(features)
            return
        features = torch.as_tensor(features, device=self.device).to(torch.float32)
        prob = F.softmax(features, dim=1)
        log_prob = F.log_softmax(features, dim=1)
        n_seen = torch.sum(self.split_n).to(torch.int32)
        key = prng.fold_in(self._key.to(self.device), n_seen)
        assign = prng.randint(key, (features.shape[0],), 0, self.splits)
        # a comparison, not F.one_hot, which checks its range on the host
        onehot = (assign[:, None] == torch.arange(self.splits, device=assign.device)).to(torch.float32)  # (N, S)
        with full_f32():
            batch_prob = onehot.T @ prob
            batch_plogp = onehot.T @ torch.sum(prob * log_prob, dim=1)
        self.prob_sum_hi, self.prob_sum_lo = ff.ff_add_f32((self.prob_sum_hi, self.prob_sum_lo), batch_prob)
        self.plogp_sum_hi, self.plogp_sum_lo = ff.ff_add_f32((self.plogp_sum_hi, self.plogp_sum_lo), batch_plogp)
        self.split_n = self.split_n + torch.sum(onehot, dim=0)

    def compute(self) -> Tuple[Tensor, Tensor]:
        if self.streaming:
            prob_sum = self.prob_sum_hi + self.prob_sum_lo  # (S, C)
            plogp_sum = self.plogp_sum_hi + self.plogp_sum_lo  # (S,)
            n_s = self.split_n
            # random assignment can leave a split empty at small N: it is masked out of the mean and std
            valid = n_s > 0
            safe_n = torch.clamp(n_s, min=1.0)
            m_p = prob_sum / safe_n[:, None]
            cross = torch.sum(prob_sum * torch.log(torch.clamp(m_p, min=1e-38)), dim=1)
            kl = torch.exp((plogp_sum - cross) / safe_n)
            k = torch.sum(valid)
            zero = torch.zeros((), device=kl.device)
            mean = torch.sum(torch.where(valid, kl, zero)) / k
            var = torch.sum(torch.where(valid, (kl - mean) ** 2, zero)) / torch.clamp(k - 1, min=1)
            return mean, torch.sqrt(var)

        features = dim_zero_cat(self.features)
        idx = torch.from_numpy(self._rng.permutation(features.shape[0])).to(features.device)
        features = features[idx]
        prob = F.softmax(features, dim=1)
        log_prob = F.log_softmax(features, dim=1)
        kl_ = []
        # np.array_split's rule: the first n % splits chunks take one row more
        for p, log_p in zip(torch.tensor_split(prob, self.splits, dim=0),
                            torch.tensor_split(log_prob, self.splits, dim=0)):
            m_p = torch.mean(p, dim=0, keepdim=True)
            kl = p * (log_p - torch.log(m_p))
            kl_.append(torch.exp(torch.mean(torch.sum(kl, dim=1))))
        kl = torch.stack(kl_)
        return torch.mean(kl), torch.std(kl, correction=1)


InceptionScore = IS
