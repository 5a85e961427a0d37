"""Tweedie deviance score (port of ``metrics_tpu/functional/regression/tweedie_deviance.py``).

The Poisson branch uses ``xlogy``, so ``target == 0`` contributes 0, as in
the JAX package. The domain checks read the inputs on the host, so they run
eagerly and are skipped on traced inputs (a ``torch.func.vmap`` row of the
engines' masked steps, or a graph being captured), as the JAX package skips
them on tracers. Inside a compiled forward step (``deferred_value_checks``)
a traced update emits one conservative domain predicate per power as a
deferred code instead, raised at the next ``compute()``, as in the JAX
package.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape, _is_traced, defer_value_check, register_deferred_message
from metrics_tpu_torch.utils.device import DeviceLike, as_input, tensor_device

Tensor = torch.Tensor

_CODE_DOMAIN = register_deferred_message(
    "Tweedie deviance inputs violate the positivity domain for the chosen `power`."
)


def _any(*conds: Tensor) -> bool:
    """Whether any condition holds anywhere: one read on the host."""
    return bool(torch.stack([c.any() for c in conds]).any())


def _tweedie_deviance_score_update(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tuple[Tensor, int]:
    _check_same_shape(preds, targets)

    if 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")

    eager = not _is_traced(preds) and not _is_traced(targets)
    if not eager and power != 0:
        # traced under a compiled forward step: one conservative predicate
        # (the eager branches below carry the precise per-power messages)
        if power == 1 or 1 < power < 2:
            defer_value_check(lambda: torch.any(preds <= 0) | torch.any(targets < 0), _CODE_DOMAIN)
        elif power < 0:
            defer_value_check(lambda: torch.any(preds <= 0), _CODE_DOMAIN)
        else:
            defer_value_check(lambda: torch.any(preds <= 0) | torch.any(targets <= 0), _CODE_DOMAIN)
    if power == 0:
        deviance_score = (targets - preds) ** 2
    elif power == 1:
        if eager and _any(preds <= 0, targets < 0):
            raise ValueError(
                f"For power={power}, 'preds' has to be strictly positive and 'targets' cannot be negative."
            )
        deviance_score = 2 * (torch.xlogy(targets, targets / preds) + preds - targets)
    elif power == 2:
        if eager and _any(preds <= 0, targets <= 0):
            raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")
        deviance_score = 2 * (torch.log(preds / targets) + targets / preds - 1)
    else:
        if power < 0:
            if eager and _any(preds <= 0):
                raise ValueError(f"For power={power}, 'preds' has to be strictly positive.")
        elif 1 < power < 2:
            if eager and _any(preds <= 0, targets < 0):
                raise ValueError(
                    f"For power={power}, 'targets' has to be strictly positive and 'preds' cannot be negative."
                )
        else:
            if eager and _any(preds <= 0, targets <= 0):
                raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")

        term_1 = torch.clamp(targets, min=0.0) ** (2 - power) / ((1 - power) * (2 - power))
        term_2 = targets * preds ** (1 - power) / (1 - power)
        term_3 = preds ** (2 - power) / (2 - power)
        deviance_score = 2 * (term_1 - term_2 + term_3)

    sum_deviance_score = torch.sum(deviance_score)
    return sum_deviance_score, deviance_score.numel()


def _tweedie_deviance_score_compute(sum_deviance_score: Tensor, num_observations: Tensor) -> Tensor:
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds: Tensor, targets: Tensor, power: float = 0.0, device: DeviceLike = None) -> Tensor:
    """Compute the Tweedie deviance score for the given power."""
    dev = tensor_device(preds, targets, device=device)
    sum_deviance_score, num_observations = _tweedie_deviance_score_update(
        as_input(preds, dev), as_input(targets, dev), power=power
    )
    return _tweedie_deviance_score_compute(sum_deviance_score, num_observations)
