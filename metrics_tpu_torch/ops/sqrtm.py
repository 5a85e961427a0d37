"""Matrix square roots on the device (port of ``metrics_tpu/ops/sqrtm.py``).

FID needs ``trace(sqrtm(sigma1 @ sigma2))`` of two symmetric PSD
covariances. As in JAX it comes from two Hermitian eigendecompositions,

    trace sqrt(S1 S2) = sum sqrt(eig(S1^(1/2) S2 S1^(1/2))),

exact for PSD inputs, with no escape to scipy on the host. A Newton-Schulz
iteration gives a full matrix square root from matmuls alone. The matmuls
run under :func:`full_f32` (no TF32, no bf16 passes), as JAX runs them in
full precision on the CPU.

``torch.linalg.eigh`` on a CUDA tensor checks its convergence on the host,
so a forward whose batch value calls these cannot be captured.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.precision import full_f32

Tensor = torch.Tensor


def psd_sqrt(mat: Tensor, eps: float = 1e-12) -> Tensor:
    """Symmetric PSD matrix square root via eigh."""
    vals, vecs = torch.linalg.eigh(mat)
    vals = torch.clamp(vals, min=0.0)
    with full_f32():
        return (vecs * torch.sqrt(vals + eps)) @ vecs.T


def trace_sqrtm_product(sigma1: Tensor, sigma2: Tensor) -> Tensor:
    """``trace(sqrtm(sigma1 @ sigma2))`` for symmetric PSD ``sigma1``, ``sigma2``."""
    s1_half = psd_sqrt(sigma1)
    with full_f32():
        m = s1_half @ sigma2 @ s1_half
    m = (m + m.T) / 2  # re-symmetrise against rounding
    vals = torch.linalg.eigvalsh(m)
    return torch.sum(torch.sqrt(torch.clamp(vals, min=0.0)))


def sqrtm_newton_schulz(mat: Tensor, num_iters: int = 50) -> Tuple[Tensor, Tensor]:
    """Full matrix square root by Newton-Schulz iteration (matmuls only).

    Returns ``(sqrt(mat), error_estimate)``; converges for matrices of
    spectral radius < 1 after normalisation, to ~1e-5 relative in f32.
    """
    dim = mat.shape[0]
    norm = torch.linalg.norm(mat)
    y = mat / norm
    eye = torch.eye(dim, dtype=mat.dtype, device=mat.device)
    z = eye
    with full_f32():
        for _ in range(num_iters):
            t = 0.5 * (3.0 * eye - z @ y)
            y, z = y @ t, t @ z
        sqrt_mat = y * torch.sqrt(norm)
        err = torch.linalg.norm(sqrt_mat @ sqrt_mat - mat) / torch.clamp(torch.linalg.norm(mat), min=1e-12)
    return sqrt_mat, err
