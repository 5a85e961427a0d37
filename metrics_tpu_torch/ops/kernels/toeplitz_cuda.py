"""K8: SDR's batched symmetric Toeplitz solve on the card, and its plain version beside it.

The JAX package solves SDR's ``(L, L)`` system ``T(r) x = b``, with
``T[i, j] = r[|i - j|]``, by XLA's LU (``metrics_tpu/functional/audio/sdr.py``);
no Pallas kernel lies there. PyTorch's own batched solve at SDR's default
``L = 512`` runs on MAGMA, which a CUDA graph cannot capture, so the port
solves with the Levinson recursion instead (``csrc/toeplitz.cu``): one warp
a system with no block barrier up to ``L = 512``, one block a system
above (its vectors in shared memory up to ``L = 6144``, in a global
scratch beyond), the recursion's ``L - 1`` steps inside the kernel,
float32 in memory and float64 inside. :func:`toeplitz_solve_cuda` is the wrapper,
:func:`toeplitz_solve_plain` the same recursion in PyTorch, in float64, and
:func:`toeplitz_solve` picks by the tensor's device. Nothing
reads the solve's status on the host: a silent target (``r = 0``) gives NaN,
and a system the recursion cannot solve gives inf or NaN.
"""
import torch

from metrics_tpu_torch.ops.kernels import build

__all__ = ["toeplitz_solve", "toeplitz_solve_cuda", "toeplitz_solve_plain"]

def toeplitz_solve_plain(r: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x`` with ``T(r) x = b`` for each row of ``(..., L)`` ``r`` and ``b``,
    by the Levinson recursion in float64; returned in ``r``'s dtype."""
    shape, length = r.shape, r.shape[-1]
    r64 = r.reshape(-1, length).to(torch.float64)
    b64 = b.reshape(-1, length).to(torch.float64)
    f = torch.zeros_like(r64)
    x = torch.zeros_like(r64)
    f[:, 0] = 1.0 / r64[:, 0]
    x[:, 0] = b64[:, 0] / r64[:, 0]
    for k in range(1, length):
        rk = r64[:, 1:k + 1].flip(-1)  # r[k - i] for i < k
        ef = (rk * f[:, :k]).sum(-1, keepdim=True)
        ex = (rk * x[:, :k]).sum(-1, keepdim=True)
        fk = f[:, :k + 1]  # f[k] is 0: [f; 0], and its flip is [0; rev f]
        fk = (fk - ef * fk.flip(-1)) / (1.0 - ef * ef)
        f[:, :k + 1] = fk
        x[:, :k + 1] += (b64[:, k:k + 1] - ex) * fk.flip(-1)
    return x.to(r.dtype).reshape(shape)


def toeplitz_solve_cuda(r: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`toeplitz_solve_plain` on the card. ``r`` and ``b`` are ``(..., L)``
    float32 (SDR's dtype) on one CUDA device, ``L >= 1``; raises on anything
    else. Above ``L = 6144`` the kernel keeps ``f`` and ``x`` in a float64
    scratch of ``2 L`` a system, allocated here on the call's stream."""
    if r.device.type != "cuda" or b.device != r.device:
        raise ValueError("toeplitz_solve_cuda: r and b must lie on one CUDA device")
    if r.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"toeplitz_solve_cuda takes float32 r and b, got {r.dtype} and {b.dtype}")
    if r.shape != b.shape or r.ndim < 1 or r.shape[-1] < 1:
        raise ValueError(f"toeplitz_solve_cuda: expected r and b of one (..., L) shape, got "
                         f"{tuple(r.shape)} and {tuple(b.shape)}")
    length = r.shape[-1]
    lib = build.library("toeplitz")
    x = torch.empty_like(r, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return x
    r, b = r.contiguous(), b.contiguous()
    batch = r.numel() // length
    with torch.cuda.device(r.device):
        scratch = (torch.empty((batch, 2, length), dtype=torch.float64, device=r.device)
                   if length > lib.toeplitz_shared_length() else None)
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.toeplitz_solve(r.data_ptr(), b.data_ptr(), x.data_ptr(),
                                 scratch.data_ptr() if scratch is not None else None, batch, length, stream)
    build.check(err, "toeplitz_solve launch")
    toeplitz_solve_cuda.launches += 1
    return x


#: launches of the K8 kernel since the count was last set to 0
toeplitz_solve_cuda.launches = 0


def toeplitz_solve(r: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The symmetric Toeplitz solve: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    return toeplitz_solve_cuda(r, b) if r.is_cuda else toeplitz_solve_plain(r, b)
