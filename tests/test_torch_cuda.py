"""The port's CUDA kernels against their plain versions, on the card.

Marked ``requires_cuda``: each skips without a CUDA device (the kernels have
no CPU mode). The file imports nothing of JAX, so it runs where only the port
is installed; from the repository root::

    python -m pytest tests/test_torch_cuda.py -m requires_cuda --noconftest -q

(``--noconftest``: ``tests/conftest.py`` sets up JAX for the JAX package's tests.)
"""
import numpy as np
import pytest
import torch

from metrics_tpu_torch.ops.binned_update import binned_counts_torch
from metrics_tpu_torch.ops.kernels import fold_rows_masked


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bfloat16])
@pytest.mark.parametrize("fx", ["sum", "min", "max"])
def test_fold_kernel_matches_plain_on_card(cuda, dtype, fx):
    from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda, fold_rows_plain

    rng = np.random.RandomState(0)
    rows = torch.from_numpy(rng.randint(-100, 100, (1037, 33))).to(cuda, dtype)
    state = torch.from_numpy(rng.randint(-100, 100, (33,))).to(cuda, dtype)
    mask = torch.from_numpy((rng.rand(1037) > 0.3).astype(np.int32)).to(cuda)
    before = fold_rows_cuda.launches
    got = fold_rows_cuda(state, rows, mask, fx)
    assert fold_rows_cuda.launches == before + 1
    # small integers: every sum is exact in f32 and in bf16's range of this data
    torch.testing.assert_close(got.float(), fold_rows_plain(state, rows, mask, fx).float(), rtol=0,
                               atol=0 if dtype != torch.bfloat16 or fx != "sum" else 2.0 ** -7 * 4096)


@pytest.mark.requires_cuda
def test_histogram_kernel_matches_plain_on_card(cuda):
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda, histogram_plain

    rng = np.random.RandomState(1)
    for length in (7, 100, 102400):
        idx = torch.from_numpy(rng.randint(-3, length + 3, 5000).astype(np.int32)).to(cuda)
        assert torch.equal(histogram_cuda(idx, length), histogram_plain(idx, length))


@pytest.mark.requires_cuda
def test_binned_kernel_matches_plain_on_card(cuda):
    from metrics_tpu_torch.ops.binned_update import binned_counts_cuda

    rng = np.random.RandomState(2)
    preds = torch.from_numpy(rng.rand(4099, 10).astype(np.float32)).to(cuda)
    preds[:7] = float("nan")
    target = torch.from_numpy(rng.rand(4099, 10) > 0.5).to(cuda)
    thresholds = torch.linspace(0, 1, 100, device=cuda)
    for g, w in zip(binned_counts_cuda(preds, target, thresholds), binned_counts_torch(preds, target, thresholds)):
        assert torch.equal(g, w)


@pytest.mark.requires_cuda
def test_cuda_tensor_never_takes_the_plain_version(cuda):
    from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda

    before = fold_rows_cuda.launches
    fold_rows_masked(torch.zeros(4, device=cuda), torch.ones(8, 4, device=cuda), torch.ones(8, device=cuda), "sum")
    assert fold_rows_cuda.launches == before + 1
    with pytest.raises(TypeError):  # int16 is not a kernel dtype: raise, never fall back
        fold_rows_masked(torch.zeros(4, dtype=torch.int16, device=cuda),
                         torch.ones(8, 4, dtype=torch.int16, device=cuda), torch.ones(8, device=cuda), "sum")
