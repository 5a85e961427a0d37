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

from metrics_tpu_torch.metric import forward_entry_kinds, keep_forward_eager
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
        idx = torch.from_numpy(rng.randint(-3, length + 3, (1, 5000)).astype(np.int32)).to(cuda)
        assert torch.equal(histogram_cuda(idx, length), histogram_plain(idx, length))


def _hist_indices(rng, b, n, length):
    """int64 (B, N) indices: in range, negative, >= L, and past int32 on both
    sides (2**32 + 1 would land in bin 1 if it wrapped)."""
    idx = rng.randint(-3, length + 3, (b, n)).astype(np.int64)
    far = np.array([2**31, 2**32 + 1, 2**33 + length - 1, -(2**31) - 1, -(2**40)], np.int64)
    idx.flat[::5] = rng.choice(far, idx.flat[::5].shape)
    return torch.from_numpy(idx)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("length", [1, 100, 12289, 102400])
@pytest.mark.parametrize("n", [1, 3, 16384])
@pytest.mark.parametrize("b", [1, 64, 256, 1024])
def test_histogram_kernel_takes_every_shape(cuda, b, n, length):
    """Both forms (direct N <= 16, shared with bin tiles past 48 KB) against
    the plain version, exactly, one launch a call: int64 indices with no
    mask; int32 indices under a batched bool mask; one row expanded to B with
    stride 0 under a stride-0 int32 mask; a uint8 mask over a transposed view."""
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda, histogram_plain

    rng = np.random.RandomState(b + n + length)
    idx = _hist_indices(rng, b, n, length).to(cuda)
    mask = torch.from_numpy(rng.rand(b, n) > 0.3).to(cuda)
    row = idx[:1].expand(b, n)
    row_mask = mask[:1].to(torch.int32).expand(b, n)
    t_idx = idx.to(torch.int32).t().contiguous().t()  # (B, N) with element stride B
    t_mask = mask.to(torch.uint8).t().contiguous().t()
    for i, m in ((idx, None), (idx.to(torch.int32), mask), (row, row_mask), (t_idx, t_mask)):
        before = histogram_cuda.launches
        got = histogram_cuda(i, length, m)
        assert histogram_cuda.launches == before + 1
        assert got.shape == (b, length) and torch.equal(got, histogram_plain(i, length, m))


_OUT_EPS = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int8,
                                   torch.int16, torch.int32, torch.int64, torch.uint8])
@pytest.mark.parametrize("b, n", [(64, 3), (2, 5000)])
def test_histogram_kernel_sums_every_weight_dtype(cuda, dtype, b, n):
    """Weighted sums in the weights' dtype, direct and shared form: integer
    dtypes exactly (wrapping), floats within the reassociation bound of their
    accumulator (2 * n * eps * sum|w| a cell) plus one step of the output
    dtype for bf16 and f16. Weights are also read through a stride-0 batch."""
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda, histogram_plain

    rng = np.random.RandomState(n)
    length, k = 37, 3
    idx = _hist_indices(rng, b, n, length).to(cuda)
    mask = torch.from_numpy(rng.rand(b, n) > 0.3).to(cuda)
    if dtype.is_floating_point:
        w = torch.from_numpy(rng.randn(b, n, k) * 10).to(cuda, dtype)
    else:
        info = torch.iinfo(dtype)
        w = torch.from_numpy(rng.randint(max(info.min, -(2**40)), min(info.max, 2**40), (b, n, k))).to(cuda, dtype)
    for ww in (w, w[:1].expand(b, n, k)):
        got = histogram_cuda(idx, length, mask, ww)
        want = histogram_plain(idx, length, mask, ww)
        assert got.dtype == dtype and got.shape == (b, length, k)
        if not dtype.is_floating_point:
            assert torch.equal(got, want)
            continue
        abs_sums = histogram_plain(idx, length, mask, ww.abs().double())
        eps = 2.0**-53 if dtype == torch.float64 else 2.0**-24
        tol = (2 * n * eps + _OUT_EPS.get(dtype, 0.0)) * abs_sums
        assert ((got.double() - want.double()).abs() <= tol).all()


_IN_DIMS = [(i, m, w) for i in (0, None) for m in ("none", 0, None) for w in ("none", 0, None) if 0 in (i, m, w)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("idx_dim, mask_dim, w_dim", _IN_DIMS)
def test_histogram_vmap_is_one_launch_on_card(cuda, idx_dim, mask_dim, w_dim):
    """Every batched/unbatched combination of indices, mask and weights
    through ``torch.func.vmap``: one launch, and the same result as the CPU
    path (the plain version under the same vmap rule)."""
    from metrics_tpu_torch.ops.kernels import histogram_accumulate
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda

    rng = np.random.RandomState(17)
    b, n, length = 64, 1, 100

    def draw(dim, shape, make):
        return None if dim == "none" else make((b,) + shape if dim == 0 else shape)

    idx = draw(idx_dim, (n,), lambda s: torch.from_numpy(rng.randint(-2, length + 2, s)))
    mask = draw(mask_dim, (n,), lambda s: torch.from_numpy(rng.rand(*s) > 0.3))
    w = draw(w_dim, (n,), lambda s: torch.from_numpy(rng.randint(0, 2, s).astype(np.float32)))
    dims = tuple(None if d == "none" else d for d in (idx_dim, mask_dim, w_dim))
    fn = torch.func.vmap(lambda i, m, ww: histogram_accumulate(i, length, weights=ww, mask=m), in_dims=dims)
    args = [x if x is None else x.to(cuda) for x in (idx, mask, w)]
    before = histogram_cuda.launches
    got = fn(*args)
    assert histogram_cuda.launches == before + 1
    assert torch.equal(got.cpu(), fn(idx, mask, w))  # 0/1 weights: the sums are exact


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


def _segment_case(rng, dtype, n, s, f, nan=False):
    """Rows, state, int32 mask and ids on the CPU: masked rows carry garbage ids."""
    rows = torch.from_numpy(rng.randint(-100, 100, (n, f))).to(dtype)
    state = torch.from_numpy(rng.randint(-100, 100, (s, f))).to(dtype)
    if nan and n > 4:
        rows[2, 0] = float("nan")
        rows[4, :] = float("-inf")
    mask = rng.rand(n) > 0.3
    ids = rng.randint(0, s, n).astype(np.int32)
    ids[~mask] = rng.choice([-7, s, 2**31 - 1], int((~mask).sum()))
    return rows, state, torch.from_numpy(mask.astype(np.int32)), torch.from_numpy(ids)


def _sum_bound(n, seed, rows, mask):
    """Per cell, how far two f32 sums of the same ``n`` terms taken in other
    orders can lie apart: each side within ``n * 2**-24 * sum|terms|``."""
    return 2 * n * 2.0 ** -24 * (seed.abs() + (rows.abs() * mask[:, None]).sum(0)).cpu()


def _same(got, want, dtype, fx_sum):
    # small integers: f32 and int32 sums are exact; bf16 sums round once in both
    atol = 2.0 ** -7 * 4096 if dtype == torch.bfloat16 and fx_sum else 0
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), rtol=0, atol=atol, equal_nan=True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bfloat16])
@pytest.mark.parametrize("fx", ["sum", "min", "max"])
@pytest.mark.parametrize("s", [1, 7, 128, 5000, 13000])
def test_segment_kernel_matches_plain_on_card(cuda, dtype, fx, s):
    from metrics_tpu_torch.ops.kernels.segment_cuda import segment_reduce_cuda, segment_reduce_plain

    rng = np.random.RandomState(s)
    rows, state, mask, ids = _segment_case(rng, dtype, 1037, s, 33, nan=dtype != torch.int32)
    before = segment_reduce_cuda.launches
    got = segment_reduce_cuda(state.to(cuda), rows.to(cuda), mask.to(cuda), ids.to(cuda), fx)
    assert segment_reduce_cuda.launches == before + 1
    _same(got, segment_reduce_plain(state, rows, mask, ids, s, fx), dtype, fx == "sum")


R = 64  # csrc/segment.cu's chunk: a segment of more rows is folded by one block per chunk


def _long_segments(rng, lengths, s, f, extra_masked=0):
    """Rows (small ints, f32), a state and int32 mask/ids in which segment
    ``k`` holds ``lengths[k]`` live rows, interleaved in row order, plus
    ``extra_masked`` masked rows with garbage ids."""
    sids = np.concatenate([np.full(n, k, np.int32) for k, n in enumerate(lengths)] +
                          [np.full(extra_masked, -1, np.int32)])
    rng.shuffle(sids)
    n = len(sids)
    mask = (sids >= 0).astype(np.int32)
    ids = np.where(sids >= 0, sids, rng.choice([-7, s, 2**31 - 1], n)).astype(np.int32)
    rows = torch.from_numpy(rng.randint(-100, 100, (n, f)).astype(np.float32))
    state = torch.from_numpy(rng.randint(-100, 100, (s, f)).astype(np.float32))
    return rows, state, torch.from_numpy(mask), torch.from_numpy(ids)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [R - 1, R, R + 1, 4096])
@pytest.mark.parametrize("f", [1, 1000])
@pytest.mark.parametrize("fx", ["sum", "max"])
def test_segment_kernel_folds_one_long_segment(cuda, n, f, fx):
    """The engines' one-stream step: every live row in one segment, so its
    chunks fold into partials and the last block of each tile folds those."""
    from metrics_tpu_torch.ops.kernels.megastep_cuda import megastep_segment_cuda, megastep_segment_plain
    from metrics_tpu_torch.ops.kernels.segment_cuda import segment_reduce_cuda, segment_reduce_plain

    rng = np.random.RandomState(n + f)
    s = 64
    rows, state, mask, ids = _long_segments(rng, [0] * 5 + [n], s, f, extra_masked=n // 8)
    got = segment_reduce_cuda(state.to(cuda), rows.to(cuda), mask.to(cuda), ids.to(cuda), fx)
    _same(got, segment_reduce_plain(state, rows, mask, ids, s, fx), torch.float32, fx == "sum")
    ops = torch.from_numpy(rng.randint(0, 3, f).astype(np.int32))  # a mixed op row through K6
    got = megastep_segment_cuda(state.to(cuda), rows.to(cuda), mask.to(cuda), ids.to(cuda), ops.to(cuda), None)
    _same(got, megastep_segment_plain(state, rows, mask, ids, ops), torch.float32, True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bfloat16])
@pytest.mark.parametrize("lengths", [(R + 1, 2 * R + 5), (3 * R + 7, 0, R, 2 * R + 1)])
def test_segment_kernel_folds_long_segments_sharing_a_chunk_boundary(cuda, dtype, lengths):
    """Long segments side by side in the sorted order: a chunk of R rows would
    straddle two of them, so each segment's chunks start at its own first row."""
    from metrics_tpu_torch.ops.kernels.segment_cuda import segment_reduce_cuda, segment_reduce_plain

    rng = np.random.RandomState(len(lengths))
    s, f = 9, 200
    rows, state, mask, ids = _long_segments(rng, lengths, s, f, extra_masked=13)
    rows, state = rows.to(dtype), state.to(dtype)
    for fx in ("sum", "min", "max"):
        got = segment_reduce_cuda(state.to(cuda), rows.to(cuda), mask.to(cuda), ids.to(cuda), fx)
        _same(got, segment_reduce_plain(state, rows, mask, ids, s, fx), dtype, fx == "sum")


@pytest.mark.requires_cuda
def test_segment_kernel_folds_a_long_segment_past_the_shared_table(cuda):
    """S = 13 000: the sort's (segment, warp) table lives in global memory."""
    from metrics_tpu_torch.ops.kernels.segment_cuda import segment_reduce_cuda, segment_reduce_plain

    rng = np.random.RandomState(7)
    s, f = 13000, 33
    lengths = [0] * s
    lengths[12345], lengths[3] = 700, 5
    rows, state, mask, ids = _long_segments(rng, lengths, s, f, extra_masked=40)
    got = segment_reduce_cuda(state.to(cuda), rows.to(cuda), mask.to(cuda), ids.to(cuda), "sum")
    _same(got, segment_reduce_plain(state, rows, mask, ids, s, "sum"), torch.float32, True)


@pytest.mark.requires_cuda
def test_segment_kernel_sums_are_the_same_on_every_run(cuda):
    """f32 sums of random (non-integer) rows at the one-stream shape: no float
    atomics, so every run gives the same bits."""
    from metrics_tpu_torch.ops.kernels.segment_cuda import segment_reduce_cuda, segment_reduce_plain

    rng = np.random.RandomState(8)
    s, n, f = 64, 1024, 1000
    rows = torch.from_numpy(rng.randn(n, f).astype(np.float32)).to(cuda)
    state = torch.from_numpy(rng.randn(s, f).astype(np.float32)).to(cuda)
    mask = torch.from_numpy((rng.rand(n) > 0.1).astype(np.int32)).to(cuda)
    ids = torch.where(mask.bool(), 17, -7).to(torch.int32)
    first = segment_reduce_cuda(state, rows, mask, ids, "sum")
    for _ in range(5):
        assert torch.equal(segment_reduce_cuda(state, rows, mask, ids, "sum"), first)
    want = segment_reduce_plain(state, rows, mask, ids, s, "sum")
    assert ((first - want).abs()[17].cpu() <= _sum_bound(n, state[17], rows, mask)).all()
    assert torch.equal(torch.cat([first[:17], first[18:]]), torch.cat([state[:17], state[18:]]))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bfloat16])
@pytest.mark.parametrize("uniform", ["sum", "min", "max", None])
def test_megastep_kernels_match_plain_on_card(cuda, dtype, uniform):
    from metrics_tpu_torch.ops.kernels.common import REDUCE_OPS
    from metrics_tpu_torch.ops.kernels.megastep_cuda import (
        megastep_fold_cuda,
        megastep_fold_plain,
        megastep_segment_cuda,
        megastep_segment_plain,
    )

    rng = np.random.RandomState(3)
    f = 300
    ops = np.full(f, REDUCE_OPS.index(uniform) if uniform else 0, np.int32)
    if uniform is None:
        ops[100:150], ops[150:170] = 1, 2
    ops = torch.from_numpy(ops)
    rows, state, mask, ids = _segment_case(rng, dtype, 517, 9, f, nan=dtype != torch.int32)
    got = megastep_fold_cuda(state[0].to(cuda), rows.to(cuda), mask.to(cuda), ops.to(cuda), uniform)
    _same(got, megastep_fold_plain(state[0], rows, mask, ops), dtype, True)
    got = megastep_segment_cuda(state.to(cuda), rows.to(cuda), mask.to(cuda), ids.to(cuda), ops.to(cuda), uniform)
    _same(got, megastep_segment_plain(state, rows, mask, ids, ops), dtype, True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n, one_stream", [(0, False), (211, False), (500, True)])
def test_q8_segment_kernel_decodes_like_the_host_codec(cuda, n, one_stream):
    """K7 equals K6 run on a state decoded beforehand, bit for bit, including
    flagged slots no row touches, a step without rows, and one flagged slot
    that takes every row (a long segment, folded through partials)."""
    from metrics_tpu_torch.ops.kernels.megastep_cuda import (
        megastep_segment_cuda,
        megastep_segment_plain,
        megastep_segment_q8_cuda,
    )

    rng = np.random.RandomState(4)
    s, f = 16, 96
    rows = torch.from_numpy(rng.rand(n, f).astype(np.float32))
    state = torch.from_numpy(rng.rand(s, f).astype(np.float32))
    mask = torch.from_numpy((rng.rand(n) > 0.2).astype(np.int32))
    ids = torch.from_numpy(rng.randint(0, s // 2, n).astype(np.int32))  # slots >= s/2 untouched
    if one_stream:
        ids[:] = 2  # a flagged slot
    flags = torch.from_numpy((np.arange(s) % 3 != 1).astype(np.int32))
    codes = torch.from_numpy(rng.randint(-127, 128, (s, f)).astype(np.int8))
    scales = torch.from_numpy((rng.rand(s, f) * 1e-2).astype(np.float32))
    qcol = torch.from_numpy((np.arange(f) < 64).astype(np.int32))
    ops = torch.zeros(f, dtype=torch.int32)
    q8 = [t.to(cuda) for t in (flags, codes, scales, qcol)]
    got = megastep_segment_q8_cuda(state.to(cuda), rows.to(cuda), mask.to(cuda), ids.to(cuda), ops.to(cuda),
                                   "sum", *q8)
    decoded = state.numpy().copy()
    host = (codes.numpy().astype(np.float32) * scales.numpy()).astype(np.float32)  # _decode_blocks
    on = (flags.numpy()[:, None] != 0) & (qcol.numpy()[None, :] != 0)
    decoded[on] = host[on]
    twin = megastep_segment_cuda(torch.from_numpy(decoded).to(cuda), rows.to(cuda), mask.to(cuda), ids.to(cuda),
                                 ops.to(cuda), "sum")
    assert torch.equal(got, twin)
    want = megastep_segment_plain(state, rows, mask, ids, ops, q8=(flags, codes, scales, qcol))
    if one_stream:  # one slot sums ~400 rows: the two sum orders differ by up to the bound
        assert ((got.cpu() - want).abs()[2] <= _sum_bound(n, torch.from_numpy(decoded[2]), rows, mask)).all()
        got, want = torch.cat([got[:2], got[3:]]), torch.cat([want[:2], want[3:]])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.requires_cuda
def test_dispatch_launches_the_q8_kernel_on_an_empty_step(cuda):
    from metrics_tpu_torch.ops.kernels import megastep_segment
    from metrics_tpu_torch.ops.kernels.megastep_cuda import megastep_segment_q8_cuda

    s, f = 4, 8
    state = torch.zeros(s, f, device=cuda)
    q8 = (torch.ones(s, dtype=torch.int32), torch.full((s, f), 3, dtype=torch.int8), torch.full((s, f), 0.5),
          np.ones(f, bool))
    before = megastep_segment_q8_cuda.launches
    out = megastep_segment(state, torch.zeros(0, f, device=cuda), torch.zeros(0, device=cuda),
                           torch.zeros(0, device=cuda), s, np.zeros(f, np.int32), q8=q8)
    assert megastep_segment_q8_cuda.launches == before + 1
    assert torch.equal(out.cpu(), torch.full((s, f), 1.5))


def _fold_case(rng, dtype, n, f):
    """Small-integer rows and state (exact sums in every dtype), an int32 mask
    with about a third masked, and a mixed op row in runs, as leaves lay out."""
    rows = torch.from_numpy(rng.randint(-100, 100, (n, f))).to(dtype)
    state = torch.from_numpy(rng.randint(-100, 100, (f,))).to(dtype)
    mask = torch.from_numpy((rng.rand(n) > 0.3).astype(np.int32))
    ops = torch.from_numpy(np.repeat(np.arange(3, dtype=np.int32), -(-f // 3))[:f].copy())
    return rows, state, mask, ops


def _check_folds(cuda, rows, state, mask, ops, dtype):
    """K1 under each op and K5 under each uniform op row and the mixed one,
    one launch per call, against their plain versions."""
    from metrics_tpu_torch.ops.kernels.common import REDUCE_OPS
    from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda, fold_rows_plain
    from metrics_tpu_torch.ops.kernels.megastep_cuda import megastep_fold_cuda, megastep_fold_plain

    d_rows, d_state, d_mask = rows.to(cuda), state.to(cuda), mask.to(cuda)
    for fx in REDUCE_OPS:
        before = fold_rows_cuda.launches
        got = fold_rows_cuda(d_state, d_rows, d_mask, fx)
        assert fold_rows_cuda.launches == before + 1
        _same(got, fold_rows_plain(state, rows, mask, fx), dtype, fx == "sum")
    f = state.shape[0]
    for uniform, op_row in [(fx, torch.full((f,), i, dtype=torch.int32)) for i, fx in enumerate(REDUCE_OPS)] + \
            [(None, ops)]:
        got = megastep_fold_cuda(d_state, d_rows, d_mask, op_row.to(cuda), uniform)
        _same(got, megastep_fold_plain(state, rows, mask, op_row), dtype, True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 3, 4, 7, 33, 146, 3000])
def test_fold_kernels_take_every_column_width(cuda, dtype, f):
    """F a whole number of 16-byte vectors takes the vector body; any other F,
    and rows whose base is not on 16 bytes, the scalar body."""
    rng = np.random.RandomState(f)
    rows, state, mask, ops = _fold_case(rng, dtype, 517, f)
    _check_folds(cuda, rows, state, mask, ops, dtype)
    flat = torch.zeros(rows.numel() + 1, dtype=dtype)
    flat[1:] = rows.reshape(-1)
    shifted = flat.to(cuda)[1:].view(rows.shape)  # contiguous, its base one element past 16 bytes
    from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda, fold_rows_plain

    _same(fold_rows_cuda(state.to(cuda), shifted, mask.to(cuda), "sum"), fold_rows_plain(state, rows, mask, "sum"),
          dtype, True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bfloat16])
@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 4096])
def test_fold_kernels_take_every_row_count(cuda, dtype, n):
    """Row counts on both sides of the chunk and unroll boundaries, and none."""
    rng = np.random.RandomState(n)
    rows, state, mask, ops = _fold_case(rng, dtype, n, 300)
    _check_folds(cuda, rows, state, mask, ops, dtype)


@pytest.mark.requires_cuda
def test_fold_kernel_sums_are_the_same_on_every_run(cuda):
    """f32 sums of random rows at the megastep arena's shape: no float atomics,
    so 20 calls give the same bits, within the reassociation bound of the plain sum."""
    from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda, fold_rows_plain

    rng = np.random.RandomState(9)
    n, f = 1024, 3000
    rows = torch.from_numpy(rng.randn(n, f).astype(np.float32)).to(cuda)
    state = torch.from_numpy(rng.randn(f).astype(np.float32)).to(cuda)
    mask = torch.from_numpy((rng.rand(n) > 0.1).astype(np.int32)).to(cuda)
    first = fold_rows_cuda(state, rows, mask, "sum")
    for _ in range(20):
        assert torch.equal(fold_rows_cuda(state, rows, mask, "sum"), first)
    want = fold_rows_plain(state, rows, mask, "sum")
    assert ((first - want).abs().cpu() <= _sum_bound(n, state, rows, mask)).all()


@pytest.mark.requires_cuda
def test_fold_kernels_run_many_shapes_in_a_row(cuda):
    """Many calls in a row, at shapes with other tile, chunk and cluster
    counts in turn, each against its plain version: nothing one call leaves
    on the card changes the next."""
    rng = np.random.RandomState(10)
    cases = [_fold_case(rng, dtype, n, f) + (dtype,) for dtype, n, f in
             ((torch.float32, 1024, 3000), (torch.int32, 256, 146), (torch.bfloat16, 65, 7),
              (torch.int32, 1024, 1), (torch.float32, 256, 3000))]
    for _ in range(10):
        for rows, state, mask, ops, dtype in cases:
            _check_folds(cuda, rows, state, mask, ops, dtype)


def _binned_check(cuda, preds, target, thresholds):
    """K3 on the card against the plain version and numpy, bit for bit, one launch."""
    from metrics_tpu_torch.ops.binned_update import binned_counts_cuda

    before = binned_counts_cuda.launches
    got = binned_counts_cuda(preds.to(cuda), target.to(cuda), thresholds.to(cuda))
    assert binned_counts_cuda.launches == before + 1
    want = binned_counts_torch(preds, target, thresholds)
    p, y, t = preds.numpy(), target.numpy(), thresholds.numpy()
    ge = p[:, :, None] >= t[None, None, :]
    oracle = ((y[:, :, None] & ge).sum(0), (~y[:, :, None] & ge).sum(0), (y[:, :, None] & ~ge).sum(0))
    for g, w, o in zip(got, want, oracle):
        assert torch.equal(g.cpu(), w)
        assert np.array_equal(g.cpu().numpy(), o.astype(np.float32))


def _binned_inputs(rng, n, c, edge=False):
    preds = rng.rand(n, c).astype(np.float32)
    target = rng.rand(n, c) > 0.7
    if edge and n >= 40:
        preds[3:9, 0] = np.nan
        preds[10:30] = -np.inf  # pad rows: -inf preds, target 0
        target[10:30] = False
        preds[31] = np.inf
        preds[32] = 1.0
        preds[33] = 0.0
    return torch.from_numpy(preds), torch.from_numpy(target)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bucket", [64, 256, 1024])
def test_binned_kernel_at_the_vmapped_buckets(cuda, bucket):
    """The vmapped masked step's one launch: a (1, B*10) row against 100 thresholds."""
    rng = np.random.RandomState(bucket)
    preds, target = _binned_inputs(rng, bucket, 10, edge=True)
    _binned_check(cuda, preds.reshape(1, -1), target.reshape(1, -1), torch.linspace(0, 1, 100))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [1, 255, 256, 257, 16384])
def test_binned_kernel_takes_every_row_count(cuda, n):
    """One row chunk, and row chunks folded through the int32 sums; the second
    call finds the sums and counters the first left zero."""
    rng = np.random.RandomState(n)
    preds, target = _binned_inputs(rng, n, 10, edge=True)
    for _ in range(2):
        _binned_check(cuda, preds, target, torch.linspace(0, 1, 100))


def _odd_thresholds(kind, t, rng):
    thr = np.linspace(0, 1, t).astype(np.float32)
    if kind == "unsorted":
        rng.shuffle(thr)
    elif kind == "duplicated":
        thr[1::3] = thr[::3][: len(thr[1::3])]
    elif kind == "infinite":
        thr[0], thr[-1] = -np.inf, np.inf
    elif kind == "nan":
        thr[t // 2] = np.nan
    return torch.from_numpy(thr)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["unsorted", "duplicated", "infinite", "nan"])
@pytest.mark.parametrize("n, c, t", [(1, 2560, 100), (1037, 10, 100), (300, 3, 7), (65, 5, 9)])
def test_binned_kernel_takes_any_thresholds(cuda, kind, n, c, t):
    """Thresholds in any order, repeated, infinite or NaN, with NaN, infinite
    and -inf pad-row preds; C*T not a multiple of 4 takes one threshold a thread."""
    rng = np.random.RandomState(n + c + t)
    preds, target = _binned_inputs(rng, n, c, edge=True)
    if n == 1:
        preds[0, ::7] = float("nan")
        preds[0, 1::7] = float("-inf")
        preds[0, 2::7] = float("inf")
    _binned_check(cuda, preds, target, _odd_thresholds(kind, t, rng))


# --------------------------------------------------------------- captured engine steps

def _engine_collection(device, q8=False):
    from metrics_tpu_torch import Accuracy, BinnedAveragePrecision, ConfusionMatrix, MetricCollection

    return MetricCollection({
        "acc": Accuracy(device=device),
        "ap": BinnedAveragePrecision(num_classes=4, thresholds=11, device=device,
                                     sync_precision="q8_block" if q8 else None),
        "cm": ConfusionMatrix(num_classes=4, device=device),
    })


def _engine_traffic(seed, n_batches=24, streams=12):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        n = int(rng.randint(1, 40))
        p = rng.rand(n, 4).astype(np.float32)
        out.append((int(rng.randint(0, streams)), p / p.sum(1, keepdims=True), rng.randint(0, 4, n)))
    return out


def _make_engine(kind, device, capture, cache=None):
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine

    q8 = kind == "paged_q8"
    coalesce = 1 if q8 else 8  # a q8 spill taken at another step quantizes differently
    cfg = EngineConfig(buckets=(16, 64), kernel_backend="auto" if kind == "streaming_auto" else "megastep",
                       compress_payloads=q8, coalesce=coalesce)
    coll = _engine_collection(device, q8)
    if kind.startswith("streaming"):
        eng = StreamingEngine(coll, cfg, aot_cache=cache)
    elif kind == "unsharded":
        eng = MultiStreamEngine(coll, 12, cfg, aot_cache=cache)
    else:
        eng = MultiStreamEngine(coll, 12, cfg, stream_shard=True, resident_streams=3, aot_cache=cache)
    eng._capture = capture
    return eng


def _drive(eng, traffic, cuda_inputs, device):
    multi = hasattr(eng, "num_streams")
    with eng:
        for sid, p, t in traffic:
            p, t = (torch.from_numpy(p).to(device), torch.from_numpy(t).to(device)) if cuda_inputs else (p, t)
            if multi:
                eng.submit(sid, p, t)
            else:
                eng.submit(p, t)
    if multi:
        return [eng.stream_state(s) for s in range(eng.num_streams)]
    return eng.state()


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cuda_inputs", [False, True])
@pytest.mark.parametrize("kind", ["streaming_auto", "streaming_megastep", "unsharded", "paged_exact", "paged_q8"])
def test_captured_step_is_bit_equal_to_uncaptured(cuda, kind, cuda_inputs):
    """Each engine replaying captured graphs ends bit-equal to the same engine
    running its steps eagerly, numpy inputs (pinned staging) and CUDA inputs
    (device copies) alike; the captured one captured at most one step per
    bucket."""
    traffic = _engine_traffic(3)
    captured = _make_engine(kind, cuda, True)
    got = _drive(captured, traffic, cuda_inputs, cuda)
    want = _drive(_make_engine(kind, cuda, False), traffic, cuda_inputs, cuda)
    assert captured.steps > 0 and captured.stats.rows_in == sum(len(t) for _, _, t in traffic)
    assert captured.aot_cache.misses <= 2 and captured.stats.warmup_steps == captured.aot_cache.misses
    for g, w in zip(_flat(got), _flat(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.requires_cuda
def test_replays_credit_the_launch_counters(cuda):
    """A replay makes no Python call to a wrapper, yet each kernel's count
    rises by what one step launches: K5 twice a step (two arena dtypes), K2
    once, and the capture itself counts nothing."""
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda
    from metrics_tpu_torch.ops.kernels.megastep_cuda import megastep_fold_cuda

    eng = _make_engine("streaming_megastep", cuda, True)
    traffic = _engine_traffic(4)
    k5, k2 = megastep_fold_cuda.launches, histogram_cuda.launches
    _drive(eng, traffic, True, cuda)
    steps = eng.steps + eng.stats.warmup_steps
    assert eng.stats.warmup_steps >= 1 and eng.aot_cache.hits >= 1
    assert megastep_fold_cuda.launches - k5 == 2 * steps
    assert histogram_cuda.launches - k2 == steps


@pytest.mark.requires_cuda
def test_warm_twin_engine_captures_nothing(cuda):
    from metrics_tpu_torch.engine import AotCache

    cache = AotCache()
    traffic = _engine_traffic(5)
    first = _drive(_make_engine("streaming_megastep", cuda, True, cache), traffic, True, cuda)
    misses = cache.misses
    twin = _make_engine("streaming_megastep", cuda, True, cache)
    second = _drive(twin, traffic, True, cuda)
    assert cache.misses == misses and twin.stats.warmup_steps == 0
    for g, w in zip(_flat(second), _flat(first)):
        assert torch.equal(g, w)


@pytest.mark.requires_cuda
def test_cuda_input_is_read_after_its_producer_stream(cuda):
    """A batch the caller wrote on its own stream, still being written when
    ``submit`` returns, is read by the engine only after that write."""
    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine
    from metrics_tpu_torch import ConfusionMatrix

    eng = StreamingEngine(ConfusionMatrix(num_classes=3, device=cuda), EngineConfig(buckets=(64,)))
    eng.start()  # before the producer's stream is current: start orders the engine after the caller's stream
    producer = torch.cuda.Stream(cuda)
    with torch.cuda.stream(producer):
        preds = torch.zeros(64, dtype=torch.int64, device=cuda)
        target = torch.zeros(64, dtype=torch.int64, device=cuda)
        torch.cuda._sleep(50_000_000)  # the producer's stream is busy for a while
        preds.fill_(2)
        target.fill_(1)
        eng.submit(preds, target)
        del preds, target  # the engine keeps the memory alive
    eng.stop()
    cm = eng.state()["confmat"]
    assert int(cm[1, 2]) == 64 and int(cm.sum()) == 64


@pytest.mark.requires_cuda
def test_a_capture_failure_raises_and_never_runs_eagerly(cuda):
    """A step that reads a value to the host (``.item()``) runs eagerly (the
    warm-up, on a copy) but cannot be captured: the capture error is the
    dispatcher's sticky error, and the live state never saw the batch."""
    from metrics_tpu_torch.engine import EngineConfig, EngineDispatchError, StreamingEngine
    from metrics_tpu_torch.metric import Metric

    class HostReading(Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.scale = torch.ones((), device=self.device)
            self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + x.sum() * self.scale.item()

        def compute(self):
            return self.total

    eng = StreamingEngine(HostReading(device=cuda), EngineConfig(buckets=(8,)))
    eng.submit(torch.ones(5, device=cuda))
    with pytest.raises(EngineDispatchError) as info:
        eng.flush()
    assert info.value.bucket == 8 and info.value.__cause__ is not None
    assert eng.stats.steps == 0 and eng.aot_cache.misses == 1 and len(eng.aot_cache) == 0
    eng._error = None
    assert float(eng.state()["total"]) == 0.0
    eng.stop()


# ------------------------------------------- counting metrics, calibration and results()

def _calibration_inputs(device, n=65536, n_bins=15, seed=11):
    """The calibration error's one histogram call at the main path's shape:
    searchsorted bins of top-label confidences and the (N, 3) weight columns."""
    from metrics_tpu_torch.functional.classification.calibration_error import _bin_boundaries, _ce_update

    rng = np.random.RandomState(seed)
    p = rng.rand(n, 10).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    p[:7, :] = 0.0  # confidence 0: in no bin
    conf, acc = _ce_update(torch.from_numpy(p).to(device), torch.from_numpy(rng.randint(0, 10, n)).to(device))
    idx = torch.searchsorted(_bin_boundaries(n_bins, device), conf, side="left") - 1
    w = (idx >= 0).to(torch.float32)
    return idx.clamp(0, n_bins - 1), torch.stack([w, conf * w, acc * w], dim=-1)


@pytest.mark.requires_cuda
def test_histogram_weighted_form_at_the_calibration_shape(cuda):
    """K2's weighted form as the calibration error sends it: one launch, the
    counts column exact, the f32 sums within the reassociation bound
    2 * n * 2**-24 * sum|terms| of the plain version's."""
    from metrics_tpu_torch.ops.kernels import histogram_accumulate
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda, histogram_plain

    idx, w = _calibration_inputs(cuda)
    before = histogram_cuda.launches
    got = histogram_accumulate(idx, 15, weights=w)
    assert histogram_cuda.launches == before + 1 and got.shape == (15, 3) and got.dtype == torch.float32
    want = histogram_plain(idx[None], 15, None, w[None])[0]
    assert torch.equal(got[:, 0], want[:, 0])
    abs_sums = histogram_plain(idx[None], 15, None, w.abs()[None])[0].double()
    assert bool(((got.double() - want.double()).abs() <= 2 * idx.numel() * 2.0**-24 * abs_sums).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
def test_calibration_error_on_card_is_one_histogram_launch(cuda, norm):
    from metrics_tpu_torch import CalibrationError
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda

    rng = np.random.RandomState(12)
    p = rng.rand(4096, 10).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    t = rng.randint(0, 10, 4096)
    card, cpu = CalibrationError(norm=norm, device=cuda), CalibrationError(norm=norm, device="cpu")
    card.update(torch.from_numpy(p).to(cuda), torch.from_numpy(t).to(cuda))
    cpu.update(torch.from_numpy(p), torch.from_numpy(t))
    before = histogram_cuda.launches
    value = card.compute()
    assert histogram_cuda.launches == before + 1
    # f32 bin sums of up to 4096 terms in two orders: 4096 * 2**-24 relative, twice
    torch.testing.assert_close(value.cpu(), cpu.compute(), rtol=2 * 4096 * 2.0**-24, atol=1e-6)


def _dashboard_collection(device):
    from metrics_tpu_torch import (CohenKappa, HammingDistance, HingeLoss, JaccardIndex, MatthewsCorrCoef,
                                   MetricCollection, Precision, Recall, Specificity)

    return MetricCollection({
        "precision": Precision(num_classes=4, average="macro", device=device),
        "recall": Recall(num_classes=4, average="macro", device=device),
        "specificity": Specificity(num_classes=4, average="macro", device=device),
        "hamming": HammingDistance(device=device),
        "jaccard": JaccardIndex(num_classes=4, device=device),
        "kappa": CohenKappa(num_classes=4, device=device),
        "mcc": MatthewsCorrCoef(num_classes=4, device=device),
        "hinge": HingeLoss(device=device),
    })


def _same_values(got, want, exact_ints=True):
    for g, w in zip(_flat(got), _flat(want)):
        g, w = g.detach().cpu(), w.detach().cpu()
        assert g.dtype == w.dtype and g.shape == w.shape
        if exact_ints and not g.is_floating_point():
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6, equal_nan=True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("collection", ["flagship", "dashboard"])
def test_results_of_a_captured_engine_is_one_batched_call(cuda, paged, collection):
    """``results()`` of an engine whose steps replayed captured graphs: one
    device computation, every stream's value equal to its ``result()`` and to
    the same traffic's values through a CPU engine."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine

    make = _engine_collection if collection == "flagship" else _dashboard_collection
    kw = {"stream_shard": True, "resident_streams": 3} if paged else {}
    traffic = _engine_traffic(6, n_batches=40, streams=12)
    engines = []
    for device in (cuda, torch.device("cpu")):
        eng = MultiStreamEngine(make(device), 16, EngineConfig(buckets=(16, 64), kernel_backend="megastep",
                                                               coalesce=1), **kw)
        _drive(eng, traffic, False, device)
        engines.append(eng)
    card, cpu = engines
    assert card.stats.warmup_steps >= 1 and card.aot_cache.hits >= 1
    if paged:
        assert card.pager.spilled_count() > 0
    before = card.stats.result_device_calls
    got = card.results()
    assert card.stats.result_device_calls == before + 1
    want = cpu.results()
    for sid in range(16):  # streams 12-15 never saw a batch
        assert all(v.device.type == "cpu" for v in _flat(got[sid]))
        _same_values(got[sid], card.result(sid))
        _same_values(got[sid], want[sid])


def _curve_collection(device):
    from metrics_tpu_torch import AUROC, Accuracy, AveragePrecision, MetricCollection

    return MetricCollection({"acc": Accuracy(device=device),
                             "auroc": AUROC(num_classes=4, capacity=1024, device=device),
                             "ap": AveragePrecision(num_classes=4, average="weighted", capacity=1024, device=device)})


@pytest.mark.requires_cuda
@pytest.mark.parametrize("backend", ["megastep", "auto"])
def test_captured_scan_step_is_bit_equal_to_uncaptured(cuda, backend):
    """A collection with capacity members (the scan strategy: rows folded in
    order, no host read) captures as one graph per bucket: its buffers end
    bit-equal to the uncaptured engine's and to the CPU engine's, and no
    megastep launch happens (every arena dtype is demoted)."""
    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine
    from metrics_tpu_torch.ops.kernels.megastep_cuda import megastep_fold_cuda

    traffic = _engine_traffic(7, n_batches=24)
    states = []
    for device, capture in ((cuda, True), (cuda, False), (torch.device("cpu"), False)):
        eng = StreamingEngine(_curve_collection(device), EngineConfig(buckets=(16, 64), kernel_backend=backend))
        eng._capture = capture
        k5 = megastep_fold_cuda.launches
        states.append(_drive(eng, traffic, False, device))
        assert megastep_fold_cuda.launches == k5
        if capture:
            assert eng.stats.warmup_steps >= 1 and eng.aot_cache.hits >= 1
        if backend == "megastep":
            assert eng.stats.kernel_fallbacks_by_reason() == {
                "dtype.bool:strategy": 1, "dtype.float32:strategy": 1, "dtype.int32:strategy": 1}
    assert int(states[0]["auroc"]["count"]) == sum(len(t) for _, _, t in traffic)
    for other in states[1:]:
        for g, w in zip(_flat(states[0]), _flat(other)):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu())


@pytest.mark.requires_cuda
def test_weighted_auroc_counts_support_in_one_histogram_launch(cuda):
    """The eager weighted AUROC counts class support with ``_bincount``: one
    K2 launch; the value within 1e-5 of the CPU port's (f32 trapezoids and
    the weighted sum over 4096 rows in another order)."""
    from metrics_tpu_torch.functional import auroc
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda

    rng = np.random.RandomState(14)
    p = rng.rand(4096, 10).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    t = rng.randint(0, 10, 4096)
    before = histogram_cuda.launches
    got = auroc(torch.from_numpy(p).to(cuda), torch.from_numpy(t).to(cuda), num_classes=10, average="weighted")
    assert histogram_cuda.launches == before + 1
    want = auroc(torch.from_numpy(p), torch.from_numpy(t), num_classes=10, average="weighted")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.requires_cuda
def test_binned_recall_at_fixed_precision_counts_on_the_binned_kernel(cuda):
    """``BinnedRecallAtFixedPrecision`` updates through K3 (one launch per
    update): its counts equal the CPU port's exactly, and so do its values."""
    from metrics_tpu_torch import BinnedRecallAtFixedPrecision
    from metrics_tpu_torch.ops.binned_update import binned_counts_cuda

    rng = np.random.RandomState(15)
    p = rng.rand(2048, 10).astype(np.float32)
    t = rng.randint(0, 10, 2048)
    card = BinnedRecallAtFixedPrecision(num_classes=10, min_precision=0.15, device=cuda)
    cpu = BinnedRecallAtFixedPrecision(num_classes=10, min_precision=0.15, device="cpu")
    before = binned_counts_cuda.launches
    card.update(torch.from_numpy(p).to(cuda), torch.from_numpy(t).to(cuda))
    assert binned_counts_cuda.launches == before + 1
    cpu.update(torch.from_numpy(p), torch.from_numpy(t))
    for k in ("TPs", "FPs", "FNs"):
        assert torch.equal(getattr(card, k).cpu(), getattr(cpu, k))
    for g, w in zip(card.compute(), cpu.compute()):
        assert torch.equal(g.cpu(), w)


# ------------------------------------------------------ wrappers and nested metrics

def _wrapper_collection(device, heads=False):
    from metrics_tpu_torch import Accuracy, BootStrapper, MetricCollection, MultioutputWrapper, Precision, Recall

    if heads:
        return MetricCollection({"multi": MultioutputWrapper(Accuracy(num_classes=4, device=device), num_outputs=2,
                                                             remove_nans=False)})
    p, r = Precision(num_classes=4, average="macro", device=device), Recall(num_classes=4, average="macro",
                                                                             device=device)
    return MetricCollection({
        "acc": Accuracy(device=device),
        "f1_composed": 2 * p * r / (p + r),
        "boot": BootStrapper(Accuracy(num_classes=4, device=device), num_bootstraps=3,
                             sampling_strategy="multinomial", seed=0),
    })


def _make_wrapper_engine(kind, device, capture, cache=None, heads=False):
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine

    cfg = EngineConfig(buckets=(16, 64), kernel_backend="megastep")
    coll = _wrapper_collection(device, heads)
    if kind == "streaming":
        eng = StreamingEngine(coll, cfg, aot_cache=cache)
    elif kind == "unsharded":
        eng = MultiStreamEngine(coll, 12, cfg, aot_cache=cache)
    else:
        eng = MultiStreamEngine(coll, 12, cfg, stream_shard=True, resident_streams=3, aot_cache=cache)
    eng._capture = capture
    return eng


def _two_head_traffic(seed, n_batches=16):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        n = int(rng.randint(1, 40))
        p = rng.rand(n, 4, 2).astype(np.float32)
        out.append((int(rng.randint(0, 12)), p / p.sum(1, keepdims=True), rng.randint(0, 4, (n, 2))))
    return out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("heads", [False, True], ids=["wrappers", "multioutput"])
@pytest.mark.parametrize("kind", ["streaming", "unsharded", "paged"])
def test_captured_wrapper_step_is_bit_equal_to_uncaptured(cuda, kind, heads):
    """Wrapped and composed members through the captured engines: bit-equal
    to the uncaptured twin, K5 (megastep) or K6 (paged) launched; every
    bootstrap replica equals the plain accuracy and ``draw_count`` counts the
    rows."""
    from metrics_tpu_torch.ops.kernels.megastep_cuda import megastep_fold_cuda, megastep_segment_cuda

    traffic = _two_head_traffic(6) if heads else _engine_traffic(6)
    k5, k6 = megastep_fold_cuda.launches, megastep_segment_cuda.launches
    captured = _make_wrapper_engine(kind, cuda, True, heads=heads)
    got = _drive(captured, traffic, True, cuda)
    launched = {"streaming": megastep_fold_cuda.launches - k5, "paged": megastep_segment_cuda.launches - k6}
    assert launched.get(kind, 1) > 0 and captured.stats.warmup_steps >= 1
    want = _drive(_make_wrapper_engine(kind, cuda, False, heads=heads), traffic, True, cuda)
    for g, w in zip(_flat(got), _flat(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if heads:
        return
    states = [got] if kind == "streaming" else got
    rows = sum(len(t) for _, _, t in traffic)
    assert sum(int(s["boot"]["draw_count"].view(torch.int32)) for s in states) == rows
    for s in states:
        for child in s["boot"]["_children"]["metrics"]:
            for k, v in s["acc"].items():
                assert torch.equal(child[k], v)


@pytest.mark.requires_cuda
def test_warm_twin_wrapper_engine_captures_nothing(cuda):
    """The fingerprint of a BootStrapper leaves its generators out: a twin
    over an equally configured collection replays the first one's graphs."""
    from metrics_tpu_torch.engine import AotCache

    cache = AotCache()
    traffic = _engine_traffic(7)
    first = _drive(_make_wrapper_engine("streaming", cuda, True, cache), traffic, True, cuda)
    misses = cache.misses
    twin = _make_wrapper_engine("streaming", cuda, True, cache)
    second = _drive(twin, traffic, True, cuda)
    assert misses >= 1 and cache.misses == misses and twin.stats.warmup_steps == 0
    for g, w in zip(_flat(second), _flat(first)):
        assert torch.equal(g, w)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("fx", ["sum", "min", "max"])
def test_uint32_states_fold_on_their_int32_bits(cuda, fx):
    """K1, K4, K5 and K6 fold a uint32 leaf as its int32 bits (sign bit
    flipped for min/max): equal to the plain versions on the CPU."""
    from metrics_tpu_torch.ops.kernels import megastep_fold, megastep_segment, segment_reduce_masked

    rng = np.random.RandomState(1)
    rows = torch.from_numpy(rng.randint(0, 2**32, (300, 7), dtype=np.uint64).astype(np.uint32))
    state = torch.from_numpy(rng.randint(0, 2**32, (7,), dtype=np.uint64).astype(np.uint32))
    mask = torch.from_numpy(rng.rand(300) > 0.2)
    ids = torch.from_numpy(rng.randint(0, 3, 300).astype(np.int32))
    ops = np.full((7,), ("sum", "min", "max").index(fx), np.int32)
    ops[0] = 0  # a mixed op row
    on = lambda *xs: [x.to(cuda) for x in xs]  # noqa: E731
    pairs = [
        (fold_rows_masked(*on(state, rows, mask), fx), fold_rows_masked(state, rows, mask, fx)),
        (megastep_fold(*on(state, rows, mask), ops), megastep_fold(state, rows, mask, ops)),
        (segment_reduce_masked(*on(state.expand(3, -1).clone(), rows, mask, ids), 3, fx),
         segment_reduce_masked(state.expand(3, -1).clone(), rows, mask, ids, 3, fx)),
        (megastep_segment(*on(state.expand(3, -1).clone(), rows, mask, ids), 3, ops),
         megastep_segment(state.expand(3, -1).clone(), rows, mask, ids, 3, ops)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.uint32 and torch.equal(got.cpu(), want)


@pytest.mark.requires_cuda
def test_to_device_moves_states_and_defaults(cuda):
    """``to_device("cpu")`` then ``reset()`` keeps the states on the CPU (the
    defaults moved too), through nested metrics and constant operands."""
    from metrics_tpu_torch import Accuracy, MinMaxMetric

    mm, comp = MinMaxMetric(Accuracy(device=cuda)), Accuracy(device=cuda) * 2.0
    for m in (mm, comp):
        m.update(torch.tensor([0, 1, 1], device=cuda), torch.tensor([0, 1, 0], device=cuda))
        m.to_device("cpu")
        m.reset()
        m.update(torch.tensor([0, 1]), torch.tensor([0, 1]))
    inner = mm._base_metric
    assert mm.device.type == inner.device.type == comp.device.type == comp.metric_b.device.type == "cpu"
    assert inner.tp.device.type == "cpu" and all(v.device.type == "cpu" for v in inner._defaults.values())
    assert float(mm.compute()["raw"]) == 1.0 and float(comp.compute()) == 2.0
    mm.to(cuda)
    mm.reset()
    assert inner.tp.device.type == "cuda" and mm.min_val.device.type == "cuda"


def _regression_collection(device):
    from metrics_tpu_torch import (ExplainedVariance, MeanAbsoluteError, MeanAbsolutePercentageError,
                                   MeanSquaredError, MeanSquaredLogError, MetricCollection, R2Score,
                                   SymmetricMeanAbsolutePercentageError, TweedieDevianceScore)

    return MetricCollection({
        "mse": MeanSquaredError(device=device), "rmse": MeanSquaredError(squared=False, device=device),
        "mae": MeanAbsoluteError(device=device), "msle": MeanSquaredLogError(device=device),
        "mape": MeanAbsolutePercentageError(device=device),
        "smape": SymmetricMeanAbsolutePercentageError(device=device),
        "explained_variance": ExplainedVariance(device=device),
        "tweedie": TweedieDevianceScore(power=1.5, device=device), "r2": R2Score(device=device),
    })


# members whose every term and sum is exact in f32 on the dyadic rows below
_EXACT_MEMBERS = ("mse", "rmse", "mae", "explained_variance", "r2")


def _regression_traffic(seed, n_batches=24, streams=12):
    """Positive rows on a 1/4 grid up to 8: differences, squares and their
    sums over a few hundred rows are exact in f32, whatever the order."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        n = int(rng.randint(1, 40))
        out.append((int(rng.randint(0, streams)), rng.randint(1, 33, n).astype(np.float32) / 4,
                    rng.randint(1, 33, n).astype(np.float32) / 4))
    return out


def _make_regression_engine(kind, device, capture):
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine

    coll = _regression_collection(device)
    if kind == "streaming":
        eng = StreamingEngine(coll, EngineConfig(buckets=(16, 64), kernel_backend="megastep", coalesce=1))
    elif kind == "unsharded":
        eng = MultiStreamEngine(coll, 12, EngineConfig(buckets=(16, 64), coalesce=1))
    else:
        eng = MultiStreamEngine(coll, 12, EngineConfig(buckets=(16, 64), kernel_backend="megastep", coalesce=1),
                                stream_shard=True, resident_streams=3)
    eng._capture = capture
    return eng


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["streaming", "unsharded", "paged"])
def test_captured_regression_engine_matches_the_cpu_port(cuda, kind):
    """The served regression members (and R2Score's states) through the
    captured engines: bit-equal to the uncaptured twin on the card; counts
    and the exact members' sums bit-equal to the CPU port's on the same
    rows; the log, percentage and Tweedie sums (whose terms the card's and
    the CPU's math libraries may round apart) within (2 n + 8) 2^-24 of
    theirs, every term being non-negative; K5, K4 or K6 launched. The
    served R2 value raises on the card too."""
    from metrics_tpu_torch.ops.kernels.megastep_cuda import megastep_fold_cuda, megastep_segment_cuda
    from metrics_tpu_torch.ops.kernels.segment_cuda import segment_reduce_cuda
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    traffic = _regression_traffic(5)
    wrappers = {"streaming": megastep_fold_cuda, "unsharded": segment_reduce_cuda, "paged": megastep_segment_cuda}
    before = wrappers[kind].launches
    captured = _make_regression_engine(kind, cuda, True)
    got = _drive(captured, traffic, True, cuda)
    assert wrappers[kind].launches > before and captured.stats.warmup_steps >= 1
    assert captured.stats.kernel_fallbacks_by_reason() == {}
    twin = _drive(_make_regression_engine(kind, cuda, False), traffic, True, cuda)
    for g, w in zip(_flat(got), _flat(twin)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    cpu = torch.device("cpu")
    want = _drive(_make_regression_engine(kind, cpu, False), traffic, False, cpu)
    rows = sum(len(t) for _, _, t in traffic)
    for g_tree, w_tree in zip([got] if kind == "streaming" else got, [want] if kind == "streaming" else want):
        for member in w_tree:
            for name, w in w_tree[member].items():
                g = g_tree[member][name].cpu()
                assert g.dtype == w.dtype, (member, name)
                if member in _EXACT_MEMBERS or not w.is_floating_point():
                    assert torch.equal(g, w), (member, name)
                else:
                    assert torch.all((g - w).abs() <= (2 * rows + 8) * 2.0 ** -24 * w.abs()), (member, name)
    with pytest.raises(MetricsTPUUserError, match="reads n_obs on the host"):
        captured.result() if kind == "streaming" else captured.results()


@pytest.mark.requires_cuda
def test_nccl_world_1_bundle_drives_every_kind_on_card(cuda, tmp_path):
    """NCCL at world 1 on the first card: one fused bundle with every kind
    (the f32 sum rider with float and integer leaves, the reduce buckets of
    the widened dtypes, the byte gather, a q8 leaf) gives the world-1
    results, with the collectives the plan names; a collection's
    ``compute_synced`` equals its unsynced value."""
    import torch.distributed as dist

    import metrics_tpu_torch as mp
    from metrics_tpu_torch.parallel import collectives as col

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        rng = np.random.RandomState(0)
        f32 = torch.from_numpy(rng.randn(5, 3).astype(np.float32)).to(cuda)
        i32 = torch.tensor([2**31 - 1, -(2**31), -7], dtype=torch.int32, device=cuda)
        flags = torch.tensor([True, False, True], device=cuda)
        leaves = [("sum", f32), ("sum", i32), ("sum", f32.half()), ("mean", f32.bfloat16()),
                  ("min", i32.to(torch.int16)), ("max", torch.tensor([3, 2**32 - 1], dtype=torch.uint32, device=cuda)),
                  ("max", flags), ("sum", f32.double()), ("sum", i32.long()), ("sum", flags),
                  ("mean", i32.to(torch.int8)), ("cat", f32), (None, i32), (lambda a, b: a + b, f32),
                  ("cat", flags), ("sum", torch.from_numpy(rng.randn(100).astype(np.float32)).to(cuda))]
        precs = ["exact"] * (len(leaves) - 1) + ["q8_block"]
        col.reset_collective_counts()
        out = col.fused_axis_sync(leaves, precisions=precs)
        counts = col.collective_counts()
        plan = col.fused_sync_plan([(fx, v, p) for (fx, v), p in zip(leaves, precs)], 1)
        assert counts["all_reduce"] + counts["all_gather"] == plan["collectives"] == 1 + 8 + 1
        for (fx, v), got in zip(leaves[:-1], out[:-1]):
            assert got.device == v.device
            if fx is None:
                want = v[None]
            elif fx == "sum" and v.dtype == torch.bool:
                want = v.to(torch.int32)
            elif fx == "mean" and not v.dtype.is_floating_point:
                want = v.to(torch.float32)
            else:
                want = v
            bits = (lambda x: x.view(torch.int16) if x.dtype == torch.bfloat16 else x)
            assert got.dtype == want.dtype and np.array_equal(bits(got).cpu().numpy(), bits(want).cpu().numpy()), \
                (fx, v.dtype)
        np.testing.assert_array_equal(out[-1].cpu().numpy(), col.q8_roundtrip(leaves[-1][1]))

        coll = mp.MetricCollection({"acc": mp.Accuracy(device=cuda),
                                    "auroc": mp.AUROC(num_classes=4, capacity=64, device=cuda)})
        p = torch.from_numpy(rng.rand(40, 4).astype(np.float32)).to(cuda)
        t = torch.from_numpy(rng.randint(0, 4, 40)).to(cuda)
        state = coll.update_state(coll.init_state(), p, t)
        want = coll.compute_from(state)
        got = coll.compute_synced(state)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    finally:
        dist.destroy_process_group()


@pytest.mark.requires_cuda
def test_list_lengths_refused_across_two_ranks_on_card(cuda):
    """Two gloo ranks on the first card, their eager AUROC list states of
    8 and 12 rows: ``compute()`` raises on both, naming the state, rather
    than hang or gather garbage."""
    import sys
    from pathlib import Path

    # by its directory: a ``tests`` package installed beside PyTorch can shadow
    # this repository's, and the spawned ranks import the module by name
    sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
    from torch_sync_worker import RankPool

    pool = RankPool(world=2, cuda=True)
    try:
        msgs = pool.run("list_refusal", device="cuda")
    finally:
        pool.close()
    assert all(m is not None and "AUROC.preds (rows per rank: [8, 12])" in m for m in msgs), msgs


# ------------------------------------------------------------ compiled forward

# the entry kinds after three forwards of one signature, pinned on the CPU
# against the JAX package by tests/test_torch_forward.py (same constants)
FWD_FLAGSHIP_KINDS = {"collection": ["compiled"], "acc": ["pending"], "f1": ["pending"], "binned_ap": ["pending"],
                      "confmat": ["pending"]}
FWD_DASHBOARD_KINDS = {"collection": ["compiled"], **{k: ["pending"] for k in (
    "precision", "recall", "specificity", "hamming", "jaccard", "kappa", "mcc", "hinge")}}
FWD_REGRESSION_KINDS = {"collection": ["eager_only"], **{k: ["compiled"] for k in (
    "mse", "rmse", "mae", "msle", "mape", "smape", "explained_variance", "tweedie")}, "r2": ["eager_only"]}


def _fwd_collection(kind, device, c=5):
    import metrics_tpu_torch as mp

    if kind == "flagship":
        return mp.MetricCollection({
            "acc": mp.Accuracy(device=device), "f1": mp.F1Score(num_classes=c, average="macro", device=device),
            "binned_ap": mp.BinnedAveragePrecision(num_classes=c, thresholds=10, device=device),
            "confmat": mp.ConfusionMatrix(num_classes=c, device=device)})
    if kind == "dashboard":
        return mp.MetricCollection({
            "precision": mp.Precision(average="macro", num_classes=c, device=device),
            "recall": mp.Recall(average="macro", num_classes=c, device=device),
            "specificity": mp.Specificity(average="macro", num_classes=c, device=device),
            "hamming": mp.HammingDistance(device=device), "jaccard": mp.JaccardIndex(num_classes=c, device=device),
            "kappa": mp.CohenKappa(num_classes=c, device=device),
            "mcc": mp.MatthewsCorrCoef(num_classes=c, device=device), "hinge": mp.HingeLoss(device=device)})
    return mp.MetricCollection({
        "mse": mp.MeanSquaredError(device=device), "rmse": mp.MeanSquaredError(squared=False, device=device),
        "mae": mp.MeanAbsoluteError(device=device), "msle": mp.MeanSquaredLogError(device=device),
        "mape": mp.MeanAbsolutePercentageError(device=device),
        "smape": mp.SymmetricMeanAbsolutePercentageError(device=device),
        "explained_variance": mp.ExplainedVariance(device=device),
        "tweedie": mp.TweedieDevianceScore(power=1.5, device=device), "r2": mp.R2Score(device=device)})


def _fwd_batches(kind, device, n=4, rows=256, c=5):
    rng = np.random.RandomState(21)
    out = []
    for _ in range(n):
        if kind == "regression":
            t = rng.gamma(2.0, 1.0, rows).astype(np.float32)
            p = (t * np.exp(rng.normal(0.0, 0.3, rows))).astype(np.float32)
            out.append((torch.from_numpy(p).to(device), torch.from_numpy(t).to(device)))
        else:
            p = rng.rand(rows, c).astype(np.float32)
            p /= p.sum(1, keepdims=True)
            out.append((torch.from_numpy(p).to(device), torch.from_numpy(rng.randint(0, c, rows)).to(device)))
    return out


def _fwd_tree_equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_fwd_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_fwd_tree_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind,want", [("flagship", FWD_FLAGSHIP_KINDS), ("dashboard", FWD_DASHBOARD_KINDS),
                                       ("regression", FWD_REGRESSION_KINDS)])
def test_captured_forward_is_bit_equal_to_the_eager_twin(cuda, kind, want):
    """Per-batch values and states of the captured forward (one graph for the
    collection, or each member's own) bit-equal to the eager members' loop,
    and the entry kinds equal to the JAX package's."""
    coll, twin = _fwd_collection(kind, cuda), keep_forward_eager(_fwd_collection(kind, cuda))
    for i, (p, t) in enumerate(_fwd_batches(kind, cuda)):
        assert _fwd_tree_equal(coll(p, t), twin(p, t)), f"{kind}: batch {i}"
        if i == 2:
            kinds = {"collection": forward_entry_kinds(coll),
                     **{k: forward_entry_kinds(m) for k, m in coll.items(keep_base=True)}}
            assert kinds == want
    for k, m in coll.items(keep_base=True):
        assert _fwd_tree_equal(m._pack_state(), twin[k]._pack_state()), k
        assert all(v.is_cuda for v in m._pack_state().values())


@pytest.mark.requires_cuda
def test_forward_value_held_across_a_second_forward(cuda):
    """A batch value, a state tensor and a ``compute()`` result that is a
    state tensor itself (ConfusionMatrix, SumMetric), all kept across a
    captured forward, keep their values: the metric rebinds its state to
    clones of the graph's outputs."""
    import metrics_tpu_torch as mp

    m = mp.MeanSquaredError(device=cuda)
    x = torch.rand(64, device=cuda)
    for _ in range(3):
        m(x, x * 2)
    held = m(x, x * 3)
    want = held.clone()
    total = m.sum_squared_error
    before = total.clone()
    m(x, x * 5)
    assert torch.equal(held, want)
    assert total is not m.sum_squared_error and torch.equal(total, before)
    assert not torch.equal(m.sum_squared_error, before)

    p, t = _fwd_batches("flagship", cuda)[0]
    for cm, batch in ((mp.ConfusionMatrix(num_classes=5, device=cuda), (p, t)), (mp.SumMetric(nan_strategy="ignore", device=cuda), (x,))):
        for _ in range(3):
            cm(*batch)
        assert forward_entry_kinds(cm) == ["compiled"]
        kept = cm.compute()
        kept_values = kept.clone()
        cm(*batch)
        assert torch.equal(kept, kept_values), type(cm).__name__
        assert not torch.equal(cm.compute(), kept_values)


@pytest.mark.requires_cuda
def test_forward_after_to_cpu_and_astype_replays_nothing_stale(cuda):
    """After ``.to("cpu")`` the forward runs on the CPU (no graph replays);
    back on the card in float64 it captures anew: every value and state
    equal to an eager twin moved the same way."""
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.engine.aot import FORWARD_CACHE

    x = torch.rand(64, device=cuda)
    m, twin = mp.MeanSquaredError(device=cuda), mp.MeanSquaredError(device=cuda)
    keep_forward_eager(twin)
    for i in range(3):
        assert torch.equal(m(x, x * i), twin(x, x * i))
    m.to("cpu")
    twin.to("cpu")
    hits = FORWARD_CACHE.hits
    for _ in range(3):
        assert torch.equal(m(x.cpu(), x.cpu() * 3), twin(x.cpu(), x.cpu() * 3))
    assert FORWARD_CACHE.hits == hits and torch.equal(m.sum_squared_error, twin.sum_squared_error)
    m.to(cuda).astype(torch.float64)
    twin.to(cuda).astype(torch.float64)
    for _ in range(3):
        assert torch.equal(m(x, x * 4), twin(x, x * 4))
    assert m.sum_squared_error.dtype == torch.float64 and forward_entry_kinds(m) == ["compiled"]
    assert FORWARD_CACHE.hits == hits + 2 and torch.equal(m.sum_squared_error, twin.sum_squared_error)


@pytest.mark.requires_cuda
def test_failed_capture_leaves_state_and_device_sound(cuda):
    """An update that reads the device on the host is found in the warm-up,
    before any capture: the signature ends eager-only, the state equals the
    eager twin's, and the card still runs another metric's captured
    forward."""
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.engine.aot import FORWARD_CACHE

    class HostRead(mp.Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + float(x.sum().item())

        def compute(self):
            return self.total

    x = torch.rand(64, device=cuda)
    m, twin = HostRead(device=cuda), HostRead(device=cuda)
    eager_only, refusals = FORWARD_CACHE.eager_only, FORWARD_CACHE.host_sync_refusals
    for i in range(4):
        m(x * i)
        twin.update(x * i)
    assert forward_entry_kinds(m) == ["eager_only"] and FORWARD_CACHE.eager_only == eager_only + 1
    assert FORWARD_CACHE.host_sync_refusals == refusals + 1
    assert torch.equal(m.total, twin.total)
    torch.rand(4, device=cuda)
    mse, ref = mp.MeanSquaredError(device=cuda), mp.MeanSquaredError(device=cuda)
    keep_forward_eager(ref)
    for i in range(3):
        assert torch.equal(mse(x, x * i), ref(x, x * i))
    assert forward_entry_kinds(mse) == ["compiled"] and torch.equal(mse.sum_squared_error, ref.sum_squared_error)


@pytest.mark.requires_cuda
def test_a_capture_failing_past_the_warm_up_leaves_the_users_random_graph_alone(cuda):
    """An update that reads the host only while a capture runs gets past the
    warm-up and breaks the capture: the signature ends eager-only with the
    state sound, and the device's random generator is the one it was. A
    graph the user captured before, which draws random numbers, still
    follows ``manual_seed`` and draws apart from the eager draws after it."""
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.engine.aot import FORWARD_CACHE
    class CaptureOnlyRead(mp.Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

        def update(self, x):
            if torch.cuda.is_current_stream_capturing():
                x.sum().item()
            self.total = self.total + x.sum()

        def compute(self):
            return self.total

    drawn = torch.empty(4096, device=cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        drawn.uniform_()
    torch.cuda.current_stream(cuda).wait_stream(side)
    users = torch.cuda.CUDAGraph()
    with torch.cuda.graph(users):
        drawn.uniform_()

    x = torch.rand(64, device=cuda)
    m, twin = CaptureOnlyRead(device=cuda), keep_forward_eager(CaptureOnlyRead(device=cuda))
    refusals = FORWARD_CACHE.host_sync_refusals
    for i in range(4):
        m(x * i)
        twin(x * i)
    assert forward_entry_kinds(m) == ["eager_only"] and torch.equal(m.total, twin.total)
    assert FORWARD_CACHE.host_sync_refusals == refusals  # the capture itself failed

    torch.cuda.manual_seed(7)
    users.replay()
    first = drawn.clone()
    eager = torch.rand(4096, device=cuda)
    torch.cuda.manual_seed(7)
    users.replay()
    assert torch.equal(drawn, first), "manual_seed no longer reaches the user's graph"
    assert not torch.equal(eager, first), "the eager draws repeat the user's graph's"


@pytest.mark.requires_cuda
def test_forward_launches_are_credited_per_replay(cuda):
    """K2 and K3 run inside the flagship's graph: each replay credits the
    launches its capture took back."""
    from metrics_tpu_torch.ops.binned_update import binned_counts_cuda
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda

    coll = _fwd_collection("flagship", cuda)
    batches = _fwd_batches("flagship", cuda, n=6)
    coll(*batches[0])  # eager
    coll(*batches[1])  # warm-up, capture, first replay
    k2, k3 = histogram_cuda.launches, binned_counts_cuda.launches
    for p, t in batches[2:]:
        coll(p, t)
    per_k2, per_k3 = (histogram_cuda.launches - k2) // 4, (binned_counts_cuda.launches - k3) // 4
    assert per_k2 > 0 and per_k3 > 0
    assert histogram_cuda.launches - k2 == 4 * per_k2 and binned_counts_cuda.launches - k3 == 4 * per_k3


@pytest.mark.requires_cuda
def test_deferred_check_raises_after_a_captured_forward(cuda):
    import metrics_tpu_torch as mp

    p, t = _fwd_batches("flagship", cuda)[0]
    m = mp.ConfusionMatrix(num_classes=5, device=cuda)
    for _ in range(3):
        m(p, t)
    assert forward_entry_kinds(m) == ["compiled"]
    m(p, torch.full_like(t, 5))
    for _ in range(2):
        with pytest.raises(ValueError, match="raised deferred"):
            m.compute()
    m.reset()
    m(p, t)
    assert int(m.compute().sum()) == p.shape[0]


# ------------------------------------------------------------------ snapshots and restore


def _snapshot_engine(kind, device, snapdir, cache=None, every=0, in_flight=2):
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine

    q8 = kind == "paged_q8"
    cfg = EngineConfig(buckets=(16, 64), kernel_backend="megastep", compress_payloads=q8, coalesce=1,
                       snapshot_dir=snapdir, snapshot_every=every, in_flight=in_flight)
    coll = _engine_collection(device, q8)
    if kind == "streaming":
        return StreamingEngine(coll, cfg, aot_cache=cache)
    return MultiStreamEngine(coll, 12, cfg, stream_shard=True, resident_streams=3, aot_cache=cache)


def _ptrs(eng):
    return {k: v.data_ptr() for k, v in eng._state.items()}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["streaming", "paged"])
def test_restore_into_a_live_captured_engine_keeps_buffers_and_captures_nothing(cuda, tmp_path, kind):
    """A snapshot restored into the live captured engine it came from is
    written into the engine's buffers in place: every ``data_ptr()`` stays,
    no step is captured again, and the next replayed steps fold on top of the
    restored state (the replay of the second half is bit-equal to the
    uninterrupted run; ``coalesce=1``, counts)."""
    traffic = _engine_traffic(21)
    half = len(traffic) // 2
    eng = _snapshot_engine(kind, cuda, str(tmp_path))
    _drive(eng, traffic[:half], True, cuda)
    path = eng.snapshot()
    want = _drive(eng, traffic[half:], True, cuda)
    ptrs, misses = _ptrs(eng), eng.aot_cache.misses
    meta = eng.restore(path)
    assert meta["batches_done"] == half and _ptrs(eng) == ptrs
    got = _drive(eng, traffic[half:], True, cuda)
    assert _ptrs(eng) == ptrs and eng.aot_cache.misses == misses and eng.stats.resumes == 1
    for g, w in zip(_flat(got), _flat(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.requires_cuda
def test_restore_that_changes_a_host_attribute_captures_a_new_step(cuda, tmp_path):
    """Accuracy's latched input mode is a trace constant of every captured
    step: restoring a multiclass snapshot into an engine latched binary
    re-keys the step, so the next batch captures a new graph under the new
    key instead of replaying the binary one; the value is the multiclass
    one."""
    from metrics_tpu_torch import Accuracy
    from metrics_tpu_torch.engine import AotCache, EngineConfig, StreamingEngine

    multi = StreamingEngine(Accuracy(device=cuda), EngineConfig(buckets=(16,), snapshot_dir=str(tmp_path)))
    p = torch.tensor([[0.1, 0.7, 0.2], [0.6, 0.3, 0.1]], device=cuda)
    with multi:
        multi.submit(p, torch.tensor([1, 2], device=cuda))  # one of two right
        path = multi.snapshot()
    cache = AotCache()
    live = StreamingEngine(Accuracy(device=cuda), EngineConfig(buckets=(16,)), aot_cache=cache)
    with live:
        live.submit(torch.tensor([0.9, 0.2], device=cuda), torch.tensor([1, 0], device=cuda))
    misses = cache.misses
    live.restore(path)
    assert live._metric.mode == "multi-class"
    with live:
        live.submit(p, torch.tensor([1, 0], device=cuda))  # two of two right
    assert cache.misses == misses + 1 and live.stats.warmup_steps == 2
    assert float(live.result()) == pytest.approx(3 / 4)


@pytest.mark.requires_cuda
def test_periodic_snapshot_with_steps_in_flight_equals_the_flushed_state(cuda, tmp_path):
    """The dispatcher's periodic snapshot copies the state after every
    in-flight step folded: with four steps in flight, the snapshot at the
    last batch equals ``state()`` after ``flush()``, bit for bit."""
    from metrics_tpu_torch.engine import load_snapshot

    traffic = _engine_traffic(22, n_batches=24)
    eng = _snapshot_engine("streaming", cuda, str(tmp_path), every=8, in_flight=4)
    state = _drive(eng, traffic, True, cuda)
    assert eng.stats.snapshots == 3 and eng.stats.snapshot_failures == 0
    snap, meta = load_snapshot(str(tmp_path))
    assert meta["batches_done"] == 24
    logical = eng.arena_layout.unpack({k: torch.from_numpy(v).to(cuda) for k, v in snap.items()})
    for g, w in zip(_flat(logical), _flat(state)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.requires_cuda
def test_paged_q8_snapshot_with_staged_rows_loses_none(cuda, tmp_path):
    """Rows staged as int8 codes (their q8 columns still zero in the arena
    until K7 decodes them) are seated before the snapshot copies the arena:
    restored, each staged stream's state is the one it had before staging."""
    traffic = _engine_traffic(23, n_batches=40)
    eng = _snapshot_engine("paged_q8", cuda, str(tmp_path))
    _drive(eng, traffic, True, cuda)
    spilled = sorted(eng.pager.spilled_streams(0))[:3]
    assert spilled
    want = {sid: eng.stream_state(sid) for sid in spilled}
    with eng._device_section():
        eng._page_round(spilled)
    assert int(eng._q8_stage["flags"].sum()) == len(spilled)
    path = eng.snapshot()
    assert int(eng._q8_stage["flags"].sum()) == 0
    restored = _snapshot_engine("paged_q8", cuda, str(tmp_path))
    restored.restore(path)
    for sid in spilled:
        for g, w in zip(_flat(restored.stream_state(sid)), _flat(want[sid])):
            assert torch.equal(g, w)


# ------------------------------------------------------------------ the fault layer


def _chaos_engine(kind, device, inj=None, cache=None, **cfg):
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine

    q8 = kind == "paged_q8"
    config = EngineConfig(buckets=(16, 64), kernel_backend="megastep", compress_payloads=q8, coalesce=1,
                          fault_injector=inj, **cfg)
    coll = _engine_collection(device, q8)
    if kind == "streaming":
        return StreamingEngine(coll, config, aot_cache=cache)
    return MultiStreamEngine(coll, 12, config, stream_shard=True, resident_streams=3, aot_cache=cache)


def _watch_attempts(eng):
    """Per step attempt: K1/K4/K5/K6/K7 launches so far, demotions so far, q8 rows staged so far."""
    from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda
    from metrics_tpu_torch.ops.kernels.megastep_cuda import (
        megastep_fold_cuda,
        megastep_segment_cuda,
        megastep_segment_q8_cuda,
    )
    from metrics_tpu_torch.ops.kernels.segment_cuda import segment_reduce_cuda

    kernels = {"K1": fold_rows_cuda, "K4": segment_reduce_cuda, "K5": megastep_fold_cuda,
               "K6": megastep_segment_cuda, "K7": megastep_segment_q8_cuda}
    seen = []
    do_step = eng._do_step

    def watched(*a, **kw):
        seen.append(dict({k: f.launches for k, f in kernels.items()}, demotions=eng.stats.kernel_demotions,
                         staged=eng.stats.q8_staged_rows))
        return do_step(*a, **kw)

    eng._do_step = watched
    return seen, lambda: {k: f.launches for k, f in kernels.items()}


@pytest.mark.requires_cuda
def test_rollback_after_an_injected_step_fault_keeps_buffers_and_adds_no_capture(cuda):
    """A ``step`` fault fires after the captured replay has written the state
    in place: the rollback copies the shadow back on the engine stream, every
    ``data_ptr()`` stays, the retry replays the same graph (the engine
    captures what its fault-free twin captures), and the state ends
    bit-equal to the twin's."""
    from metrics_tpu_torch.engine import AotCache, FaultInjector, FaultSpec

    traffic = _engine_traffic(31)
    twin = _chaos_engine("streaming", cuda, cache=AotCache())
    want = _drive(twin, traffic, True, cuda)
    inj = FaultInjector(seed=5, plan={"step": FaultSpec(schedule=(1, 4, 9))})
    eng = _chaos_engine("streaming", cuda, inj, cache=AotCache())
    ptrs = _ptrs(eng)
    got = _drive(eng, traffic, True, cuda)
    st = eng.stats
    assert (st.rollbacks, st.retries) == (3, 3) and eng._transactional
    assert _ptrs(eng) == ptrs and eng.aot_cache.misses == twin.aot_cache.misses
    assert st.warmup_steps == twin.stats.warmup_steps
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g, w)


@pytest.mark.requires_cuda
def test_demoted_engine_captures_one_new_step_per_signature(cuda):
    """An injected ``kernel`` fault demotes the megastep engine to the
    per-leaf kernels: K5 stops and K1 runs, the state keeps its buffers,
    each bucket the demoted engine then steps captures once more (the tag
    is in the key), and the state is bit-equal to the undemoted twin's."""
    from metrics_tpu_torch.engine import FaultInjector, FaultSpec

    traffic = _engine_traffic(32, n_batches=30)
    twin = _chaos_engine("streaming", cuda)
    want = _drive(twin, traffic, True, cuda)
    inj = FaultInjector(seed=6, plan={"kernel": FaultSpec(schedule=(12,))})
    eng = _chaos_engine("streaming", cuda, inj)
    seen, launches = _watch_attempts(eng)
    ptrs = _ptrs(eng)
    start = launches()
    got = _drive(eng, traffic, True, cuda)
    end = launches()
    at = next(i for i, r in enumerate(seen) if r["demotions"])
    assert at == 13 and eng.stats.kernel_demotions == 1 and eng._kernel_tag() == "auto"
    assert seen[at]["K5"] > start["K5"] and end["K5"] == seen[at]["K5"]  # K5 before, none after
    assert seen[at]["K1"] == start["K1"] and end["K1"] > seen[at]["K1"]  # K1 after only
    buckets_after = {eng._policy.bucket_for(len(t)) for _, _, t in traffic[12:]}
    buckets_before = {eng._policy.bucket_for(len(t)) for _, _, t in traffic[:12]}
    assert eng.aot_cache.misses == len(buckets_before) + len(buckets_after)
    assert _ptrs(eng) == ptrs
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g, w)


@pytest.mark.requires_cuda
def test_paged_q8_demotion_with_rows_staged_loses_none_on_card(cuda):
    """A ``kernel`` fault at a step whose slots hold q8-staged rows: the
    demoted body seats them with the codec's arithmetic, then K4 folds;
    staging stops after it. Every stream is bit-equal to the undemoted twin
    (K7 decoding on touch), K6 and K7 launch before the demotion and K4
    after it."""
    from metrics_tpu_torch.engine import FaultInjector, FaultSpec

    traffic = _engine_traffic(33, n_batches=60)
    twin = _chaos_engine("paged_q8", cuda)
    twin_seen, _ = _watch_attempts(twin)
    want = _drive(twin, traffic, True, cuda)
    at = next(i for i in range(10, len(twin_seen)) if twin_seen[i]["staged"] > twin_seen[i - 1]["staged"])
    inj = FaultInjector(seed=7, plan={"kernel": FaultSpec(schedule=(at,))})
    eng = _chaos_engine("paged_q8", cuda, inj)
    seen, launches = _watch_attempts(eng)
    ptrs = _ptrs(eng)
    start = launches()
    got = _drive(eng, traffic, True, cuda)
    end = launches()
    assert seen[at]["staged"] > seen[at - 1]["staged"] and seen[at + 1]["demotions"] == 1
    assert seen[at + 1]["K6"] > start["K6"] and seen[at + 1]["K7"] > start["K7"]
    assert (end["K6"], end["K7"]) == (seen[at + 1]["K6"], seen[at + 1]["K7"])
    assert seen[at + 1]["K4"] == start["K4"] and end["K4"] > seen[at + 1]["K4"]
    assert not eng._q8_enabled and eng.stats.q8_staged_rows == seen[at + 1]["staged"]
    assert _ptrs(eng) == ptrs
    for g, w in zip(_flat(got), _flat(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.requires_cuda
def test_a_real_hang_expires_the_watchdog_once_and_recovers(cuda):
    """A device sleep of 1.5x ``step_timeout_s`` enqueued on the idle engine's
    stream ahead of one batch: the step's event misses the deadline once, the
    rollback and the retry queue behind the hang, and the state ends
    bit-equal to the fault-free twin's, every buffer where it was."""
    from metrics_tpu_torch.engine import AotCache

    traffic = _engine_traffic(34, n_batches=12)
    cache = AotCache()
    twin = _chaos_engine("streaming", cuda, cache=cache)
    want = _drive(twin, traffic, True, cuda)
    eng = _chaos_engine("streaming", cuda, cache=cache, step_timeout_s=0.1)
    assert eng._transactional and eng._watchdog_enabled
    eng.start()
    for _, p, t in traffic[:-1]:
        eng.submit(torch.from_numpy(p).to(cuda), torch.from_numpy(t).to(cuda))
    eng.flush()
    ptrs = _ptrs(eng)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    cycles = int(0.15e3 * 10_000_000 / start.elapsed_time(end))  # ~0.15 s
    with torch.cuda.stream(eng._stream):
        torch.cuda._sleep(cycles)
    _, p, t = traffic[-1]
    eng.submit(torch.from_numpy(p).to(cuda), torch.from_numpy(t).to(cuda))
    eng.flush()
    eng.stop()
    st = eng.stats
    assert (st.watchdog_timeouts, st.rollbacks, st.retries) == (1, 1, 1)
    assert st.warmup_steps == 0 and _ptrs(eng) == ptrs
    for g, w in zip(_flat(eng.state()), _flat(want)):
        assert torch.equal(g, w)
