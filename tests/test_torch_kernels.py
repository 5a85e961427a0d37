"""The port's kernel library against the JAX package's.

K1 (masked fold), K2 (histogram) and K3 (binned counts) of ``metrics_tpu_torch``
run here through their plain versions (the tensors lie on the CPU). They are
held against ``metrics_tpu``'s dispatcher under ``use_backend("pallas_interpret")``,
the Pallas kernels' own logic interpreted on the CPU, on the case matrix of
``tests/ops/test_kernel_parity.py``. Integer results must be bit-exact; float
sums within the reassociation tolerance of that file. The vmap rules, which
launch one kernel for a whole bucket, are held against the plain version
applied row by row. The CUDA kernels themselves are held against the plain
versions in ``test_torch_cuda.py``.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.ops.binned_update import binned_counts as jax_binned_counts
from metrics_tpu.ops.kernels import fold_rows_masked as jax_fold
from metrics_tpu.ops.kernels import histogram_accumulate as jax_hist
from metrics_tpu.ops.kernels import use_backend
from metrics_tpu_torch.ops.binned_update import binned_counts, binned_counts_torch
from metrics_tpu_torch.ops.kernels import fold_rows_masked, histogram_accumulate
from metrics_tpu_torch.ops.kernels.hist_cuda import fold_batch_into_bins

_RTOL = 1e-6
_ATOL = 1e-5
_MASKS = ("all", "none", "random", "first")


def _mask(pattern, n, rng):
    if pattern == "all":
        return np.ones(n, bool)
    if pattern == "none":
        return np.zeros(n, bool)
    if pattern == "first":
        m = np.zeros(n, bool)
        m[0] = True
        return m
    return rng.rand(n) > 0.5


def _rows_state(dtype, shape, rng):
    if dtype.startswith("int"):
        return (np.asarray(rng.randint(-50, 50, shape), dtype),
                np.asarray(rng.randint(-50, 50, shape[1:]), dtype))
    return np.asarray(rng.randn(*shape), np.float32), np.asarray(rng.randn(*shape[1:]), np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _assert_close(got, want, exact):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        scale = float(np.max(np.abs(want), initial=0.0))
        np.testing.assert_allclose(got, want, rtol=0, atol=_ATOL + _RTOL * scale)


# ------------------------------------------------------------------------ K1 fold

@pytest.mark.parametrize("fx", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("mask_pattern", _MASKS)
def test_fold_matches_pallas_interpret(fx, dtype, mask_pattern):
    rng = np.random.RandomState(zlib.crc32(f"{fx}/{dtype}/{mask_pattern}".encode()))
    for shape in ((13,), (37, 5), (8, 3, 4)):
        rows, state = _rows_state(dtype, shape, rng)
        mask = _mask(mask_pattern, shape[0], rng)
        with use_backend("pallas_interpret"):
            want = jax_fold(jnp.asarray(state, dtype), jnp.asarray(rows, dtype), jnp.asarray(mask), fx)
        tdt = getattr(torch, dtype)
        got = fold_rows_masked(torch.from_numpy(state).to(tdt), torch.from_numpy(rows).to(tdt),
                               torch.from_numpy(mask), fx)
        assert got.dtype == tdt and str(want.dtype) == dtype
        # bf16: both sides round one f32 sum, so agree up to one bf16 step of the result
        if dtype == "bfloat16" and fx == "sum":
            scale = float(np.max(np.abs(_np(want)), initial=1.0))
            np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2.0 ** -7 * scale)
        else:
            _assert_close(got, want, exact=dtype != "float32" or fx != "sum")


def test_fold_int32_wraps_and_limits():
    i32 = np.iinfo(np.int32)
    rows = np.array([[i32.max, i32.min, 5], [1, i32.min, -5], [i32.max, 0, 7]], np.int32)
    state = np.array([i32.max, -1, 0], np.int32)
    mask = np.array([True, True, False])
    for fx in ("sum", "min", "max"):
        with use_backend("pallas_interpret"):
            want = jax_fold(jnp.asarray(state), jnp.asarray(rows), jnp.asarray(mask), fx)
        got = fold_rows_masked(torch.from_numpy(state), torch.from_numpy(rows), torch.from_numpy(mask), fx)
        _assert_close(got, want, exact=True)


def test_fold_zero_rows():
    state = np.arange(3, dtype=np.float32)
    want = jax_fold(jnp.asarray(state), jnp.zeros((0, 3), jnp.float32), jnp.zeros((0,), bool), "sum")
    for fx in ("sum", "min", "max"):
        # no rows fold to the identity, so the state comes back unchanged (the JAX
        # reference reduces an empty array for min/max and raises: only sum compares)
        got = fold_rows_masked(torch.from_numpy(state), torch.zeros((0, 3)), torch.zeros((0,), dtype=torch.bool), fx)
        _assert_close(got, want, exact=True)


def test_fold_rejects_unknown_reduction():
    with pytest.raises(ValueError):
        fold_rows_masked(torch.zeros(2), torch.zeros(3, 2), torch.ones(3, dtype=torch.bool), "mean")


# ------------------------------------------------------------------- K2 histogram

@pytest.mark.parametrize("length", [1, 7, 128, 300])
@pytest.mark.parametrize("mask_pattern", _MASKS)
def test_histogram_counts_match_pallas_interpret(length, mask_pattern):
    rng = np.random.RandomState(zlib.crc32(f"{length}/{mask_pattern}".encode()))
    n = 211
    idx = rng.randint(-3, length + 3, n).astype(np.int32)  # out of range on both sides
    mask = _mask(mask_pattern, n, rng)
    with use_backend("pallas_interpret"):
        want = jax_hist(jnp.asarray(idx), length, mask=jnp.asarray(mask))
        want_u = jax_hist(jnp.asarray(idx), length)
    got = histogram_accumulate(torch.from_numpy(idx), length, mask=torch.from_numpy(mask))
    got_u = histogram_accumulate(torch.from_numpy(idx), length)
    assert got.dtype == got_u.dtype == torch.int32
    _assert_close(got, want, exact=True)
    _assert_close(got_u, want_u, exact=True)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(jnp.bincount(jnp.asarray(idx), length=length)))


@pytest.mark.parametrize("k", [1, 3])
def test_histogram_weighted_matches_pallas_interpret(k):
    rng = np.random.RandomState(11)
    n, length = 157, 19
    idx = rng.randint(0, length, n).astype(np.int32)
    w = rng.rand(n, k).astype(np.float32)
    w = w[:, 0] if k == 1 else w
    mask = rng.rand(n) > 0.5
    with use_backend("pallas_interpret"):
        want = jax_hist(jnp.asarray(idx), length, weights=jnp.asarray(w), mask=jnp.asarray(mask))
    got = histogram_accumulate(torch.from_numpy(idx), length, weights=torch.from_numpy(w), mask=torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_histogram_bf16_weights_keep_their_dtype():
    rng = np.random.RandomState(3)
    idx = rng.randint(0, 9, 64).astype(np.int32)
    w = rng.rand(64, 2).astype(np.float32)
    with use_backend("pallas_interpret"):
        want = jax_hist(jnp.asarray(idx), 9, weights=jnp.asarray(w, jnp.bfloat16))
    got = histogram_accumulate(torch.from_numpy(idx), 9, weights=torch.from_numpy(w).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2.0 ** -7, atol=0)


def test_histogram_refuses_integer_weights():
    with pytest.raises(TypeError, match="f32 or bf16"):
        histogram_accumulate(torch.zeros(3, dtype=torch.int32), 4, weights=torch.ones(3, dtype=torch.int32))


@pytest.mark.parametrize("length", [4, 100])
def test_histogram_vmap_rule_matches_rows(length):
    """The vmap rule folds the batch into the bin index: one call for all rows."""
    rng = np.random.RandomState(length)
    rows = torch.from_numpy(rng.randint(-2, length + 2, (64, 3)).astype(np.int32))
    got = torch.func.vmap(lambda i: histogram_accumulate(i, length))(rows)
    want = torch.stack([histogram_accumulate(r, length) for r in rows])
    assert got.dtype == torch.int32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    w = torch.from_numpy(rng.rand(64, 3, 2).astype(np.float32))
    got_w = torch.func.vmap(lambda i, ww: histogram_accumulate(i, length, weights=ww))(rows, w)
    want_w = torch.stack([histogram_accumulate(r, length, weights=ww) for r, ww in zip(rows, w)])
    torch.testing.assert_close(got_w, want_w, rtol=0, atol=1e-6)


def test_fold_batch_into_bins_drops_out_of_range():
    idx = torch.tensor([[-1, 2, 3], [0, 5, 1]], dtype=torch.int32)
    flat = fold_batch_into_bins(idx, 4)
    assert flat.tolist() == [0, 2, 3, 4, 8, 5]  # 5 >= L maps to B*L = 8, which drops


# --------------------------------------------------------------- K3 binned counts

@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("n,c,t", [(64, 3, 11), (37, 5, 7), (1, 1, 1)])
def test_binned_counts_match_pallas_interpret(n, c, t, edge):
    rng = np.random.RandomState(n * 100 + c * 10 + t)
    preds = rng.rand(n, c).astype(np.float32)
    target = rng.rand(n, c) > 0.6
    if edge:  # NaN never counts as positive; -inf pad rows with target 0 count nowhere
        preds[0, 0] = np.nan
        preds[-1] = -np.inf
        target[-1] = False
    thresholds = np.linspace(0, 1, t).astype(np.float32)
    with use_backend("pallas_interpret"):
        want = jax_binned_counts(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(thresholds))
    got = binned_counts(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(thresholds))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _assert_close(g, w, exact=True)


def test_binned_counts_pad_rows_count_nowhere():
    thresholds = torch.linspace(0, 1, 5)
    preds = torch.full((4, 2), float("-inf"))
    tp, fp, fn = binned_counts(preds, torch.zeros(4, 2, dtype=torch.bool), thresholds)
    assert float(tp.sum() + fp.sum() + fn.sum()) == 0.0


def test_binned_vmap_rule_matches_rows():
    """The vmap rule widens the class axis: (B, 1, C) rows in one call."""
    rng = np.random.RandomState(5)
    b, c, t = 48, 4, 9
    preds = torch.from_numpy(rng.rand(b, 1, c).astype(np.float32))
    preds[3, 0, 1] = float("nan")
    target = torch.from_numpy(rng.rand(b, 1, c) > 0.5)
    thresholds = torch.linspace(0, 1, t)
    got = torch.func.vmap(lambda p, y: binned_counts(p, y, thresholds))(preds, target)
    want = [torch.stack(x) for x in zip(*(binned_counts_torch(p, y, thresholds) for p, y in zip(preds, target)))]
    for g, w in zip(got, want):
        assert g.shape == (b, c, t)
        torch.testing.assert_close(g, w, rtol=0, atol=0)


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
    return thr


@pytest.mark.parametrize("kind", ["unsorted", "duplicated", "infinite", "nan"])
@pytest.mark.parametrize("nan_preds", [False, True])
@pytest.mark.parametrize("n,c,t", [(67, 3, 8), (1, 40, 12), (5, 3, 7)])
def test_binned_counts_match_pallas_interpret_on_any_thresholds(kind, nan_preds, n, c, t):
    """What the CUDA kernel must count: thresholds in any order, repeated,
    infinite or NaN, against preds with NaN, +-inf and -inf pad rows (target 0), held
    bit for bit against the Pallas kernel's own logic."""
    rng = np.random.RandomState(zlib.crc32(f"{kind}/{nan_preds}/{n}/{c}/{t}".encode()))
    preds = rng.rand(n, c).astype(np.float32)
    target = rng.rand(n, c) > 0.6
    if nan_preds:
        preds.reshape(-1)[::5] = np.nan
        preds.reshape(-1)[1::5] = np.inf
        preds[-1] = -np.inf
        target[-1] = False
    thresholds = _odd_thresholds(kind, t, rng)
    with use_backend("pallas_interpret"):
        want = jax_binned_counts(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(thresholds))
    got = binned_counts(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(thresholds))
    for g, w in zip(got, want):
        _assert_close(g, w, exact=True)
