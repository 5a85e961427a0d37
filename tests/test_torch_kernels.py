"""The port's kernel library against the JAX package's.

K1 (masked fold), K2 (histogram) and K3 (binned counts) of ``metrics_tpu_torch``
run here through their plain versions (the tensors lie on the CPU). They are
held against ``metrics_tpu``'s dispatcher under ``use_backend("pallas_interpret")``,
the Pallas kernels' own logic interpreted on the CPU, on the case matrix of
``tests/ops/test_kernel_parity.py``. Integer results must be bit-exact; float
sums within the reassociation tolerance of that file. The vmap rules, which
launch one kernel for a whole bucket, are held against the plain version
applied row by row and, for K2, against ``jax.vmap`` of the reference in
every batched/unbatched combination of its arguments. K2's int64 and f64
weights, and int64 indices past int32, have numpy as their oracle: JAX
without x64 narrows them to 32 bits. The CUDA kernels themselves are held
against the plain versions in ``test_torch_cuda.py``.
"""
import zlib

import jax
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


def _weights(dtype, shape, rng):
    """Weights that overflow the narrow integer dtypes when summed (both sides
    wrap), and floats of mixed sign."""
    if dtype in ("float16", "float64"):
        return (rng.randn(*shape) * 100).astype(dtype)
    info = np.iinfo(dtype)
    lo, hi = (info.min, info.max) if dtype != "int64" else (-(2**40), 2**40)
    w = rng.randint(lo, hi, shape, dtype=np.int64).astype(dtype)
    if dtype == "int64":
        w.flat[::7] = np.int64(2**62)  # 64-bit sums wrap too
    return w


def _numpy_hist(idx, length, w, mask):
    """The oracle: a bincount in the weights' own dtype, one add per row."""
    v = np.clip(np.asarray(idx, np.int64), 0, None)
    keep = mask & (v < length)
    out = np.zeros((length,) + w.shape[1:], w.dtype)
    np.add.at(out, v[keep], w[keep])
    return out


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "uint8", "float16"])
def test_histogram_weight_dtypes_match_the_reference(dtype):
    """Integer and f16 weights sum in their own dtype, as the reference's
    ``histogram_ref`` does: integers exactly (wrapping), f16 within
    n * 2**-11 * sum|w| a cell (the reference adds in f16, the port in f32 and
    rounds once)."""
    rng = np.random.RandomState(zlib.crc32(dtype.encode()))
    n, length = 211, 7
    idx = rng.randint(-2, length + 2, n).astype(np.int32)
    w = _weights(dtype, (n, 2), rng)
    mask = rng.rand(n) > 0.3
    with use_backend("pallas_interpret"):
        want = jax_hist(jnp.asarray(idx), length, weights=jnp.asarray(w), mask=jnp.asarray(mask))
    got = histogram_accumulate(torch.from_numpy(idx), length, weights=torch.from_numpy(w),
                               mask=torch.from_numpy(mask))
    assert str(got.dtype) == f"torch.{dtype}" and str(want.dtype) == dtype
    if dtype == "float16":
        abs_sums = _numpy_hist(idx, length, np.abs(w.astype(np.float64)), mask)
        assert (np.abs(got.numpy().astype(np.float64) - np.asarray(want, np.float64)) <= n * 2.0**-11 * abs_sums).all()
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), _numpy_hist(idx, length, w, mask))


@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_histogram_64bit_weights_match_numpy(dtype):
    """int64 and f64 weights keep 64 bits (JAX without x64 narrows them to 32,
    so numpy is the oracle): int64 exactly, wrapping; f64 within the f64
    reassociation bound."""
    rng = np.random.RandomState(zlib.crc32(dtype.encode()))
    n, length = 300, 11
    idx = rng.randint(-2, length + 2, n).astype(np.int64)
    w = _weights(dtype, (n,), rng)
    mask = rng.rand(n) > 0.3
    got = histogram_accumulate(torch.from_numpy(idx), length, weights=torch.from_numpy(w),
                               mask=torch.from_numpy(mask))
    want = _numpy_hist(idx, length, w, mask)
    assert str(got.dtype) == f"torch.{dtype}" and got.shape == (length,)
    if dtype == "int64":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        bound = 2 * n * 2.0**-53 * _numpy_hist(idx, length, np.abs(w), mask)
        assert (np.abs(got.numpy() - want) <= bound).all()


@pytest.mark.parametrize("dtype", [torch.bool, torch.complex64])
def test_histogram_refuses_bool_and_complex_weights(dtype):
    with pytest.raises(TypeError, match=str(dtype)):
        histogram_accumulate(torch.zeros(3, dtype=torch.int32), 4, weights=torch.ones(3, dtype=dtype))


def _past_int32(idx, length, rng):
    """int64 indices past int32 on both sides, some of which would land in
    range if they wrapped (2**32 + 1 -> 1), and what they mean to a 32-bit
    reference: a positive one drops (index ``length``), a negative one counts
    in bin 0 (index -1)."""
    far = np.array([2**31, 2**32 + 1, 2**33 + length - 1, 2**62, -(2**31) - 1, -(2**40)], np.int64)
    idx.flat[::4] = rng.choice(far, idx.flat[::4].shape)
    return np.where(idx >= 2**31, length, np.where(idx < -(2**31), -1, idx)).astype(np.int32)


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


@pytest.mark.parametrize("idx_dtype", ["int32", "int64"])
@pytest.mark.parametrize("length", [1, 100, 300])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_histogram_vmap_matches_pallas_interpret(b, n, length, idx_dtype):
    """The vmapped confusion-matrix call (one row of N indices per batch
    element) against ``jax.vmap`` of the reference's Pallas kernel, with
    negatives, indices >= L and, for int64, indices past int32 (which drop or
    count in bin 0, never wrap): exact, and exact against numpy row by row."""
    rng = np.random.RandomState(zlib.crc32(f"{b}/{n}/{length}/{idx_dtype}".encode()))
    idx = rng.randint(-3, length + 3, (b, n)).astype(idx_dtype)
    jax_idx = _past_int32(idx, length, rng) if idx_dtype == "int64" else idx
    with use_backend("pallas_interpret"):
        want = jax.vmap(lambda i: jax_hist(i, length))(jnp.asarray(jax_idx))
    got = torch.func.vmap(lambda i: histogram_accumulate(i, length))(torch.from_numpy(idx))
    assert got.dtype == torch.int32 and got.shape == (b, length)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    oracle = [_numpy_hist(row, length, np.ones(n, np.int32), np.ones(n, bool)) for row in idx]
    np.testing.assert_array_equal(got.numpy(), np.stack(oracle))


_IN_DIMS = [(i, m, w) for i in (0, None) for m in ("none", 0, None) for w in ("none", 0, None)
            if 0 in (i, m, w)]


@pytest.mark.parametrize("idx_dim, mask_dim, w_dim", _IN_DIMS)
def test_histogram_vmap_in_dims_match_pallas_interpret(idx_dim, mask_dim, w_dim):
    """Every batched/unbatched combination of indices, mask and weights
    ("none": not passed) through the vmap rule, against ``jax.vmap`` of the
    reference with the same axes: counts exact, f32 sums within the
    reassociation bound 2 * n * 2**-24 * sum|w| a cell."""
    rng = np.random.RandomState(zlib.crc32(f"{idx_dim}/{mask_dim}/{w_dim}".encode()))
    b, n, length, k = 8, 3, 7, 2

    def draw(dim, shape, make):
        return None if dim == "none" else make((b,) + shape if dim == 0 else shape)

    idx = draw(idx_dim, (n,), lambda s: rng.randint(-2, length + 2, s).astype(np.int64))
    mask = draw(mask_dim, (n,), lambda s: rng.rand(*s) > 0.4)
    w = draw(w_dim, (n, k), lambda s: rng.randn(*s).astype(np.float32))
    dims = tuple(None if d == "none" else d for d in (idx_dim, mask_dim, w_dim))
    with use_backend("pallas_interpret"):
        want = jax.vmap(lambda i, m, ww: jax_hist(i, length, weights=ww, mask=m), in_axes=dims)(
            *(None if x is None else jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
              for x in (idx, mask, w)))
    got = torch.func.vmap(lambda i, m, ww: histogram_accumulate(i, length, weights=ww, mask=m), in_dims=dims)(
        *(None if x is None else torch.from_numpy(x) for x in (idx, mask, w)))
    shape = (b, length) if w is None else (b, length, k)
    assert got.shape == shape and got.dtype == (torch.int32 if w is None else torch.float32)
    if w is None:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    rows = [(idx if idx_dim is None else idx[r], np.ones(n, bool) if mask is None else
             (mask if mask_dim is None else mask[r]), np.abs(w if w_dim is None else w[r])) for r in range(b)]
    bound = 2 * n * 2.0**-24 * np.stack([_numpy_hist(i, length, aw, m) for i, m, aw in rows])
    assert (np.abs(got.numpy() - np.asarray(want)) <= bound).all()


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
