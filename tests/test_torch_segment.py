"""The port's segment-reduce and megastep primitives against the JAX package's.

``segment_reduce_masked`` (K4's dispatch), ``megastep_fold`` (K5) and
``megastep_segment`` (K6, and K7 with q8 staging) run here on the CPU, where
the tensor's device picks their plain versions. The same numpy inputs go
through ``metrics_tpu.ops.kernels.dispatch`` with the Pallas kernels in
interpret mode (``use_backend("pallas_interpret"/"megastep_interpret")``, as
the JAX package's own tests run them) and through the JAX ``xla_ref`` twins.

Ints, min and max must be bit-exact. Float sums: the inputs are small
integers, so f32 sums are exact too. A bf16 sum rounds twice in each package,
the rows' sum and then its add to the state, so each cell may differ by
``2**-8 * (2|R| + |got| + |want|)``, R being the cell's exact sum of its rows
(numpy, float64): zero where a cell takes no rows. Masked rows carry
garbage ids (negative, S, 2**31 - 1); unmasked ids stay in ``[0, S)``, where
the JAX plain path's ``.at[ids]`` and the kernels agree (a negative unmasked
id wraps there and drops in the kernels).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.ops.kernels import dispatch as jd
from metrics_tpu.ops.kernels import use_backend
from metrics_tpu.ops.kernels import xla_ref as jref
from metrics_tpu_torch.ops.kernels import dispatch as pd

DTYPES = {"float32": (jnp.float32, torch.float32), "int32": (jnp.int32, torch.int32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
S, N, F = 7, 61, 9
N_ONE_STREAM = 257  # on the card the kernel cuts a segment this long into five 64-row chunks


def _case(seed, dtype, n=N, s=S, nan=True, one_stream=False):
    """Rows, state, bool mask and int32 ids; with ``one_stream`` every unmasked
    row carries one id (the engines' step), else ids are random in ``[0, S)``.
    Masked rows carry garbage ids either way. One stream's rows lie in
    {-1, 0, 1}, so every partial sum of its segment is an integer of at most
    256 in magnitude, exact in bf16: the JAX plain path's bf16 scatter-add
    rounds once per row, which the tolerance does not cover."""
    rng = np.random.RandomState(seed)
    rows = rng.randint(-1, 2, (n, F)) if one_stream else rng.randint(-50, 50, (n, F))
    rows = rows.astype(np.float32)
    state = rng.randint(-50, 50, (s, F)).astype(np.float32)
    if dtype != "int32" and nan and n > 5:
        rows[3, 1] = np.nan
        rows[5, 2] = -np.inf
    mask = rng.rand(n) > 0.3
    ids = rng.randint(0, s, n).astype(np.int32)
    if one_stream:
        ids[:] = rng.randint(0, s)
    ids[~mask] = rng.choice([-7, s, 2**31 - 1], int((~mask).sum()))
    return rows, state, mask, ids


def _j(x, dtype):
    return jnp.asarray(x, DTYPES[dtype][0])


def _t(x, dtype):
    return torch.from_numpy(np.asarray(x)).to(DTYPES[dtype][1])


def _row_sums(rows, mask, ids, s):
    """Each cell's exact sum of the unmasked rows its segment id addresses."""
    out = np.zeros((s, rows.shape[1]))
    np.add.at(out, ids[mask], rows[mask].astype(np.float64))
    return out


def _assert_same(got, want, dtype, sum_cols, row_sums):
    """Bit-exact, except bf16 sums (columns where ``sum_cols``), which may
    differ by two bf16 roundings on each side (module docstring)."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    if dtype == "bfloat16":
        tol = 2.0**-8 * (2 * np.abs(row_sums) + np.abs(g) + np.abs(w))
        with np.errstate(invalid="ignore"):
            same |= np.broadcast_to(sum_cols, g.shape) & (np.abs(g - w) <= tol)
    assert same.all(), (g[~same], w[~same])


def _ops(kind, seed):
    if kind in ("sum", "min", "max"):
        return np.full(F, ("sum", "min", "max").index(kind), np.int32)
    return np.random.RandomState(seed).randint(0, 3, F).astype(np.int32)


def _segment_reduce_parity(dtype, fx, rows, state, mask, ids):
    with use_backend("pallas_interpret"):
        kern = jd.segment_reduce_masked(_j(state, dtype), _j(rows, dtype), jnp.asarray(mask), jnp.asarray(ids), S, fx)
    ref = jref.segment_reduce_ref(_j(state, dtype), _j(rows, dtype), jnp.asarray(mask), jnp.asarray(ids), S, fx)
    got = pd.segment_reduce_masked(_t(state, dtype), _t(rows, dtype), torch.from_numpy(mask), torch.from_numpy(ids),
                                   S, fx)
    sums = _row_sums(rows, mask, ids, S)
    _assert_same(got, kern, dtype, fx == "sum", sums)
    _assert_same(got, ref, dtype, fx == "sum", sums)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fx", ["sum", "min", "max"])
def test_segment_reduce_matches_jax(dtype, fx):
    _segment_reduce_parity(dtype, fx, *_case(0, dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fx", ["sum", "min", "max"])
def test_segment_reduce_matches_jax_on_one_stream(dtype, fx):
    """The multi-stream engine's step: every unmasked row in one segment."""
    _segment_reduce_parity(dtype, fx, *_case(6, dtype, n=N_ONE_STREAM, one_stream=True))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ops", ["sum", "min", "max", "mixed"])
def test_megastep_fold_matches_jax(dtype, ops):
    rows, state, mask, _ = _case(1, dtype)
    op = _ops(ops, 1)
    with use_backend("megastep_interpret"):
        kern = jd.megastep_fold(_j(state[0], dtype), _j(rows, dtype), jnp.asarray(mask), op)
    ref = jref.megastep_fold_ref(_j(state[:1], dtype), _j(rows, dtype), jnp.asarray(mask), jnp.asarray(op)[None])
    got = pd.megastep_fold(_t(state[0], dtype), _t(rows, dtype), torch.from_numpy(mask), op)
    sums = _row_sums(rows, mask, np.zeros(len(mask), np.int64), 1)[0]
    _assert_same(got, kern, dtype, op == 0, sums)
    _assert_same(got, np.asarray(ref)[0], dtype, op == 0, sums)


def _megastep_segment_parity(dtype, op, rows, state, mask, ids):
    with use_backend("megastep_interpret"):
        kern = jd.megastep_segment(_j(state, dtype), _j(rows, dtype), jnp.asarray(mask), jnp.asarray(ids), S, op)
    ref = jref.megastep_segment_ref(_j(state, dtype), _j(rows, dtype), jnp.asarray(mask), jnp.asarray(ids), S,
                                    jnp.asarray(op)[None])
    got = pd.megastep_segment(_t(state, dtype), _t(rows, dtype), torch.from_numpy(mask), torch.from_numpy(ids), S, op)
    sums = _row_sums(rows, mask, ids, S)
    _assert_same(got, kern, dtype, op == 0, sums)
    _assert_same(got, ref, dtype, op == 0, sums)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ops", ["sum", "min", "max", "mixed"])
def test_megastep_segment_matches_jax(dtype, ops):
    _megastep_segment_parity(dtype, _ops(ops, 2), *_case(2, dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ops", ["sum", "min", "max", "mixed"])
def test_megastep_segment_matches_jax_on_one_stream(dtype, ops):
    """The paged engine's step: every unmasked row in one slot."""
    _megastep_segment_parity(dtype, _ops(ops, 7), *_case(7, dtype, n=N_ONE_STREAM, one_stream=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [N, 0])
def test_megastep_segment_q8_decode_matches_jax(dtype, n):
    """Flagged slots decode ``f32(codes) * scales`` first, whether a row
    touches them or not, and also on a step without rows."""
    rows, state, mask, ids = _case(3, dtype, nan=False)
    rows, mask, ids = rows[:n], mask[:n], ids[:n]
    rng = np.random.RandomState(4)
    flags = (np.arange(S) % 3 != 1).astype(np.int32)
    codes = rng.randint(-127, 128, (S, F)).astype(np.int8)
    scales = rng.rand(S, F).astype(np.float32)
    qcol = np.arange(F) < 6
    op = _ops("mixed", 3)
    with use_backend("megastep_interpret"):
        kern = jd.megastep_segment(_j(state, dtype), _j(rows, dtype), jnp.asarray(mask), jnp.asarray(ids), S, op,
                                   q8=(flags, codes, scales, qcol))
    got = pd.megastep_segment(_t(state, dtype), _t(rows, dtype), torch.from_numpy(mask), torch.from_numpy(ids), S,
                              op, q8=(torch.from_numpy(flags), torch.from_numpy(codes), torch.from_numpy(scales), qcol))
    # the decoded f32 values are not integers: sums agree to f32 rounding
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(kern).astype(jnp.float32))
    np.testing.assert_allclose(g, w, rtol=2.0**-7 if dtype == "bfloat16" else 1e-6, atol=1e-5)
    if n == 0:  # nothing folds: the decode alone, bit for bit
        assert np.array_equal(g, w)


def test_empty_steps_return_the_state():
    """The megastep forms return the state itself on a step without rows
    (and without q8 staging), as the JAX dispatcher does; the segment reduce
    folds nothing into it."""
    state = torch.arange(2 * F, dtype=torch.float32).reshape(2, F)
    empty = torch.zeros((0, F))
    none = torch.zeros(0, dtype=torch.bool)
    for fx in ("sum", "min", "max"):
        assert torch.equal(pd.segment_reduce_masked(state, empty, none, none.int(), 2, fx), state)
    row = state[0]
    assert pd.megastep_fold(row, empty, none, np.zeros(F, np.int32)) is row
    assert pd.megastep_segment(state, empty, none, none.int(), 2, np.zeros(F, np.int32)) is state


def test_a_canonical_op_row_is_reused():
    """An :class:`OpRow` from ``_op_row_info`` passes through the megastep
    forms as given (a plan canonicalizes its rows once), with the same
    result as the host row; one of the wrong width raises."""
    rows, state, mask, ids = _case(5, "float32", nan=False)
    op = _ops("mixed", 5)
    canon = pd._op_row_info(op, F, torch.device("cpu"))
    assert canon.uniform is None and pd._op_row_info(canon, F, torch.device("cpu")) is canon
    assert pd._op_row_info(np.full(F, 2, np.int32), F, torch.device("cpu")).uniform == "max"
    args = (_t(state, "float32"), _t(rows, "float32"), torch.from_numpy(mask), torch.from_numpy(ids), S)
    assert torch.equal(pd.megastep_segment(*args, canon), pd.megastep_segment(*args, op))
    assert torch.equal(pd.megastep_fold(args[0][0], args[1], args[2], canon), pd.megastep_fold(args[0][0], args[1], args[2], op))
    with pytest.raises(ValueError, match="does not fit"):
        pd.megastep_fold(torch.zeros(F + 1), torch.zeros((2, F + 1)), torch.ones(2, dtype=torch.bool), canon)


def test_megastep_plan_canonicalizes_each_op_row_once():
    """The plan keeps one canonical op row per arena dtype and device across
    steps, so no step re-derives it from the host row."""
    from metrics_tpu_torch import Accuracy, ConfusionMatrix, MetricCollection
    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine

    coll = MetricCollection({"acc": Accuracy(device="cpu"), "cm": ConfusionMatrix(num_classes=3, device="cpu")})
    eng = StreamingEngine(coll, EngineConfig(buckets=(8,), kernel_backend="megastep"))
    rng = np.random.RandomState(6)
    eng.submit(torch.from_numpy(rng.rand(5, 3).astype(np.float32)), torch.from_numpy(rng.randint(0, 3, 5)))
    eng.flush()  # the dispatcher has run the first step
    plan = eng._megastep_plan
    first = dict(plan._op_rows)
    eng.submit(torch.from_numpy(rng.rand(7, 3).astype(np.float32)), torch.from_numpy(rng.randint(0, 3, 7)))
    eng.flush()
    assert first and set(first) == {(k, torch.device("cpu")) for k in plan.eligible_keys()}
    assert all(plan._op_rows[k] is v for k, v in first.items())


def test_opcode_rows_are_validated():
    state = torch.zeros(F)
    rows = torch.zeros((2, F))
    with pytest.raises(ValueError, match="columns"):
        pd.megastep_fold(state, rows, torch.ones(2, dtype=torch.bool), np.zeros(F + 1, np.int32))
    with pytest.raises(ValueError, match="opcodes"):
        pd.megastep_fold(state, rows, torch.ones(2, dtype=torch.bool), np.full(F, 3, np.int32))


@pytest.mark.parametrize("wrapper", ["fold_rows", "segment_reduce", "megastep_fold", "megastep_segment",
                                     "megastep_segment_q8"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """A kernel wrapper takes CUDA tensors only and raises on CPU ones, before
    any build and without counting a launch: the CPU path is the dispatcher's
    plain version, never a wrapper's fallback."""
    from metrics_tpu_torch.ops.kernels import fold_cuda, megastep_cuda, segment_cuda

    state, rows = torch.zeros((S, F)), torch.zeros((N, F))
    mask, ids, ops = torch.ones(N, dtype=torch.int32), torch.zeros(N, dtype=torch.int32), torch.zeros(F, dtype=torch.int32)
    q8 = (torch.zeros(S, dtype=torch.int32), torch.zeros((S, F), dtype=torch.int8), torch.zeros((S, F)), ops)
    module, args = {
        "fold_rows": (fold_cuda, (state[0], rows, mask, "sum")),
        "segment_reduce": (segment_cuda, (state, rows, mask, ids, "sum")),
        "megastep_fold": (megastep_cuda, (state[0], rows, mask, ops, "sum")),
        "megastep_segment": (megastep_cuda, (state, rows, mask, ids, ops, "sum")),
        "megastep_segment_q8": (megastep_cuda, (state, rows, mask, ids, ops, "sum", *q8)),
    }[wrapper]
    fn = getattr(module, f"{wrapper}_cuda")
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA device"):
        fn(*args)
    assert fn.launches == before
