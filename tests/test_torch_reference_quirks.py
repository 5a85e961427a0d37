"""Where the JAX package's TPU kernels and its plain (XLA) paths disagree, the
port follows the kernel. Pinned on the CPU, the JAX kernels in interpret mode.

* **Negative unmasked segment ids.** ``segment_reduce_pallas`` (K4) and
  ``megastep_segment_pallas`` (K6) compare each id with every segment, so a
  negative id addresses none and its row is dropped. The JAX plain versions
  ``segment_reduce_ref`` and ``megastep_segment_ref`` scatter through
  ``.at[ids]``, which wraps a negative id into the last segments. The port's
  kernels and plain versions drop it, as the TPU kernels do. The engines never
  send a negative id (stream and slot ids are checked), so no engine result
  depends on it.
* **A fold over zero rows.** ``fold_rows_pallas`` (K1) cannot run on zero rows
  at all (its block is one row, its slice of the empty input raises), and the
  JAX dispatcher sends zero rows to ``fold_rows_ref``, which raises for
  min/max (an empty ``jnp.min``). The kernel's answer for rows that all fold
  into nothing, one fully masked row, is the state unchanged, for every
  reduction. The port's plain version gives that for zero rows too.

Sums and min/max of small integers: every result is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.ops.kernels import xla_ref as jref
from metrics_tpu.ops.kernels.pallas_fold import fold_rows_pallas
from metrics_tpu.ops.kernels.pallas_megastep import megastep_segment_pallas
from metrics_tpu.ops.kernels.pallas_segment import segment_reduce_pallas
from metrics_tpu_torch.ops.kernels import fold_rows_masked, megastep_segment, segment_reduce_masked
from metrics_tpu_torch.ops.kernels import xla_ref as pref

S, F = 4, 3
IDS = np.array([0, 1, -1, 2, 3, -2, 0, 0], np.int32)
OPS = {"sum": 0, "min": 1, "max": 2}


def _case(seed):
    rng = np.random.RandomState(seed)
    rows = rng.randint(-9, 10, (len(IDS), F)).astype(np.float32)
    # the negative ids' rows past every other value, so a wrapped row moves sums, minima and maxima
    rows[IDS == -1] = [-50.0, 50.0, -50.0]
    rows[IDS == -2] = [50.0, -50.0, 50.0]
    state = rng.randint(-9, 10, (S, F)).astype(np.float32)
    return rows, state


@pytest.mark.parametrize("fx", ["sum", "min", "max"])
def test_segment_kernel_drops_negative_ids_and_the_port_follows(fx):
    rows, state = _case(0)
    mask = np.ones(len(IDS), np.int32)
    kernel = np.asarray(segment_reduce_pallas(jnp.asarray(state), jnp.asarray(rows), jnp.asarray(IDS)[:, None],
                                              jnp.asarray(mask)[:, None], fx, S, 8, True))
    plain_jax = np.asarray(jref.segment_reduce_ref(jnp.asarray(state), jnp.asarray(rows), jnp.asarray(mask, bool),
                                                   jnp.asarray(IDS), S, fx))
    keep = IDS >= 0
    dropped = np.asarray(jref.segment_reduce_ref(jnp.asarray(state), jnp.asarray(rows[keep]),
                                                 jnp.asarray(mask[keep], bool), jnp.asarray(IDS[keep]), S, fx))
    assert np.array_equal(kernel, dropped)  # the TPU kernel drops the negative ids' rows
    assert not np.array_equal(kernel, plain_jax)  # the JAX plain path wraps them
    t = (torch.from_numpy(state), torch.from_numpy(rows), torch.from_numpy(mask.astype(bool)), torch.from_numpy(IDS))
    assert np.array_equal(pref.segment_reduce_ref(t[0], t[1], t[2], t[3], S, fx).numpy(), kernel)
    assert np.array_equal(segment_reduce_masked(t[0], t[1], t[2], t[3], S, fx).numpy(), kernel)


@pytest.mark.parametrize("ops", ["sum", "min", "max", "mixed"])
def test_megastep_segment_kernel_drops_negative_ids_and_the_port_follows(ops):
    rows, state = _case(1)
    mask = np.ones(len(IDS), np.int32)
    op_row = np.array([0, 1, 2], np.int32) if ops == "mixed" else np.full(F, OPS[ops], np.int32)
    uniform = None if ops == "mixed" else ops
    kernel = np.asarray(megastep_segment_pallas(jnp.asarray(state), jnp.asarray(rows), jnp.asarray(IDS)[:, None],
                                                jnp.asarray(mask)[:, None], jnp.asarray(op_row)[None], uniform, S,
                                                8, True))
    plain_jax = np.asarray(jref.megastep_segment_ref(jnp.asarray(state), jnp.asarray(rows), jnp.asarray(mask, bool),
                                                     jnp.asarray(IDS), S, jnp.asarray(op_row)[None]))
    keep = IDS >= 0
    dropped = np.asarray(jref.megastep_segment_ref(jnp.asarray(state), jnp.asarray(rows[keep]),
                                                   jnp.asarray(mask[keep], bool), jnp.asarray(IDS[keep]), S,
                                                   jnp.asarray(op_row)[None]))
    assert np.array_equal(kernel, dropped)
    assert not np.array_equal(kernel, plain_jax)
    t = (torch.from_numpy(state), torch.from_numpy(rows), torch.from_numpy(mask.astype(bool)), torch.from_numpy(IDS))
    assert np.array_equal(pref.megastep_segment_ref(t[0], t[1], t[2], t[3], S, torch.from_numpy(op_row)).numpy(),
                          kernel)
    assert np.array_equal(megastep_segment(t[0], t[1], t[2], t[3], S, op_row).numpy(), kernel)


@pytest.mark.parametrize("fx", ["sum", "min", "max"])
def test_zero_row_fold_is_the_kernels_empty_fold(fx):
    state = np.array([5.0, -2.0, 7.0], np.float32)
    with pytest.raises(Exception):  # the JAX kernel takes no zero-row input
        fold_rows_pallas(jnp.asarray(state)[None], jnp.zeros((0, F), jnp.float32), jnp.zeros((0, 1), jnp.int32),
                         fx, 8, True)
    if fx != "sum":
        with pytest.raises(ValueError):  # nor does the JAX plain version, for min/max
            jref.fold_rows_ref(jnp.asarray(state), jnp.zeros((0, F), jnp.float32), jnp.zeros((0,), bool), fx)
    # the kernel's fold of rows that all drop out: the state unchanged
    garbage = jnp.asarray([[1e6, -1e6, 3.0]], jnp.float32)
    empty = np.asarray(fold_rows_pallas(jnp.asarray(state)[None], garbage, jnp.zeros((1, 1), jnp.int32), fx, 8,
                                        True))[0]
    assert np.array_equal(empty, state)
    st = torch.from_numpy(state)
    for rows, mask in ((torch.zeros((0, F)), torch.zeros(0, dtype=torch.bool)),
                       (torch.from_numpy(np.array(garbage)), torch.zeros(1, dtype=torch.bool))):
        assert np.array_equal(pref.fold_rows_ref(st, rows, mask, fx).numpy(), empty)
        assert np.array_equal(fold_rows_masked(st, rows, mask, fx).numpy(), empty)
