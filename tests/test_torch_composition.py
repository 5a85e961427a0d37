"""The port's ``CompositionalMetric`` and its operators against the JAX
package's, on the CPU.

Every operator case of ``tests/bases/test_composition.py`` runs in both
packages on the same operands (a sum metric fed the same numbers), with the
nesting, forward, reset, ``repr`` and the ``-m``/``+m`` quirks; then a
composition of real metrics, ``2 * P * R / (P + R)`` over macro Precision
and Recall: its state tree (one ``"_children"`` subtree per occurrence of a
shared operand), its eager, masked and segmented updates, its value, and
``to_device``/``astype`` moving its constant operand. Tolerances: integer
states and counts bit-exact, values (f32 on both sides) within
``rtol=1e-6`` plus ``atol=1e-6``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu_torch as mp
from metrics_tpu.ops.kernels import use_backend
from metrics_tpu_torch.metric import CompositionalMetric
from metrics_tpu_torch.utils.state_bridge import state_from_numpy, state_to_numpy
from metrics_tpu_torch.utils.tree import tree_map

RTOL = ATOL = 1e-6
C = 4


class _JaxSum(mt.Metric):
    def __init__(self, dtype=jnp.float32, shape=()):
        super().__init__()
        self.add_state("x", jnp.zeros(shape, dtype), dist_reduce_fx="sum")

    def update(self, x):
        self.x = self.x + x

    def compute(self):
        return self.x


class _PortSum(mp.Metric):
    def __init__(self, dtype=torch.float32, shape=()):
        super().__init__(device="cpu")
        self.add_state("x", torch.zeros(shape, dtype=dtype), dist_reduce_fx="sum")

    def update(self, x):
        self.x = self.x + x

    def compute(self):
        return self.x


def _operands(x, y, integer=False):
    """The two packages' sum metrics holding ``x`` and ``y``."""
    out = []
    for pkg_sum, asarray, dtype in ((_JaxSum, jnp.asarray, jnp.int32 if integer else jnp.float32),
                                    (_PortSum, torch.as_tensor, torch.int32 if integer else torch.float32)):
        pair = []
        for v in (x, y):
            m = pkg_sum(dtype=dtype, shape=np.shape(v))
            m.update(asarray(np.asarray(v, np.int32 if integer else np.float32)))
            pair.append(m)
        out.append(pair)
    return out


def _assert_close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# (name, operation on (a, b), integer operands); a holds 5, b holds 3
OPERATORS = [
    ("add", lambda a, b: a + b, False),
    ("sub", lambda a, b: a - b, False),
    ("mul", lambda a, b: a * b, False),
    ("truediv", lambda a, b: a / b, False),
    ("floordiv", lambda a, b: a // b, False),
    ("mod", lambda a, b: a % b, False),
    ("pow", lambda a, b: a ** b, False),
    ("add_scalar", lambda a, b: a + 2.0, False),
    ("radd_scalar", lambda a, b: 2.0 + a, False),
    ("mul_scalar", lambda a, b: a * 2.0, False),
    ("rsub_scalar", lambda a, b: 10.0 - a, False),
    ("truediv_scalar", lambda a, b: a / 2.0, False),
    ("abs_of_product", lambda a, b: abs(-1.0 * a), False),
    ("neg", lambda a, b: -a, False),
    ("rfloordiv_scalar", lambda a, b: 10.0 // a, False),
    ("floordiv_scalar", lambda a, b: a // 2.0, False),
    ("rmod_scalar", lambda a, b: 12.0 % a, False),
    ("mod_scalar", lambda a, b: a % 2.0, False),
    ("rpow_scalar", lambda a, b: 2.0 ** a, False),
    ("pow_scalar", lambda a, b: a ** 2.0, False),
    ("rtruediv_scalar", lambda a, b: 10.0 / a, False),
    ("rmul_int", lambda a, b: 2 * a, False),
    ("eq", lambda a, b: a == b, False),
    ("ne", lambda a, b: a != b, False),
    ("lt", lambda a, b: a < b, False),
    ("gt", lambda a, b: a > b, False),
    ("le", lambda a, b: a <= b, False),
    ("ge", lambda a, b: a >= b, False),
    ("and", lambda a, b: a & b, True),
    ("or", lambda a, b: a | b, True),
    ("xor", lambda a, b: a ^ b, True),
    ("rand_scalar", lambda a, b: 3 & a, True),
    ("ror_scalar", lambda a, b: 3 | a, True),
    ("rxor_scalar", lambda a, b: 3 ^ a, True),
    ("pos", lambda a, b: +a, False),
    ("abs", lambda a, b: abs(a), False),
    ("nested", lambda a, b: (a + b) * 2.0, False),
]


@pytest.mark.parametrize("op", [o[1] for o in OPERATORS], ids=[o[0] for o in OPERATORS])
def test_operator_matches_jax(op):
    integer = next(i for _, o, i in OPERATORS if o is op)
    (ja, jb), (pa, pb) = _operands(5, 3, integer)
    got, want = op(pa, pb), op(ja, jb)
    assert isinstance(got, CompositionalMetric) and isinstance(want, mt.CompositionalMetric)
    _assert_close(got.compute(), want.compute())


@pytest.mark.parametrize("value", [-5.0, 5.0])
def test_pos_neg_reference_quirks(value):
    """``+m`` is ``abs(m)`` and ``-m`` is ``-abs(m)``, in both packages."""
    (ja, _), (pa, _) = _operands(value, 0.0)
    assert float((+pa).compute()) == abs(value) == float((+ja).compute())
    assert float((-pa).compute()) == -abs(value) == float((-ja).compute())


def test_invert_matches_jax():
    for v in (0, 1):
        (ja, _), (pa, _) = _operands(v, 0, integer=True)
        _assert_close((~pa).compute(), (~ja).compute())


def test_matmul_and_getitem_match_jax():
    (ja, _), (pa, _) = _operands([1.0, 2.0, 3.0], 0.0)
    _assert_close((pa @ torch.tensor([1.0, 1.0, 1.0])).compute(), (ja @ jnp.asarray([1.0, 1.0, 1.0])).compute())
    _assert_close((torch.tensor([2.0, 2.0, 2.0]) @ pa).compute(), (jnp.asarray([2.0, 2.0, 2.0]) @ ja).compute())
    _assert_close(pa[1].compute(), ja[1].compute())


def test_eq_builds_a_metric_and_hash_stays():
    """``==`` builds a composition (always truthy), so code must compare
    metrics with ``is``; ``__hash__`` survives the override."""
    (_, _), (pa, pb) = _operands(5.0, 3.0)
    assert isinstance(pa == pb, CompositionalMetric)
    assert len({pa, pb, pa}) == 2
    coll = mp.MetricCollection({"a": pa, "b": pb})
    assert coll["a"] is pa and coll["b"] is pb


def test_repr_update_forward_reset():
    (ja, jb), (pa, pb) = _operands(1.0, 2.0)
    comp, jcomp = pa + pb, ja + jb
    assert repr(comp).startswith("CompositionalMetric(\n  add(")
    comp.update(torch.tensor(1.0))  # fans out to both operands
    jcomp.update(jnp.asarray(1.0))
    _assert_close(comp.compute(), jcomp.compute())
    # forward: the batch value of each operand, composed
    fresh, jfresh = _PortSum() + _PortSum(), _JaxSum() + _JaxSum()
    _assert_close(fresh(torch.tensor(2.0)), jfresh(jnp.asarray(2.0)))
    comp.reset()
    jcomp.reset()
    _assert_close(comp.compute(), jcomp.compute())
    assert float(comp.compute()) == 0.0


# ------------------------------------------------------------ a composition of real metrics

def _f1_composition(pkg, **kw):
    p = pkg.Precision(num_classes=C, average="macro", **kw)
    r = pkg.Recall(num_classes=C, average="macro", **kw)
    return 2 * p * r / (p + r)


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    p = rng.rand(n, C).astype(np.float32)
    return p / p.sum(1, keepdims=True), rng.randint(0, C, n)


def _assert_tree(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree(g, w, f"{path}[{i}]")
    else:
        _assert_close(got, want)


def test_shared_operand_state_tree_matches_jax():
    """``P`` and ``R`` sit in both branches: each occurrence has its own
    subtree and is updated once per occurrence, so every count is twice the
    plain one (in both packages); the value is unchanged, both ratios
    double."""
    jm, pm = _f1_composition(mt), _f1_composition(mp, device="cpu")
    p, t = _rows(40, 0)
    want = jax.tree.map(np.asarray, jm.update_state(jm.init_state(), jnp.asarray(p), jnp.asarray(t)))
    got = state_to_numpy(pm.update_state(pm.init_state(), torch.from_numpy(p), torch.from_numpy(t)))
    _assert_tree(got, want)
    plain = mp.Precision(num_classes=C, average="macro", device="cpu")
    plain_state = plain.update_state(plain.init_state(), torch.from_numpy(p), torch.from_numpy(t))
    occurrence = got["_children"]["metric_a"]["_children"]["metric_a"]["_children"]["metric_b"]  # 2 * P
    again = got["_children"]["metric_b"]["_children"]["metric_a"]  # P in (P + R)
    for k, v in plain_state.items():
        np.testing.assert_array_equal(occurrence[k], 2 * v.numpy())
        np.testing.assert_array_equal(again[k], 2 * v.numpy())
    # eager: the same P instance holds the doubled counts
    pm.update(torch.from_numpy(p), torch.from_numpy(t))
    jm.update(jnp.asarray(p), jnp.asarray(t))
    _assert_close(pm.compute(), jm.compute())
    np.testing.assert_array_equal(pm.metric_b.metric_a.tp.numpy(), 2 * plain_state["tp"].numpy())


def test_composition_value_is_the_harmonic_mean_of_its_operands():
    """Macro ``2PR/(P+R)`` is the harmonic mean of macro P and R (not macro
    F1, the mean of per-class harmonic means); per class it is F1."""
    p, t = _rows(64, 1)
    comp = _f1_composition(mp, device="cpu")
    comp.update(torch.from_numpy(p), torch.from_numpy(t))
    prec = mp.Precision(num_classes=C, average="macro", device="cpu")(torch.from_numpy(p), torch.from_numpy(t))
    rec = mp.Recall(num_classes=C, average="macro", device="cpu")(torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_allclose(float(comp.compute()), float(2 * prec * rec / (prec + rec)), rtol=RTOL)
    per_class = mp.Precision(num_classes=C, average="none", device="cpu")
    per_class = 2 * per_class * mp.Recall(num_classes=C, average="none", device="cpu") / (
        per_class + mp.Recall(num_classes=C, average="none", device="cpu"))
    per_class.update(torch.from_numpy(p), torch.from_numpy(t))
    f1 = mp.F1Score(num_classes=C, average="none", device="cpu")(torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_allclose(per_class.compute().numpy(), f1.numpy(), rtol=RTOL, atol=ATOL)


def test_masked_and_segmented_updates_match_jax():
    jm, pm = _f1_composition(mt), _f1_composition(mp, device="cpu")
    assert pm.masked_update_strategy() == jm.masked_update_strategy() == "delta"
    assert pm.segmented_update_unsupported_reason() == jm.segmented_update_unsupported_reason() is None
    p, t = _rows(24, 2)
    p[17:] = np.nan  # garbage in the masked rows
    t[17:] = C + 3
    mask = np.arange(24) < 17
    ids = np.random.RandomState(2).randint(0, 3, 24).astype(np.int32)
    with use_backend("xla"):
        want = jm.update_state_masked(jm.init_state(), jnp.asarray(p), jnp.asarray(t), mask=jnp.asarray(mask))
        stacked = jax.tree.map(lambda x: jnp.stack([x] * 3), jm.init_state())
        want_seg = jm.update_state_segmented(stacked, jnp.asarray(p), jnp.asarray(t), mask=jnp.asarray(mask),
                                             segment_ids=jnp.asarray(ids), num_segments=3)
    got = pm.update_state_masked(pm.init_state(), torch.from_numpy(p), torch.from_numpy(t),
                                 mask=torch.from_numpy(mask))
    _assert_tree(state_to_numpy(got), jax.tree.map(np.asarray, want))
    got_seg = pm.update_state_segmented(tree_map(lambda x: torch.stack([x] * 3), pm.init_state()),
                                        torch.from_numpy(p), torch.from_numpy(t), mask=torch.from_numpy(mask),
                                        segment_ids=torch.from_numpy(ids), num_segments=3)
    _assert_tree(state_to_numpy(got_seg), jax.tree.map(np.asarray, want_seg))
    # a JAX state seats in the port and computes the same value
    seated = state_from_numpy(pm, jax.tree.map(np.asarray, want), device="cpu")
    _assert_close(pm.compute_from(seated), jm.compute_from(want))


def test_constant_operand_moves_with_the_composition():
    """A scalar operand is a tensor on the composition's device (int32 or
    f32, as the JAX package's); ``.to()``/``to_device``/``astype`` move or
    cast it with the states and their defaults, so ``reset`` keeps them."""
    (_, _), (pa, _) = _operands(5, 0, integer=True)
    comp = 3 & pa
    assert comp.metric_a.dtype == torch.int32 and comp.metric_a.device.type == "cpu"
    scaled = pa * 2.0
    assert scaled.metric_b.dtype == torch.float32
    moved = (_PortSum() * 2.0).to("meta")
    assert moved.device.type == "meta" and moved.metric_b.device.type == "meta"
    moved.reset()
    assert moved.metric_a.x.device.type == "meta" and moved.metric_a._defaults["x"].device.type == "meta"
    cast = _PortSum() * 2.0
    assert cast.to_device("cpu") is cast and cast.metric_b.device.type == "cpu"
    cast.astype(torch.float64)
    cast.reset()
    assert cast.metric_a.x.dtype == torch.float64 and cast.metric_b.dtype == torch.float64
