"""The port's audio metrics and functionals against the JAX package, on the CPU.

The same seeded numpy signals go to both packages: speech-like sources
(formant-shaped noise under a syllable-rate envelope, about a fifth of each
signal silent) and estimates made of the source, the other speaker's
leakage and white noise. Covered: SNR, SI-SNR and SI-SDR with and without
``zero_mean``; SDR at three filter lengths with and without ``load_diag``,
at its default 512 on speech and on pure tones, and of a silent target
(NaN in both), its Levinson solve's plain version against a float64 LU; PIT at 2, 3 and 4 speakers (4 takes
scipy's assignment outside a trace and the exhaustive search inside one)
and ``pit_permutate``; STOI and ESTOI at 8, 10 and 16 kHz, the resampler
alone and the 1e-5 sentinel; PESQ through a fake ``pesq`` module in both
packages and its gate; every module class over three uneven updates, its
states dtype-equal to JAX's (``total`` int32); the compiled forward; the
deprecated aliases; the state bridge both ways mid-stream.
"""
import doctest
import importlib
import sys
import types
import warnings

import numpy as np
import pytest
import scipy.linalg
import torch

import jax
import jax.numpy as jnp

import metrics_tpu as mt
import metrics_tpu.functional as jf
import metrics_tpu_torch as mp
import metrics_tpu_torch.functional as pf
from metrics_tpu_torch.metric import forward_entry_kinds
from metrics_tpu_torch.ops.kernels.toeplitz_cuda import toeplitz_solve, toeplitz_solve_plain
from metrics_tpu_torch.utils.checks import traced_rows
from metrics_tpu_torch.utils.state_bridge import state_from_numpy, state_to_numpy

CPU = torch.device("cpu")
p_sdr = importlib.import_module("metrics_tpu_torch.functional.audio.sdr")
j_sdr = importlib.import_module("metrics_tpu.functional.audio.sdr")
DB_TOL = 1e-4  # SNR, SI-SNR, SI-SDR, PIT over them (dB)
SDR_TOL = 1e-3  # SDR (dB): f32 FFTs and LU of two libraries, at SDRs up to ~25 dB
STOI_TOL = 1e-4


# --------------------------------------------------------------------- the signals

def speech(rng, n, fs):
    """One speech-like signal: noise shaped by three formant bumps, under a
    4 Hz syllable envelope, with a fifth of it silent in one stretch."""
    spec = np.fft.rfft(rng.randn(n))
    f = np.fft.rfftfreq(n, 1.0 / fs)
    shape = sum(np.exp(-0.5 * ((f - c * (0.8 + 0.4 * rng.rand())) / 150.0) ** 2) for c in (500.0, 1500.0, 2500.0))
    x = np.fft.irfft(spec * (shape + 0.02), n)
    t = np.arange(n) / fs
    env = np.abs(np.sin(np.pi * 4.0 * t + rng.rand() * np.pi)) ** 1.5
    lo = int(rng.uniform(0.1, 0.6) * n)
    env[lo:lo + n // 5] = 0.0
    x = x * env
    return (x / (np.abs(x).max() + 1e-9)).astype(np.float32)


def sources(seed, batch, spk, n, fs):
    rng = np.random.RandomState(seed)
    return np.stack([[speech(rng, n, fs) for _ in range(spk)] for _ in range(batch)])


def estimates(seed, target, leak=(0.1, 0.2), snr_db=(5.0, 25.0)):
    """Each source plus the next speaker's leakage and white noise at an SNR drawn from ``snr_db``."""
    rng = np.random.RandomState(seed + 1000)
    lead = target.shape[:-1]
    other = np.roll(target, 1, axis=1) if target.ndim == 3 else target[::-1]
    noise = rng.randn(*target.shape).astype(np.float32)
    p_sig = np.mean(target**2, axis=-1, keepdims=True)
    snr = rng.uniform(*snr_db, size=lead + (1,))
    noise *= np.sqrt(p_sig / 10 ** (snr / 10)).astype(np.float32)
    return (target + rng.uniform(*leak, size=lead + (1,)) * other + noise).astype(np.float32)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(to_np(v) for v in x)
    return np.asarray(x)


def close(got, want, atol, what=""):
    g, w = np.asarray(to_np(got), np.float64), np.asarray(to_np(want), np.float64)
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=what)


def same_state(pstate, jstate, atol, what=""):
    """Every leaf of JAX's dtype and shape; integer leaves bit-equal, float leaves within ``atol``."""
    assert sorted(pstate) == sorted(jstate), what
    for k, jv in jstate.items():
        p_, j_ = to_np(pstate[k]), np.asarray(jv)
        assert p_.dtype == j_.dtype, f"{what}.{k}: dtype {p_.dtype} != {j_.dtype}"
        assert p_.shape == j_.shape, f"{what}.{k}: shape {p_.shape} != {j_.shape}"
        if np.issubdtype(j_.dtype, np.integer):
            np.testing.assert_array_equal(p_, j_, err_msg=f"{what}.{k}")
        else:
            np.testing.assert_allclose(p_, j_, rtol=0, atol=atol, err_msg=f"{what}.{k}")


# --------------------------------------------------------------------- functionals

SNR_FAMILY = {
    "snr": (lambda pkg, p, t, **kw: pkg.signal_noise_ratio(p, t, **kw), {}),
    "snr_zero_mean": (lambda pkg, p, t, **kw: pkg.signal_noise_ratio(p, t, zero_mean=True, **kw), {}),
    "si_snr": (lambda pkg, p, t, **kw: pkg.scale_invariant_signal_noise_ratio(p, t, **kw), {}),
    "si_sdr": (lambda pkg, p, t, **kw: pkg.scale_invariant_signal_distortion_ratio(p, t, **kw), {}),
    "si_sdr_zero_mean": (lambda pkg, p, t, **kw: pkg.scale_invariant_signal_distortion_ratio(p, t, zero_mean=True,
                                                                                            **kw), {}),
}


@pytest.mark.parametrize("shape", [(800,), (4, 800), (3, 2, 640)])
@pytest.mark.parametrize("name", sorted(SNR_FAMILY))
def test_snr_family_matches_jax(name, shape):
    fn, _ = SNR_FAMILY[name]
    t = sources(1, 1, int(np.prod(shape[:-1])), shape[-1], 8000).reshape(shape)
    p = estimates(1, t.reshape((-1,) + shape[-1:])[None])[0].reshape(shape) + 0.05  # a DC offset for zero_mean
    got = fn(pf, p, t, device="cpu")
    assert got.device == CPU and got.dtype == torch.float32 and tuple(got.shape) == shape[:-1]
    close(got, fn(jf, p, t), DB_TOL, name)
    # tensors in, the tensors' device out
    close(fn(pf, torch.from_numpy(p), torch.from_numpy(t)), fn(jf, p, t), DB_TOL, name)


def test_si_sdr_of_integer_inputs_takes_float32_eps_as_jax():
    rng = np.random.RandomState(3)
    t = rng.randint(-50, 50, (3, 64)).astype(np.int32)
    p = (t + rng.randint(-5, 5, (3, 64))).astype(np.int32)
    for zm in (False, True):
        close(pf.scale_invariant_signal_distortion_ratio(p, t, zero_mean=zm, device="cpu"),
              jf.scale_invariant_signal_distortion_ratio(p, t, zero_mean=zm), DB_TOL, f"int zero_mean={zm}")


@pytest.mark.parametrize("load_diag", [None, 1e-3])
@pytest.mark.parametrize("filter_length", [8, 32, 64])
def test_sdr_matches_jax(filter_length, load_diag):
    """SDRs spread over 0-25 dB: eight signals at noise levels from 0 to 25 dB."""
    t = sources(10 + filter_length, 1, 8, 1200, 8000)[0]
    p = estimates(10, t, leak=(0.0, 0.0), snr_db=(0.0, 25.0))
    for zero_mean in (False, True):
        want = np.asarray(jf.signal_distortion_ratio(p, t, filter_length=filter_length, zero_mean=zero_mean,
                                                     load_diag=load_diag))
        got = pf.signal_distortion_ratio(p, t, filter_length=filter_length, zero_mean=zero_mean,
                                         load_diag=load_diag, device="cpu")
        assert 0.0 < want.min() and want.max() < 30.0, want
        close(got, want, SDR_TOL, f"L={filter_length} load_diag={load_diag} zero_mean={zero_mean}")
    # use_cg_iter is accepted and ignored, as in JAX
    close(pf.signal_distortion_ratio(p, t, use_cg_iter=10, filter_length=filter_length, device="cpu"),
          jf.signal_distortion_ratio(p, t, filter_length=filter_length), SDR_TOL, "use_cg_iter")


def test_sdr_of_a_silent_target_is_nan_as_jax():
    """A silent target makes the Toeplitz system singular: JAX's solve gives
    NaN, and so does the port's Levinson recursion, with no exception. An
    estimate equal to its target has the exact solution ``e_1``: the port's
    float64 recursion returns it, so its coherence is the f32 zero lag ``r0``
    and its SDR ``10 log10(r0 / (1 - r0))``, with ``1 - r0`` two f32 spacings
    (~70 dB). JAX's f32 LU rounds its coherence to a neighbouring f32 value,
    and one spacing of ``1 - r0`` is 3 dB, so that row is held to JAX in the
    coherence: JAX's, recovered from its SDR, lies within two f32 spacings of
    ``r0``. A noisy estimate is held to JAX within SDR_TOL."""
    p = sources(4, 1, 3, 600, 8000)[0]
    t = np.zeros_like(p)
    t[1] = p[1]
    t[2] = p[2]
    p[2] = estimates(4, p[2][None], leak=(0.0, 0.0), snr_db=(10.0, 10.0))[0]
    want = np.asarray(jf.signal_distortion_ratio(p, t, filter_length=16))
    got = pf.signal_distortion_ratio(p, t, filter_length=16, device="cpu")
    assert np.isnan(want[0]) and torch.isnan(got[0])
    close(got[2:], want[2:], SDR_TOL, "the noisy row")
    tn = p_sdr._normalize(torch.from_numpy(t[1:2]))
    acf, xcorr = p_sdr._compute_autocorr_crosscorr(tn, tn, corr_len=16)
    e1 = torch.zeros(16, dtype=torch.float32)
    e1[0] = 1.0
    torch.testing.assert_close(toeplitz_solve(acf, xcorr)[0], e1, rtol=0, atol=0)
    r0 = float(acf[0, 0])
    assert float(got[1]) == pytest.approx(10 * np.log10(r0 / (1 - r0)), abs=1e-4) and float(got[1]) > 60.0
    ratio = 10.0 ** (float(want[1]) / 10.0)
    assert abs(ratio / (1.0 + ratio) - r0) <= 2 * float(np.spacing(np.float32(r0))), (want[1], got[1], r0)
    # half precision and integers widen to float32, as in JAX
    close(pf.signal_distortion_ratio(torch.from_numpy(p).half(), torch.from_numpy(p).half() + 0.01, filter_length=8),
          jf.signal_distortion_ratio(jnp.asarray(p, jnp.float16), jnp.asarray(p, jnp.float16) + 0.01, filter_length=8),
          SDR_TOL, "f16")


PIT_METRICS = {
    "si_snr": (lambda pkg: pkg.scale_invariant_signal_noise_ratio, {}),
    "snr": (lambda pkg: pkg.signal_noise_ratio, {"zero_mean": True}),
    "sdr": (lambda pkg: pkg.signal_distortion_ratio, {"filter_length": 16}),
}
PIT_CASES = [(spk, ev, "si_snr") for spk in (2, 3, 4) for ev in ("max", "min")] + [
    (2, "max", "sdr"), (4, "min", "sdr"), (3, "min", "snr"), (4, "max", "snr")]


@pytest.mark.parametrize("spk, eval_func, metric", PIT_CASES)
def test_pit_matches_jax(spk, eval_func, metric):
    """Identical best permutations (half the rows with speakers shuffled),
    values within the metric's tolerance; 4 speakers take scipy's path in both."""
    get, kw = PIT_METRICS[metric]
    t = sources(20 + spk, 6, spk, 700, 8000)
    p = estimates(20 + spk, t)
    rng = np.random.RandomState(spk)
    for b in range(0, 6, 2):
        p[b] = p[b][rng.permutation(spk)]
    jm, jperm = jf.pit(p, t, get(jf), eval_func, **kw)
    pmv, pperm = pf.pit(p, t, get(pf), eval_func, device="cpu", **kw)
    np.testing.assert_array_equal(to_np(pperm), np.asarray(jperm))
    close(pmv, jm, SDR_TOL if metric == "sdr" else DB_TOL, f"pit {metric}")
    # pit_permutate: as JAX's, and undone by the inverse permutation
    pp = pf.pit_permutate(torch.from_numpy(p), pperm)
    close(pp, jf.pit_permutate(jnp.asarray(p), jperm), 0.0, "pit_permutate")
    inverse = torch.argsort(pperm, dim=1)
    np.testing.assert_array_equal(to_np(pf.pit_permutate(pp, inverse)), p)


def test_pit_inside_a_trace_takes_the_exhaustive_search_at_four_speakers(monkeypatch):
    """JAX takes scipy's assignment only for a concrete matrix; inside a
    trace the port searches exhaustively, never reading the matrix on the host."""
    pit_mod = importlib.import_module("metrics_tpu_torch.functional.audio.pit")
    t = sources(30, 4, 4, 500, 8000)
    p = estimates(30, t)[:, [2, 0, 3, 1]]
    eager = pf.pit(p, t, pf.scale_invariant_signal_noise_ratio, device="cpu")

    def refuse(*_a, **_k):
        raise AssertionError("the host assignment ran inside a trace")

    monkeypatch.setattr(pit_mod, "_find_best_perm_by_linear_sum_assignment", refuse)
    with traced_rows():
        traced = pf.pit(p, t, pf.scale_invariant_signal_noise_ratio, device="cpu")
    np.testing.assert_array_equal(to_np(traced[1]), to_np(eager[1]))
    close(traced[0], eager[0], 1e-5, "traced value")


def test_pit_argument_errors_match_jax():
    t = sources(5, 2, 2, 300, 8000)
    for bad in ({"eval_func": "mean"},):
        with pytest.raises(ValueError, match="eval_func"):
            jf.pit(t, t, jf.signal_noise_ratio, **bad)
        with pytest.raises(ValueError, match="eval_func"):
            pf.pit(t, t, pf.signal_noise_ratio, device="cpu", **bad)
    for pkg, kw in ((jf, {}), (pf, {"device": "cpu"})):
        with pytest.raises(ValueError, match="batch, spk"):
            pkg.pit(t[0, 0], t[0, 0], pkg.signal_noise_ratio, **kw)
        with pytest.raises(RuntimeError, match="same shape"):
            pkg.pit(t, t[:, :1], pkg.signal_noise_ratio, **kw)


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("fs", [8000, 10000, 16000])
def test_stoi_matches_jax(fs, extended):
    t = sources(40 + fs // 1000, 2, 2, fs, fs)
    p = estimates(40, t)
    got = pf.stoi(p, t, fs, extended=extended, device="cpu")
    assert got.shape == (2, 2) and got.dtype == torch.float32
    close(got, jf.stoi(p, t, fs, extended=extended), STOI_TOL, f"stoi fs={fs} extended={extended}")
    # one signal: a 0-d score
    close(pf.stoi(p[0, 0], t[0, 0], fs, extended=extended, device="cpu"),
          jf.stoi(p[0, 0], t[0, 0], fs, extended=extended), STOI_TOL, "one signal")


@pytest.mark.parametrize("fs", [8000, 16000, 44100, 20000])
def test_resampler_matches_jax(fs):
    """The polyphase path (8, 16, 44.1 kHz) and the decimation conv (20 kHz) to 10 kHz."""
    j_stoi = importlib.import_module("metrics_tpu.functional.audio.stoi")
    p_stoi = importlib.import_module("metrics_tpu_torch.functional.audio.stoi")
    x = np.random.RandomState(fs).randn(3, fs // 4).astype(np.float32)
    want = np.asarray(j_stoi._resample(jnp.asarray(x), fs, 10_000))
    got = p_stoi._resample(torch.from_numpy(x), fs, 10_000)
    close(got, want, 1e-5, f"resample {fs}")
    taps_j, taps_p = j_stoi._resample_plan(fs, 10_000), p_stoi._resample_plan(fs, 10_000)
    np.testing.assert_array_equal(taps_p[0], taps_j[0])
    assert taps_p[1:] == taps_j[1:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1, 1), (3, 2), (2, 3, 7), (4, 64)])
def test_toeplitz_solve_plain_matches_a_float64_lu(shape, dtype):
    """K8's plain version (the Levinson recursion in float64) against numpy's
    float64 LU of the full matrix, on the autocorrelations of seeded noise
    plus a loaded diagonal, batched over leading dims; the dispatcher takes
    it for CPU tensors."""
    rng = np.random.RandomState(sum(shape))
    lead, length = shape[:-1], shape[-1]
    sig = rng.randn(*lead, 4 * length + 8)
    r = np.stack([np.correlate(s, s, "full")[s.size - 1:s.size - 1 + length] for s in sig.reshape(-1, sig.shape[-1])])
    r = r.reshape(*lead, length) / r[..., :1].reshape(*lead, 1)
    r[..., 0] += 0.1
    b = rng.randn(*lead, length)
    lag = np.abs(np.arange(length)[:, None] - np.arange(length)[None, :])
    want = np.linalg.solve(r[..., lag], b[..., None])[..., 0]
    rt, bt = torch.from_numpy(r).to(dtype), torch.from_numpy(b).to(dtype)
    got = toeplitz_solve_plain(rt, bt)
    assert got.dtype == dtype and got.shape == rt.shape
    tol = 1e-5 if dtype == torch.float32 else 1e-10
    np.testing.assert_allclose(got.double().numpy(), want, rtol=tol, atol=tol)
    torch.testing.assert_close(toeplitz_solve(rt, bt), got, rtol=0, atol=0)


def test_sdr_at_filter_length_512_matches_jax():
    """At SDR's default ``filter_length`` of 512 on 4-second 8 kHz speech
    (phase 22's form): the Levinson solve against JAX's LU within SDR_TOL,
    with and without ``load_diag``; every score finite."""
    t = sources(90, 3, 2, 32000, 8000)
    p = estimates(90, t)
    for load_diag in (None, 1e-3):
        want = np.asarray(jf.signal_distortion_ratio(p, t, load_diag=load_diag))
        got = pf.signal_distortion_ratio(p, t, load_diag=load_diag, device="cpu")
        assert np.isfinite(want).all() and torch.isfinite(got).all()
        close(got, want, SDR_TOL, f"L=512 load_diag={load_diag}")


def tone(f0, noise, n=32000, fs=8000):
    t = np.sin(2 * np.pi * f0 * np.arange(n) / fs).astype(np.float32)[None]
    return (t + noise * np.random.RandomState(1).randn(n).astype(np.float32)), t


def float64_sdr(p, t, length=512):
    """SDR of the port's own f32 system solved in float64 two ways, by
    numpy's LU of the full matrix and by scipy's ``solve_toeplitz``
    (Levinson), with the matrix's smallest eigenvalue."""
    acf, xcorr = p_sdr._compute_autocorr_crosscorr(p_sdr._normalize(torch.from_numpy(t)),
                                                   p_sdr._normalize(torch.from_numpy(p)), corr_len=length)
    a, b = p_sdr._toeplitz(acf.double()).numpy(), xcorr.double().numpy()
    lu = np.linalg.solve(a, b[..., None])[..., 0]
    levinson = np.stack([scipy.linalg.solve_toeplitz(r, y) for r, y in zip(acf.double().numpy(), b)])

    def db(sol):
        coh = np.einsum("...l,...l->...", b, sol)
        return 10 * np.log10(coh / (1 - coh))

    return db(lu), db(levinson), np.linalg.eigvalsh(a)[..., 0]


@pytest.mark.parametrize("noise", [0.3, 0.05])
def test_sdr_of_a_pure_tone_target(noise):
    """A pure-tone target makes the Toeplitz system near-singular (its
    smallest eigenvalue is ~1e-6 of the unit zero lag at L = 512). At 1 kHz
    the f32 system stays positive definite, and the port gives JAX's value
    within SDR_TOL. At 440 Hz the f32 autocorrelation matrix is numerically
    indefinite (smallest eigenvalue < 0): there JAX's f32 LU itself lies
    more than 1e-2 dB from the float64 LU of the same system, while the
    port stays within 5e-3 dB of it. Two independent float64 solves witness
    that: numpy's LU and scipy's ``solve_toeplitz`` agree within 1e-5 dB.
    Both packages give finite values, which no tolerance of 1e-3 dB can tie."""
    p, t = tone(1000, noise)
    *_, low = float64_sdr(p, t)
    assert 0.0 < low[0] < 1e-5
    close(pf.signal_distortion_ratio(p, t, device="cpu"), jf.signal_distortion_ratio(p, t), SDR_TOL, "1 kHz tone")
    p, t = tone(440, noise)
    lu, levinson, low = float64_sdr(p, t)
    assert low[0] < 0.0
    close(levinson, lu, 1e-5, "440 Hz tone, scipy's Levinson vs numpy's LU")
    got, want = pf.signal_distortion_ratio(p, t, device="cpu").numpy(), np.asarray(jf.signal_distortion_ratio(p, t))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    for witness, name in ((lu, "numpy's LU"), (levinson, "scipy's Levinson")):
        close(got, witness, 5e-3, f"440 Hz tone, port vs {name}")
        assert np.abs(want - witness).min() > 1e-2, (want, witness, name)


def test_stoi_and_sdr_ignore_the_process_matmul_precision():
    """The port pins full float32 on its own contractions, as the JAX package
    pins ``HIGHEST`` on its ops: with float32 matmuls at "medium" (bf16
    passes where the CPU has them) the scores are bit-equal to those at
    "highest", and the caller's setting is restored after each call."""
    t = sources(61, 2, 2, 8000, 8000)
    p = estimates(61, t)
    saved = torch.get_float32_matmul_precision()
    runs = []
    try:
        for precision in ("medium", "highest"):
            torch.set_float32_matmul_precision(precision)
            runs.append([pf.stoi(p, t, 8000, device="cpu"), pf.stoi(p, t, 8000, extended=True, device="cpu"),
                         pf.signal_distortion_ratio(p, t, filter_length=64, device="cpu")])
            assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision(saved)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    close(runs[0][0], jf.stoi(p, t, 8000), STOI_TOL, "stoi at medium")


def test_stoi_sentinel_and_length_check_match_jax():
    """Fewer than 30 kept frames give 1e-5 in both; a signal with no frame raises in both."""
    fs = 10_000
    t = sources(50, 1, 2, 3000, fs)[0]  # ~22 frames: no whole segment
    p = estimates(50, t)
    got = pf.stoi(p, t, fs, device="cpu")
    close(got, jf.stoi(p, t, fs), 0.0, "sentinel")
    np.testing.assert_allclose(to_np(got), 1e-5)
    # a long signal that is loud for a moment only: silent-frame removal leaves < 30 frames
    t2 = np.zeros((2, 12_000), np.float32)
    t2[:, 5000:7000] = sources(51, 1, 2, 2000, fs)[0]
    p2 = estimates(51, t2)
    close(pf.stoi(p2, t2, fs, device="cpu"), jf.stoi(p2, t2, fs), 0.0, "mostly silent")
    for pkg, kw in ((jf, {}), (pf, {"device": "cpu"})):
        with pytest.raises(ValueError, match="more than 256 samples"):
            pkg.stoi(p[:, :200], t[:, :200], fs, **kw)
    # an empty batch: no scores, in both
    empty = np.zeros((0, 2, 8000), np.float32)
    assert tuple(pf.stoi(empty, empty, 8000, device="cpu").shape) == np.asarray(jf.stoi(empty, empty, 8000)).shape


# --------------------------------------------------------------------- PESQ

class FakePesq:
    """Stands in for the native ``pesq`` package: canned, order-revealing scores."""

    def __init__(self):
        self.calls = []

    def module(self):
        mod = types.ModuleType("pesq")

        def fake(fs, ref, deg, mode):
            assert isinstance(ref, np.ndarray) and ref.ndim == 1 and deg.ndim == 1
            self.calls.append((fs, float(ref.sum()), float(deg.sum()), mode))
            return 1.0 + 0.5 * ((len(self.calls) - 1) % 7)

        mod.pesq = fake
        return mod


@pytest.fixture()
def fake_pesq(monkeypatch):
    backend = FakePesq()
    monkeypatch.setitem(sys.modules, "pesq", backend.module())
    for name in ("metrics_tpu.functional.audio.pesq", "metrics_tpu.audio.pesq",
                 "metrics_tpu_torch.functional.audio.pesq", "metrics_tpu_torch.audio.pesq"):
        monkeypatch.setattr(importlib.import_module(name), "_PESQ_AVAILABLE", True)
    return backend


def test_pesq_without_the_package_raises_in_both():
    if importlib.import_module("metrics_tpu_torch.functional.audio.pesq")._PESQ_AVAILABLE:  # pragma: no cover
        pytest.skip("the native pesq package is installed here")
    x = np.zeros(8000, np.float32)
    for fn in (lambda: pf.pesq(x, x, 8000, "nb", device="cpu"), lambda: mp.PESQ(8000, "nb", device="cpu"),
               lambda: jf.pesq(x, x, 8000, "nb"), lambda: mt.PESQ(8000, "nb")):
        with pytest.raises(ModuleNotFoundError, match="pip install pesq"):
            fn()


def test_pesq_plumbing_matches_jax_under_a_fake_backend(fake_pesq):
    t = sources(60, 2, 3, 800, 8000)
    p = estimates(60, t)
    want = np.asarray(jf.pesq(p, t, 8000, "nb"))
    jax_calls, fake_pesq.calls[:] = list(fake_pesq.calls), []
    got = pf.pesq(p, t, 8000, "nb", device="cpu")
    assert fake_pesq.calls == jax_calls  # the same order and arguments: target first
    assert got.dtype == torch.float32 and got.shape == (2, 3)
    close(got, want, 0.0, "pesq")
    fake_pesq.calls[:] = []
    one = pf.pesq(torch.from_numpy(p[0, 0]), torch.from_numpy(t[0, 0]), 16000, "wb")
    fake_pesq.calls[:] = []
    close(one, jf.pesq(p[0, 0], t[0, 0], 16000, "wb"), 0.0, "one signal")
    assert one.shape == () and one.dtype == torch.float32
    for pkg, kw in ((jf, {}), (pf, {"device": "cpu"})):
        with pytest.raises(ValueError, match="8000 or 16000"):
            pkg.pesq(p, t, 44100, "wb", **kw)
        with pytest.raises(ValueError, match="'wb' or 'nb'"):
            pkg.pesq(p, t, 16000, "xb", **kw)
        with pytest.raises(RuntimeError, match="same shape"):
            pkg.pesq(p, t[..., :-1], 16000, "wb", **kw)
        for cls_kw in ({"fs": 44100, "mode": "wb"}, {"fs": 16000, "mode": "xb"}):
            with pytest.raises(ValueError):
                (mt.PESQ(**cls_kw) if pkg is jf else mp.PESQ(device="cpu", **cls_kw))


def test_pesq_module_matches_jax_under_a_fake_backend(fake_pesq):
    t = sources(61, 5, 2, 400, 16000)
    p = estimates(61, t)
    jm = mt.PESQ(16000, "wb")
    for lo, hi in ((0, 2), (2, 3), (3, 5)):
        jm.update(p[lo:hi], t[lo:hi])
    fake_pesq.calls[:] = []
    pm = mp.PESQ(16000, "wb", device="cpu")
    for lo, hi in ((0, 2), (2, 3), (3, 5)):
        pm.update(p[lo:hi], t[lo:hi])
    same_state(pm._pack_state(), jm._pack_state(), 0.0, "PESQ")
    close(pm.compute(), jm.compute(), 1e-6, "PESQ")


def test_pesq_state_crosses_from_jax_mid_stream_and_back_under_a_fake_backend(fake_pesq):
    """The fake's scores follow its call count, which runs on across the
    packages: JAX's two updates then the port's third give the whole
    stream's state, and the other way round."""
    t = sources(62, 5, 2, 400, 8000)
    p = estimates(62, t)
    splits = ((0, 2), (2, 3), (3, 5))
    fake_pesq.calls[:] = []
    whole = mt.PESQ(8000, "nb")
    for lo, hi in splits:
        whole.update(p[lo:hi], t[lo:hi])
    fake_pesq.calls[:] = []
    jm, pm = mt.PESQ(8000, "nb"), mp.PESQ(8000, "nb", device="cpu")
    for lo, hi in splits[:2]:
        jm.update(p[lo:hi], t[lo:hi])
    pm._load_state(state_from_numpy(pm, jax.tree.map(np.asarray, jm._pack_state()), device="cpu"))
    pm.update(p[3:5], t[3:5])
    same_state(pm._pack_state(), whole._pack_state(), 0.0, "PESQ JAX -> port")
    fake_pesq.calls[:] = []
    pm2, jm2 = mp.PESQ(8000, "nb", device="cpu"), mt.PESQ(8000, "nb")
    for lo, hi in splits[:2]:
        pm2.update(p[lo:hi], t[lo:hi])
    jm2._load_state(jax.tree.map(jnp.asarray, state_to_numpy(pm2._pack_state())))
    jm2.update(p[3:5], t[3:5])
    same_state(pm._pack_state(), jm2._pack_state(), 0.0, "PESQ port -> JAX")
    close(jm2.compute(), whole.compute(), 0.0, "PESQ")


# --------------------------------------------------------------------- module classes

def audio_cases():
    """name -> (class name, a function of the package giving the kwargs, preds, target)."""
    t2 = sources(70, 7, 2, 600, 8000)
    p2 = estimates(70, t2)
    p2[::2] = p2[::2, ::-1]
    t_stoi = sources(71, 7, 2, 8000, 8000)
    p_stoi = estimates(71, t_stoi)
    return {
        "SignalNoiseRatio": ("SignalNoiseRatio", lambda pkg: {}, p2, t2),
        "SignalNoiseRatio_zero_mean": ("SignalNoiseRatio", lambda pkg: {"zero_mean": True}, p2, t2),
        "ScaleInvariantSignalNoiseRatio": ("ScaleInvariantSignalNoiseRatio", lambda pkg: {}, p2, t2),
        "ScaleInvariantSignalDistortionRatio": ("ScaleInvariantSignalDistortionRatio", lambda pkg: {}, p2, t2),
        "ScaleInvariantSignalDistortionRatio_zero_mean": ("ScaleInvariantSignalDistortionRatio",
                                                          lambda pkg: {"zero_mean": True}, p2, t2),
        "SignalDistortionRatio": ("SignalDistortionRatio", lambda pkg: {"filter_length": 32}, p2, t2),
        "SignalDistortionRatio_load_diag": ("SignalDistortionRatio",
                                            lambda pkg: {"filter_length": 16, "load_diag": 1e-3, "zero_mean": True},
                                            p2, t2),
        "PermutationInvariantTraining": ("PermutationInvariantTraining",
                                         lambda pkg: {"metric_func": pkg.functional.scale_invariant_signal_noise_ratio},
                                         p2, t2),
        "PermutationInvariantTraining_sdr_min": (
            "PermutationInvariantTraining",
            lambda pkg: {"metric_func": pkg.functional.signal_distortion_ratio, "eval_func": "min",
                         "filter_length": 16}, p2, t2),
        "STOI": ("STOI", lambda pkg: {"fs": 8000}, p_stoi, t_stoi),
        "STOI_extended": ("STOI", lambda pkg: {"fs": 8000, "extended": True}, p_stoi, t_stoi),
    }


AUDIO_CASES = audio_cases()
SPLITS = ((0, 3), (3, 4), (4, None))


def tol_of(case):
    return SDR_TOL * 4 if "SignalDistortionRatio" in case or "sdr" in case else (
        STOI_TOL * 4 if "STOI" in case else DB_TOL * 4)


def make(pkg, case, **extra):
    cls, kw, _, _ = AUDIO_CASES[case]
    return getattr(pkg, cls)(**kw(pkg), **extra)


@pytest.mark.parametrize("case", sorted(AUDIO_CASES))
def test_module_states_and_values_match_jax_over_uneven_updates(case):
    _, _, p, t = AUDIO_CASES[case]
    pm, jm = make(mp, case, device="cpu"), make(mt, case)
    for lo, hi in SPLITS:
        pm.update(p[lo:hi], t[lo:hi])
        jm.update(p[lo:hi], t[lo:hi])
    same_state(pm._pack_state(), jm._pack_state(), tol_of(case), case)
    assert pm.total.dtype == torch.int32 and int(pm.total) == int(jm.total)
    close(pm.compute(), jm.compute(), tol_of(case), case)
    pm.reset()
    jm.reset()
    same_state(pm._pack_state(), jm._pack_state(), 0.0, f"{case} reset")


@pytest.mark.parametrize("case", ["SignalNoiseRatio", "ScaleInvariantSignalNoiseRatio",
                                  "ScaleInvariantSignalDistortionRatio", "SignalDistortionRatio",
                                  "PermutationInvariantTraining", "STOI"])
def test_module_forward_compiles_and_matches_jax(case):
    """JAX compiles these forwards; the port's forward takes its compiled
    step from the second call of a signature on, with JAX's batch values."""
    _, _, p, t = AUDIO_CASES[case]
    pm, jm = make(mp, case, device="cpu"), make(mt, case)
    for lo in (0, 2, 4):
        close(pm(p[lo:lo + 2], t[lo:lo + 2]), jm(p[lo:lo + 2], t[lo:lo + 2]), tol_of(case), f"{case} forward")
    assert forward_entry_kinds(pm) == ["compiled"]
    same_state(pm._pack_state(), jm._pack_state(), tol_of(case), case)
    close(pm.compute(), jm.compute(), tol_of(case), case)


def test_audio_collection_forward_is_one_compiled_step_matching_jax():
    t = sources(72, 6, 2, 8000, 8000)
    p = estimates(72, t)

    def coll(pkg, **kw):
        fn = pkg.functional
        return pkg.MetricCollection({
            "snr": pkg.SignalNoiseRatio(**kw), "si_snr": pkg.ScaleInvariantSignalNoiseRatio(**kw),
            "sdr": pkg.SignalDistortionRatio(filter_length=16, **kw),
            "pit": pkg.PermutationInvariantTraining(fn.scale_invariant_signal_distortion_ratio, **kw),
            "stoi": pkg.STOI(8000, **kw)})

    pc, jc = coll(mp, device="cpu"), coll(mt)
    for lo in (0, 2, 4):
        got, want = pc(p[lo:lo + 2], t[lo:lo + 2]), jc(p[lo:lo + 2], t[lo:lo + 2])
        for k in want:
            close(got[k], want[k], SDR_TOL, k)
    assert forward_entry_kinds(pc) == ["compiled"]
    got, want = pc.compute(), jc.compute()
    for k in want:
        close(got[k], want[k], SDR_TOL, k)


def test_pit_splits_base_and_metric_kwargs_as_jax():
    fn = pf.signal_distortion_ratio
    pm = mp.PermutationInvariantTraining(fn, "max", compute_on_step=False, device="cpu", filter_length=8,
                                         zero_mean=True)
    assert pm.kwargs == {"filter_length": 8, "zero_mean": True} and pm.compute_on_step is False
    jm = mt.PermutationInvariantTraining(jf.signal_distortion_ratio, "max", compute_on_step=False, filter_length=8,
                                         zero_mean=True)
    assert jm.kwargs == pm.kwargs
    _, _, p, t = AUDIO_CASES["PermutationInvariantTraining"]
    assert pm(p[:3], t[:3]) is None and jm(p[:3], t[:3]) is None
    close(pm.compute(), jm.compute(), SDR_TOL, "pit kwargs")


DEPRECATED_CLASSES = {"SNR": {}, "SDR": {"filter_length": 16}, "SI_SDR": {}, "SI_SNR": {},
                      "PIT": {"metric_func": "scale_invariant_signal_noise_ratio"}}


@pytest.mark.parametrize("name", sorted(DEPRECATED_CLASSES))
def test_deprecated_alias_classes_warn_and_match_jax(name):
    kw = dict(DEPRECATED_CLASSES[name])
    _, _, p, t = AUDIO_CASES["SignalNoiseRatio"]
    if "metric_func" in kw:
        pkw, jkw = {"metric_func": getattr(pf, kw["metric_func"])}, {"metric_func": getattr(jf, kw["metric_func"])}
    else:
        pkw, jkw = kw, kw
    with pytest.warns(DeprecationWarning, match=f"`{name}` was renamed"):
        pm = getattr(mp, name)(device="cpu", **pkw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = getattr(mt, name)(**jkw)
    assert isinstance(pm, getattr(mp, type(jm).__mro__[1].__name__))
    pm.update(p[:3], t[:3])
    jm.update(p[:3], t[:3])
    close(pm.compute(), jm.compute(), SDR_TOL, name)


@pytest.mark.parametrize("name", ["snr", "si_snr", "si_sdr", "sdr"])
def test_deprecated_functional_aliases_warn_and_match_jax(name):
    _, _, p, t = AUDIO_CASES["SignalNoiseRatio"]
    kw = {"filter_length": 16} if name == "sdr" else {}
    with pytest.warns(DeprecationWarning, match=f"`{name}` was renamed"):
        got = getattr(pf, name)(p[:3], t[:3], device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(jf, name)(p[:3], t[:3], **kw)
    close(got, want, SDR_TOL, name)


def test_stoi_and_constructor_arguments_as_jax():
    assert mp.STOI(16000, device="cpu").fs == 16000 and mp.STOI(8000, True, device="cpu").extended
    with pytest.raises(ValueError, match="Unexpected keyword"):
        mp.SignalNoiseRatio(device="cpu", bogus=1)
    assert mp.SignalDistortionRatio(use_cg_iter=3, device="cpu").use_cg_iter == 3


# --------------------------------------------------------------------- the state bridge

@pytest.mark.parametrize("case", ["SignalNoiseRatio", "ScaleInvariantSignalNoiseRatio",
                                  "ScaleInvariantSignalDistortionRatio", "SignalDistortionRatio",
                                  "PermutationInvariantTraining", "STOI"])
def test_state_crosses_from_jax_mid_stream_and_back(case):
    """JAX takes the first two batches and the port the last, from JAX's
    state; and the port's state finishes in JAX. Both end on JAX's state."""
    _, _, p, t = AUDIO_CASES[case]
    whole = make(mt, case)
    for lo, hi in SPLITS:
        whole.update(p[lo:hi], t[lo:hi])

    jm, pm = make(mt, case), make(mp, case, device="cpu")
    for lo, hi in SPLITS[:2]:
        jm.update(p[lo:hi], t[lo:hi])
    pm._load_state(state_from_numpy(pm, jax.tree.map(np.asarray, jm._pack_state()), device="cpu"))
    lo, hi = SPLITS[2]
    pm.update(p[lo:hi], t[lo:hi])
    same_state(pm._pack_state(), whole._pack_state(), tol_of(case), f"{case} JAX -> port")
    close(pm.compute(), whole.compute(), tol_of(case), case)

    pm2, jm2 = make(mp, case, device="cpu"), make(mt, case)
    for lo, hi in SPLITS[:2]:
        pm2.update(p[lo:hi], t[lo:hi])
    jm2._load_state(jax.tree.map(jnp.asarray, state_to_numpy(pm2._pack_state())))
    lo, hi = SPLITS[2]
    jm2.update(p[lo:hi], t[lo:hi])
    assert np.asarray(jm2.total).dtype == np.int32
    same_state(pm._pack_state(), jm2._pack_state(), tol_of(case), f"{case} port -> JAX")
    close(jm2.compute(), whole.compute(), tol_of(case), case)


# --------------------------------------------------------------------- exports and docstrings

AUDIO_CLASSES = ("PESQ", "PIT", "SDR", "SI_SDR", "SI_SNR", "SNR", "STOI", "PermutationInvariantTraining",
                 "ScaleInvariantSignalDistortionRatio", "ScaleInvariantSignalNoiseRatio", "SignalDistortionRatio",
                 "SignalNoiseRatio")
AUDIO_FUNCTIONALS = ("pesq", "pit", "pit_permutate", "scale_invariant_signal_distortion_ratio",
                     "scale_invariant_signal_noise_ratio", "sdr", "si_sdr", "si_snr", "signal_distortion_ratio",
                     "signal_noise_ratio", "snr", "stoi")


def test_exports_carry_the_jax_packages_names():
    for name in AUDIO_CLASSES:
        assert hasattr(mt, name) and name in mp.__all__ and hasattr(mp, name), name
    for name in AUDIO_FUNCTIONALS:
        assert hasattr(jf, name) and name in pf.__all__ and hasattr(pf, name), name


@pytest.mark.parametrize("mod", ["metrics_tpu_torch.audio.snr", "metrics_tpu_torch.audio.sdr",
                                 "metrics_tpu_torch.audio.pit", "metrics_tpu_torch.functional.audio.snr",
                                 "metrics_tpu_torch.functional.audio.sdr"])
def test_module_docstring_examples_run(mod):
    result = doctest.testmod(importlib.import_module(mod), optionflags=doctest.ELLIPSIS)
    assert result.failed == 0 and result.attempted > 0, mod
