"""The port's narrow IEEE formats against ``repro.core`` on the same inputs.

Tier (ROADMAP rule 1): bitwise.  Rounding to a narrow format is a cast, and
IEEE reductions round after every add in a fixed order, so every result is
held bit for bit; NaN results are held NaN-aware (the reference gives no
promised NaN payload either).  Pinned divergences of a bare torch cast:
fp8e4m3fn overflows to NaN above 464 and on ±Inf (torch saturates to
±448), and f64 rounds directly to fp16 and the fp8s but through f32 to bf16
(torch's CPU cast goes through f32 for all).
"""
import numpy as np
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from repro import compat
from repro.core import arith as jarith
from repro.core.floatsim import round_to_float as jround
from repro.core.formats import get_format as jformat
from repro.core.quant import fake_quant as jfake_quant
from repro.apps import dsp as jdsp
from repro_torch.apps import dsp as tdsp
from repro_torch.core.arith import Arith, backend_overrides
from repro_torch.core.floatsim import round_to_float
from repro_torch.core.formats import get_format
from repro_torch.core.quant import fake_quant

IEEE = ["fp16", "bfloat16", "fp8e5m2", "fp8e4m3"]
EDGES = [448.0, 460.0, 463.9, 464.0, 464.01, 480.0, 500.0, 1e5, 65504.0,
         65519.99, 65520.0, 57344.0, 61440.0, np.inf, 0.0, 1e-40, 1e-45,
         2.0 ** -24, 2.0 ** -25, 2.0 ** -9, 2.0 ** -10, 2.0 ** -16, 3e38]


def assert_nan_aware_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    u = np.uint32 if got.dtype == np.float32 else np.uint64
    gn, wn = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(got.view(u)[~gn], want.view(u)[~wn])


def _f32_inputs():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1 << 20)
         * np.exp2(rng.integers(-150, 128, 1 << 20))).astype(np.float32)
    half = np.arange(1 << 16, dtype=np.uint16).view(np.float16)
    half = np.sort(half[np.isfinite(half)].astype(np.float64))
    mids = (half[:-1] + half[1:]) / 2
    edges = np.asarray(EDGES + [np.nan])
    return np.concatenate([x, half, mids, edges, -edges]).astype(np.float32)


def _f64_inputs():
    rng = np.random.default_rng(1)
    g = rng.standard_normal(1 << 16) * np.exp2(rng.integers(-40, 20, 1 << 16))
    half = np.arange(1 << 16, dtype=np.uint16).view(np.float16)
    half = np.sort(half[np.isfinite(half)].astype(np.float64))
    mids = (half[:-1] + half[1:]) / 2
    near = np.concatenate([mids * (1 + 2.0 ** -40), mids * (1 - 2.0 ** -40),
                           mids * (1 + 2.0 ** -30)])
    crafted = [1 + 2 ** -11 + 2 ** -40, 1 + 2 ** -8 + 2 ** -40,
               1 + 2 ** -3 + 2 ** -40, 1 + 2 ** -4 + 2 ** -40,
               2 ** -25 + 2 ** -60, 464.0000001, 463.99999999, 1e300, 1e-300]
    edges = np.asarray(EDGES + crafted + [np.nan])
    return np.concatenate([g, half, mids, near, edges, -edges])


@pytest.mark.parametrize("name", IEEE + ["fp32"])
def test_round_to_float_f32_bitwise(name):
    x = _f32_inputs()
    want = np.asarray(jround(jnp.asarray(x), jformat(name)))
    got = round_to_float(torch.from_numpy(x), get_format(name)).numpy()
    assert_nan_aware_bitwise(got, want)


@pytest.mark.parametrize("name", IEEE + ["fp32"])
def test_round_to_float_f64_bitwise(name):
    x = _f64_inputs()
    with compat.enable_x64():
        want = np.asarray(jround(jnp.asarray(x), jformat(name)))
    got = round_to_float(torch.from_numpy(x), get_format(name)).numpy()
    assert_nan_aware_bitwise(got, want)


def test_pinned_divergences_of_a_bare_cast():
    e4m3 = get_format("fp8e4m3")
    x = torch.tensor([464.0, 464.01, 500.0, -1e5, float("inf")])
    got = round_to_float(x, e4m3)
    assert got[0] == 448.0 and torch.isnan(got[1:]).all()
    x64 = torch.tensor([1 + 2 ** -11 + 2 ** -40, 1 + 2 ** -8 + 2 ** -40],
                       dtype=torch.float64)
    assert round_to_float(x64, get_format("fp16"))[0] == 1 + 2 ** -10
    assert round_to_float(x64, get_format("bfloat16"))[1] == 1.0


def _reduction_inputs(name, seed):
    """Values of the format's own range, with Inf/NaN poisoning rows."""
    rng = np.random.default_rng(seed)
    scale = {"fp16": 300.0, "bfloat16": 1e4, "fp8e5m2": 3e3,
             "fp8e4m3": 30.0}[name]
    a = (rng.standard_normal((5, 70)) * scale).astype(np.float32)
    b = (rng.standard_normal((5, 70)) * scale).astype(np.float32)
    a[1, 3] = np.inf
    a[2, 40] = np.nan
    b[3, 7] = -np.inf
    return a, b


def _reduction_cases(ar, a, b, long_chains=True):
    """The reductions of one Arith on (5, K) operands; ``long_chains=False``
    keeps every chain at K ≤ 64 (the reference's unrolled arm)."""
    cases = [ar.dot(a[:, :40], b[:, :40]), ar.dot(a, b, axis=0),
             ar.sum(a[:, :40]), ar.sum(a, axis=0), ar.cumsum(a[:, :40]),
             ar.cumsum(a, axis=0), ar.mean(a[:, :40]),
             ar.matmul(a[:, :9], b[:4, :9].T)]
    if long_chains:
        cases += [ar.dot(a, b), ar.dot(a[:, :20], b[:, :20], axis=None),
                  ar.sum(a), ar.cumsum(a), ar.mean(a),
                  ar.matmul(a, b.T[:, :3])]
    return cases


@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("name", ["fp16", "bfloat16"])
def test_ieee_reductions_bitwise(name, fused):
    """Every arm of the reference, chains of 5 to 100 rounded adds."""
    a, b = _reduction_inputs(name, 2)
    with jarith.backend_overrides(fused=fused), backend_overrides(
            fused=fused):
        want = _reduction_cases(jarith.Arith.make(name), jnp.asarray(a),
                                jnp.asarray(b))
        got = _reduction_cases(Arith.make(name), torch.from_numpy(a),
                               torch.from_numpy(b))
    for g, w in zip(got, want):
        assert_nan_aware_bitwise(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ["fp8e5m2", "fp8e4m3"])
def test_fp8_reductions_bitwise_on_the_unrolled_arm(name):
    """fp8 against the reference's unrolled chains (fused, K ≤ 64).  Its
    per-step scan arm is not held here: XLA's CPU loop body converts f32
    to fp8 through f16 for narrow carries (a double rounding; e4m3fn
    values in (480, 512) even come out −0), unlike its own direct convert
    — the reference's defined semantics, which the oracle test below
    holds for long chains."""
    a, b = _reduction_inputs(name, 2)
    with jarith.backend_overrides(fused="on"):
        want = _reduction_cases(jarith.Arith.make(name), jnp.asarray(a),
                                jnp.asarray(b), long_chains=False)
    got = _reduction_cases(Arith.make(name), torch.from_numpy(a),
                           torch.from_numpy(b), long_chains=False)
    for g, w in zip(got, want):
        assert_nan_aware_bitwise(g.numpy(), np.asarray(w))


_ML = {"fp16": np.float16,
       "bfloat16": ml_dtypes.bfloat16, "fp8e5m2": ml_dtypes.float8_e5m2,
       "fp8e4m3": ml_dtypes.float8_e4m3fn}


def _sequential_oracle(name, terms):
    """numpy + ml_dtypes: every partial sum of ``terms`` rounded, in order
    along axis 0 — the prefixes."""
    def rnd(v):
        return np.asarray(v, np.float32).astype(_ML[name]).astype(np.float32)
    acc, out = np.zeros(terms.shape[1:], np.float32), []
    for t in terms:
        acc = rnd(acc + t)
        out.append(acc)
    return np.stack(out)


@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("name", IEEE)
def test_ieee_long_chains_bitwise_against_ml_dtypes(name, fused):
    a, b = _reduction_inputs(name, 5)
    ar, ta, tb = Arith.make(name), torch.from_numpy(a), torch.from_numpy(b)
    def rnd(v):
        return np.asarray(v, np.float32).astype(_ML[name]).astype(np.float32)
    with backend_overrides(fused=fused):
        pairs = [(ar.cumsum(ta), _sequential_oracle(name, a.T).T),
                 (ar.sum(ta), _sequential_oracle(name, a.T)[-1]),
                 (ar.dot(ta, tb), _sequential_oracle(name, rnd(a * b).T)[-1]),
                 (ar.matmul(ta, tb.T),
                  _sequential_oracle(name, rnd(a.T[:, :, None]
                                               * b.T[:, None, :]))[-1])]
    for got, want in pairs:
        assert_nan_aware_bitwise(got.numpy(), want)


@pytest.mark.parametrize("name", IEEE)
def test_ieee_elementary_ops_bitwise(name):
    a, b = _reduction_inputs(name, 3)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    jar, tar = jarith.Arith.make(name), Arith.make(name)
    for op in ("add", "sub", "mul", "div"):
        assert_nan_aware_bitwise(getattr(tar, op)(ta, tb).numpy(),
                                 np.asarray(getattr(jar, op)(ja, jb)))
    assert_nan_aware_bitwise(tar.fma(ta, tb, ta).numpy(),
                             np.asarray(jar.fma(ja, jb, ja)))
    assert_nan_aware_bitwise(tar.fdot2(ta, tb, tb, ta).numpy(),
                             np.asarray(jar.fdot2(ja, jb, jb, ja)))
    small = ta / 1e3
    for op in ("sqrt", "tanh", "sin", "cos"):
        # libm's f32 results differ by ≤ 1 f32 ulp at most between the two
        # libraries; rounded to ≤ 11 significand bits they are equal here
        assert_nan_aware_bitwise(getattr(tar, op)(small.abs()).numpy(),
                                 np.asarray(getattr(jar, op)(
                                     jnp.abs(ja / 1e3))))


@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("name", ["fp16", "fp8e4m3"])
def test_ieee_rfft_bitwise_with_overflow_poisoning(name, fused):
    """24-bit-PCM-scale input: the format overflows mid-FFT and the honest
    butterflies' (−0)·(±Inf) = NaN poisoning must come out the same."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 256)) * 2.0 ** 17).astype(np.float32)
    with jarith.backend_overrides(fused=fused), backend_overrides(
            fused=fused):
        jre, jim = jdsp.rfft_format(jarith.Arith.make(name), jnp.asarray(x))
        tre, tim = tdsp.rfft_format(Arith.make(name), torch.from_numpy(x))
        jp = jdsp.power_spectrum(jarith.Arith.make(name), jnp.asarray(x))
        tp = tdsp.power_spectrum(Arith.make(name), torch.from_numpy(x))
    assert np.isnan(np.asarray(jre)).any() or np.isinf(np.asarray(jp)).any()
    for got, want in ((tre, jre), (tim, jim), (tp, jp)):
        assert_nan_aware_bitwise(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", IEEE)
def test_fake_quant_ieee_bitwise_and_straight_through(name):
    x = _f32_inputs()[:4096]
    want = np.asarray(jfake_quant(jnp.asarray(x), name))
    t = torch.from_numpy(x.copy()).requires_grad_(True)
    got = fake_quant(t, name)
    assert_nan_aware_bitwise(got.detach().numpy(), want)
    got.sum().backward()
    assert torch.equal(t.grad, torch.ones_like(t))
