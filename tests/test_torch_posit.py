"""The port's posit codec and rounding against ``repro.core.posit``.

Tier: bitwise (ROADMAP rule 1).  Every input is made with numpy and given to
both packages; outputs are compared as raw bits.  Covers all seven
registered posit formats: the exhaustive lattice (every pattern for n ≤ 16,
a sample above), the midpoints between neighbours, and f32 / f64 grids with
subnormals and specials (the reference flushes subnormals to zero).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.compat import enable_x64
from repro.core import posit as jposit
from repro.core.formats import get_format as jformat
from repro_torch.core import posit as tposit
from repro_torch.core.formats import POSIT_FORMATS, get_format

FMTS = sorted(POSIT_FORMATS)


def _patterns(fmt, rng):
    if fmt.n <= 16:
        return np.arange(1 << fmt.n, dtype=np.int64)
    return rng.integers(0, 1 << fmt.n, 1 << 16, dtype=np.int64)


def _lattice_and_midpoints(name, rng):
    fmt = jformat(name)
    vals = np.asarray(jposit.decode(jnp.asarray(_patterns(fmt, rng)
                                                .astype(np.int32)), fmt),
                      np.float64)
    vals = np.sort(vals[~np.isnan(vals)])
    mids = (vals[:-1] + vals[1:]) / 2
    return np.concatenate([vals, mids]).astype(np.float32)


def _grid_f32(rng):
    return np.concatenate([
        np.exp(rng.uniform(-88, 88, 50000)).astype(np.float32)
        * rng.choice([-1.0, 1.0], 50000).astype(np.float32),
        rng.normal(0, 1e3, 20000).astype(np.float32),
        (rng.uniform(-1, 1, 5000) * 1e-38).astype(np.float32),  # subnormal
        np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-45, -1e-45,
                  np.finfo(np.float32).max, np.finfo(np.float32).tiny],
                 np.float32)]).astype(np.float32)


def _grid_f64(rng):
    return np.concatenate([
        np.exp(rng.uniform(-200, 200, 50000))
        * rng.choice([-1.0, 1.0], 50000),
        rng.uniform(-1, 1, 2000) * 1e-310,                       # subnormal
        np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e308, 5e-324])])


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


@pytest.mark.parametrize("name", FMTS)
def test_round_to_posit_lattice_and_midpoints_bitwise(name):
    x = _lattice_and_midpoints(name, np.random.default_rng(0))
    ref = jposit.round_to_posit(jnp.asarray(x), jformat(name))
    got = tposit.round_to_posit(torch.from_numpy(x), get_format(name))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


@pytest.mark.parametrize("name", FMTS)
def test_round_to_posit_f32_grid_bitwise(name):
    x = _grid_f32(np.random.default_rng(1))
    ref = jposit.round_to_posit(jnp.asarray(x), jformat(name))
    got = tposit.round_to_posit(torch.from_numpy(x), get_format(name))
    codec = tposit.round_to_posit_codec(torch.from_numpy(x), get_format(name))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))
    np.testing.assert_array_equal(_bits(codec.numpy()), _bits(ref))


@pytest.mark.parametrize("name", FMTS)
def test_round_to_posit_f64_grid_bitwise(name):
    x = _grid_f64(np.random.default_rng(2))
    with enable_x64():
        ref = np.asarray(jposit.round_to_posit(jnp.asarray(x, jnp.float64),
                                               jformat(name)))
    got = tposit.round_to_posit(torch.from_numpy(x), get_format(name))
    codec = tposit.round_to_posit_codec(torch.from_numpy(x), get_format(name))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))
    np.testing.assert_array_equal(_bits(codec.numpy()), _bits(ref))


@pytest.mark.parametrize("name", FMTS)
def test_decode_bitwise(name):
    pats = _patterns(jformat(name), np.random.default_rng(3)).astype(np.int32)
    ref = jposit.decode(jnp.asarray(pats), jformat(name))
    got = tposit.decode(torch.from_numpy(pats), get_format(name))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))
    with enable_x64():
        ref64 = np.asarray(jposit.decode(jnp.asarray(pats), jformat(name),
                                         dtype=jnp.float64))
    got64 = tposit.decode(torch.from_numpy(pats), get_format(name),
                          dtype=torch.float64)
    np.testing.assert_array_equal(_bits(got64.numpy()), _bits(ref64))


@pytest.mark.parametrize("name", FMTS)
def test_encode_bitwise(name):
    rng = np.random.default_rng(4)
    x = np.concatenate([_grid_f32(rng),
                        _lattice_and_midpoints(name, rng)]).astype(np.float32)
    ref = np.asarray(jposit.encode(jnp.asarray(x), jformat(name)))
    got = tposit.encode(torch.from_numpy(x), get_format(name)).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    x64 = _grid_f64(rng)
    with enable_x64():
        ref64 = np.asarray(jposit.encode(jnp.asarray(x64, jnp.float64),
                                         jformat(name)))
    got64 = tposit.encode(torch.from_numpy(x64), get_format(name)).numpy()
    np.testing.assert_array_equal(got64, ref64)


@pytest.mark.parametrize("name", ["posit8", "posit16", "posit32"])
def test_round_flushes_subnormals_like_the_reference(name):
    x = np.array([1e-40, -1e-40, 1e-45], np.float32)
    got = tposit.round_to_posit(torch.from_numpy(x), get_format(name))
    np.testing.assert_array_equal(_bits(got.numpy()), np.zeros(3, np.uint32))
