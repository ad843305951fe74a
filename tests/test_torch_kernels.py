"""Each kernel's plain torch version against the TPU kernel it replaces,
run as ``tests/test_kernels.py`` runs the Pallas kernels (``interpret=True``).

Tiers: the round and the butterfly are bitwise; the rounded matmul is
within one format ulp (its wide f32 sum is an implementation-defined order,
ROADMAP rule 1).  Also pins the wrappers' CPU behaviour: a CPU tensor takes
the plain version and never reaches the kernel loader.  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_card.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.formats import get_format as jformat
from repro.kernels.posit_matmul import posit_matmul_round_2d
from repro.kernels.posit_round import posit_butterfly_2d, posit_round_2d
from repro_torch.core.formats import get_format
from repro_torch.core.posit import encode
from repro_torch.kernels import build
from repro_torch.kernels.posit_matmul import (posit_matmul_round,
                                              posit_matmul_round_torch)
from repro_torch.kernels.posit_round import (posit_butterfly,
                                             posit_butterfly_torch,
                                             posit_round, posit_round_torch,
                                             twiddle_layout)

FMTS = ["posit8", "posit10", "posit16"]


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _posit_values(rng, shape, name, scale):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return posit_round_torch(torch.from_numpy(x), get_format(name)).numpy()


def _ulp_distance(a, b, name):
    fmt = get_format(name)

    def ordered(v):
        p = encode(torch.from_numpy(np.array(v, np.float32)), fmt)
        p = p.to(torch.int64) & fmt.mask
        return (p ^ fmt.nar_pattern) - fmt.nar_pattern
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("name", FMTS)
def test_round_plain_matches_pallas_round(name):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((16, 256)) * np.exp(rng.uniform(-30, 30, (16, 256)))
         ).astype(np.float32)
    x[0, :4] = [np.nan, np.inf, 1e-40, 0.0]
    ref = posit_round_2d(jnp.asarray(x), jformat(name), interpret=True)
    got = posit_round_torch(torch.from_numpy(x), get_format(name))
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("name", FMTS)
def test_butterfly_plain_matches_pallas_butterfly(name):
    rng = np.random.default_rng(1)
    e_re, e_im, o_re, o_im = (_posit_values(rng, (8, 128), name, 1e3)
                              for _ in range(4))
    w_re, w_im = (_posit_values(rng, (8, 128), name, 1.0) for _ in range(2))
    ref = posit_butterfly_2d(*(jnp.asarray(v) for v in
                               (e_re, e_im, o_re, o_im, w_re, w_im)),
                             jformat(name), interpret=True)
    got = posit_butterfly_torch(*(torch.from_numpy(v) for v in
                                  (e_re, e_im, o_re, o_im, w_re, w_im)),
                                get_format(name))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_bits(g), _bits(r))


@pytest.mark.parametrize("name", FMTS)
def test_matmul_plain_within_one_ulp_of_pallas_matmul(name):
    rng = np.random.default_rng(2)
    a = np.abs(_posit_values(rng, (16, 256), name, 1e2))
    b = np.abs(_posit_values(rng, (256, 128), name, 1.0))
    ref = np.asarray(posit_matmul_round_2d(jnp.asarray(a), jnp.asarray(b),
                                           jformat(name), interpret=True))
    got = posit_matmul_round_torch(torch.from_numpy(a), torch.from_numpy(b),
                                   get_format(name)).numpy()
    assert int(_ulp_distance(got, ref, name).max()) <= 1


def test_wrappers_take_the_plain_version_for_cpu_tensors(monkeypatch):
    def no_loader(name):
        raise AssertionError("a CPU tensor reached the kernel loader")
    monkeypatch.setattr(build, "load", no_loader)
    fmt = get_format("posit16")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    assert torch.equal(posit_round(x, fmt), posit_round_torch(x, fmt))
    w = torch.ones(4, 1)
    planes = [x[None].expand(8, 4, 8).contiguous() for _ in range(4)]
    for g, r in zip(posit_butterfly(*planes, w, w, fmt),
                    posit_butterfly_torch(*planes, w, w, fmt)):
        assert torch.equal(g, r)
    assert torch.equal(posit_matmul_round(x, x.T, fmt),
                       posit_matmul_round_torch(x, x.T, fmt))


@pytest.mark.parametrize("w_shape,shape,want", [
    ((4, 1), (3, 2, 4, 512), (512, 4)),        # transposed Stockham stage
    ((1, 1, 1, 256), (3, 2, 8, 256), (1, 256)),  # natural Stockham stage
    ((), (5, 7), (1, 1)),                        # scalar twiddle
])
def test_twiddle_layout_reads_broadcast_twiddles(w_shape, shape, want):
    assert twiddle_layout(torch.zeros(w_shape), shape) == want


@pytest.mark.parametrize("w_shape,shape", [
    ((4, 2), (3, 4, 2)),          # varies along two axes
    ((3, 1), (3, 4, 2)),          # wrong length for its axis
    ((1, 1, 1, 4), (4, 4)),       # more dims than the plane
])
def test_twiddle_layout_rejects_other_broadcasts(w_shape, shape):
    with pytest.raises(ValueError):
        twiddle_layout(torch.zeros(w_shape), shape)
