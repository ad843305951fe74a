"""The codec kernels' plain versions against the TPU codec kernels, run as
``tests/test_kernels.py`` runs them (``repro.kernels.ops`` in interpret
mode) and against ``repro.kernels.ref``: bitwise, at the shapes of
``tests/test_kernels.py`` and on every posit8/posit16 pattern, with
subnormal, ±0, ±Inf and NaN inputs, to f32 and to bf16.  The CUDA kernels
are held against these plain versions on the card by ``chip_smoke.py``
and ``tests/test_torch_card.py``.

The decode kernel's table and its launch plan are pure torch/Python, so
they are held here too: the table's plain version, read the way the
kernel reads it (entry |p| with the sign bit flipped for p < 0), against
the reference's decode on every pattern of every posit format of 16 bits
or fewer; the vector plan's head, body and tail against every element.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import posit as jposit
from repro.core.formats import POSIT_FORMATS as J_POSIT_FORMATS
from repro.core.formats import PositFormat as JPositFormat
from repro.kernels import ops, ref
from repro_torch.core.formats import POSIT_FORMATS, PositFormat
from repro_torch.kernels import build
from repro_torch.kernels.posit_codec import (posit_decode,
                                             posit_decode_table_torch,
                                             posit_decode_torch, posit_encode,
                                             posit_encode_torch,
                                             table_entries, vector_plan)

FMTS = [(8, 2), (16, 2), (12, 2)]
IDS = ["posit8", "posit16", "posit12"]
STORAGE = {8: np.int8, 12: np.int16, 16: np.int16}


def _f32_bits(a):
    a = np.asarray(a, np.float32)
    return np.where(np.isnan(a), np.uint32(0x7FC00000), a.view(np.uint32))


def _bf16_bits(t):
    b = t.view(torch.int16).numpy().astype(np.uint16)
    return np.where(torch.isnan(t.float()).numpy(), np.uint16(0x7FC0), b)


def _random_bits(n, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << n, size=shape).astype(np.int32).astype(
        STORAGE[n])


def _special_f32(rng, n):
    x = (rng.standard_normal(n) * np.exp2(rng.integers(-150, 128, n))
         ).astype(np.float32)
    return np.concatenate([x, np.array(
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 1e-45, 3e38,
         -3e38], np.float32)])


@pytest.mark.parametrize("nes", FMTS, ids=IDS)
@pytest.mark.parametrize("shape", [(8, 128), (16, 256), (512,), (3, 5, 7)])
def test_decode_plain_matches_pallas_decode(nes, shape):
    bits = _random_bits(nes[0], shape, 0)
    jf, tf = JPositFormat(*nes), PositFormat(*nes)
    want = np.asarray(ops.decode(jnp.asarray(bits), jf))
    got = posit_decode(torch.from_numpy(bits), tf)
    np.testing.assert_array_equal(_f32_bits(got), _f32_bits(want))
    np.testing.assert_array_equal(
        _f32_bits(got), _f32_bits(ref.decode_ref(jnp.asarray(bits), jf)))


@pytest.mark.parametrize("nes", FMTS, ids=IDS)
def test_decode_bf16_output(nes):
    bits = _random_bits(nes[0], (16, 128), 1)
    jf, tf = JPositFormat(*nes), PositFormat(*nes)
    want = np.asarray(ops.decode(jnp.asarray(bits), jf, jnp.bfloat16))
    got = posit_decode_torch(torch.from_numpy(bits), tf, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want_t = torch.from_numpy(want.view(np.int16).copy()).view(torch.bfloat16)
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want_t))


@pytest.mark.parametrize("n", [8, 16])
def test_decode_every_pattern(n):
    bits = np.arange(1 << n).astype(np.int32).astype(STORAGE[n])
    jf, tf = JPositFormat(n, 2), PositFormat(n, 2)
    want = np.asarray(ref.decode_ref(jnp.asarray(bits), jf))
    got = posit_decode(torch.from_numpy(bits), tf)
    np.testing.assert_array_equal(_f32_bits(got), _f32_bits(want))


@pytest.mark.parametrize("nes", FMTS, ids=IDS)
@pytest.mark.parametrize("shape", [(8, 128), (64, 128), (1000,)])
def test_encode_plain_matches_pallas_encode(nes, shape):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=shape) * 10.0).astype(np.float32)
    jf, tf = JPositFormat(*nes), PositFormat(*nes)
    want = np.asarray(ops.encode(jnp.asarray(x), jf))
    got = posit_encode(torch.from_numpy(x), tf)
    assert got.dtype == tf.storage_dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.encode_ref(jnp.asarray(x), jf)))


@pytest.mark.parametrize("nes", FMTS, ids=IDS)
def test_encode_specials_and_lattice(nes):
    """Subnormals flush to pattern 0 (the reference's FTZ), -0 → 0,
    ±Inf/NaN → NaR (posit8's lands as -128), lattice points and their
    midpoints round to even."""
    rng = np.random.default_rng(2)
    jf, tf = JPositFormat(*nes), PositFormat(*nes)
    lattice = np.asarray(ref.decode_ref(
        jnp.arange(1 << nes[0], dtype=jnp.int32), jf))
    lattice = np.sort(lattice[~np.isnan(lattice)])
    mids = ((lattice[:-1].astype(np.float64) + lattice[1:]) / 2).astype(
        np.float32)
    x = np.concatenate([_special_f32(rng, 4096), lattice, mids])
    want = np.asarray(ref.encode_ref(jnp.asarray(x), jf))
    got = posit_encode(torch.from_numpy(x), tf).numpy()
    np.testing.assert_array_equal(got, want)
    nar = np.array(1 << (nes[0] - 1)).astype(np.int32).astype(STORAGE[nes[0]])
    specials = got[4096:4106]       # 0, -0, inf, -inf, nan, ±1e-40, 1e-45
    assert np.all(specials[[0, 1, 5, 6, 7]] == 0)
    assert np.all(specials[[2, 3, 4]] == nar)


def test_cpu_tensors_never_reach_the_kernel_loader(monkeypatch):
    def no_loader(name):
        raise AssertionError("a CPU tensor reached the kernel loader")
    monkeypatch.setattr(build, "load", no_loader)
    fmt = PositFormat(16, 2)
    x = torch.randn(100)
    assert torch.equal(posit_decode(posit_encode(x, fmt), fmt),
                       posit_decode_torch(posit_encode_torch(x, fmt), fmt))
    assert posit_decode.launches == 0 and posit_encode.launches == 0


def table_lookup(table: torch.Tensor, bits: torch.Tensor, fmt: PositFormat):
    """The decode kernel's read of its table, in plain torch: the pattern
    sign-extended from n bits, entry |p|, the output's sign bit flipped
    where p < 0.  Returns the output's bits (int32 for f32, int16 for
    bf16)."""
    idt = torch.int32 if table.dtype == torch.float32 else torch.int16
    sign = -(1 << 31) if idt == torch.int32 else -(1 << 15)
    x = bits.to(torch.int64) & fmt.mask
    p = torch.where(x >= fmt.nar_pattern, x - (1 << fmt.n), x)
    t = table.view(idt).to(torch.int64)[p.abs()]
    return (t ^ torch.where(p < 0, sign, 0)).to(idt)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", [n for n, f in POSIT_FORMATS.items()
                                  if f.n <= 16])
def test_decode_table_read_as_the_kernel_reads_it(name, out_dtype):
    """Every pattern of the format, read through the table, gives the
    reference's decode bit for bit: negative patterns by sign symmetry,
    NaR as a positive NaN (the table's NaR entry has the sign bit set)."""
    fmt, jf = POSIT_FORMATS[name], J_POSIT_FORMATS[name]
    table = posit_decode_table_torch(fmt, out_dtype)
    assert table.dtype == out_dtype
    assert table.numel() == table_entries(fmt, out_dtype)
    assert (table.numel() * table.element_size()) % 16 == 0
    bits = np.arange(1 << fmt.n).astype(np.int32).astype(STORAGE.get(
        fmt.n, np.int8 if fmt.n <= 8 else np.int16))
    got = table_lookup(table, torch.from_numpy(bits), fmt)
    want = jposit.decode(jnp.asarray(bits), jf, jnp.float32)
    if out_dtype == torch.float32:
        want_bits = np.asarray(want).view(np.int32)
    else:
        want_bits = np.asarray(want.astype(jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(got.numpy(), want_bits)
    # the table's own layout: |p| entries, then NaR's negative NaN
    half = 1 << (fmt.n - 1)
    assert torch.isnan(table[half].float()) and table.view(
        got.dtype)[half] < 0
    assert torch.equal(table[:half].float(), posit_decode_torch(
        torch.arange(half, dtype=torch.int32), fmt, out_dtype).float())


_PLANS = [(size, out) for size in (1, 2, 4) for out in (2, 4)]


@pytest.mark.parametrize("size,out_size", _PLANS,
                         ids=[f"int{8 * s}-{'bf16' if o == 2 else 'f32'}"
                              for s, o in _PLANS])
def test_vector_plan_takes_every_element_once(size, out_size):
    """The decode kernel's split of n patterns at a byte offset into a
    scalar head, vectors of 16 // max(pattern, output size) elements and a
    scalar tail, with the scalar elements spread over the first head + tail
    threads as the kernel spreads them: every element exactly once, every
    vector aligned to its width."""
    per = 16 // max(size, out_size)
    for offset in range(0, 16, size):
        base = 4096 + offset            # an address 16-byte aligned + offset
        for n in [*range(68), 100003]:
            head, n_vec, tail = vector_plan(base, n, size, per)
            assert 0 <= head < per and 0 <= tail < per and n_vec >= 0
            scalar = [t if t < head else head + n_vec * per + (t - head)
                      for t in range(head + tail)]
            body = [head + v * per + k for v in range(n_vec)
                    for k in range(per)]
            assert sorted(scalar + body) == list(range(n))
            assert all((base + (head + v * per) * size) % (per * size) == 0
                       for v in range(min(n_vec, 3)))
            if n >= head + per:
                assert n_vec >= 1
