"""The KV write of the port against the reference's, on the CPU.

``KVCache.append`` routes a posit cache through ``posit_kv_append`` (on
the CPU its plain version, ``posit_kv_append_torch``) and a bf16 cache
through ``kv_scatter``; both are held bitwise against
``repro.models.attention.KVCache.append`` on the whole K and V storage,
which starts from random bits so that a position written by one side only
shows.  Covered: posit8, posit16 and bf16 stores; bf16 and f32 rows with
zeros, subnormals, ±Inf and NaN among them; the three modes — per-row
decode with rows at length 0, cap − 1 and cap (dropped), a ragged per-row
prefill, and a scalar append in the middle and near cap (clamped).

``kernel_element_map`` mirrors the CUDA kernel's thread → element map
(``csrc/posit_codec.cu::posit_kv_append_kernel``) at eight values a
thread and at one: every element it writes is written exactly once, and
the storage it writes equals the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import PositFormat as JPositFormat
from repro.core.quant import PositTensor as JPositTensor
from repro.models.attention import KVCache as JKVCache
from repro_torch.core.formats import PositFormat
from repro_torch.core.posit import encode
from repro_torch.core.quant import PositTensor
from repro_torch.kernels import build
from repro_torch.kernels.posit_codec import (KV_PER_ROW_DECODE,
                                             KV_PER_ROW_PREFILL,
                                             KV_SCALAR_LENGTH, kv_mode,
                                             posit_kv_append,
                                             posit_kv_append_torch)
from repro_torch.models.attention import KVCache

B, CAP, KV, D = 4, 12, 2, 16
# (S_new, lengths before, new_length): per-row decode with rows at 0,
# cap - 1 and cap (dropped); a ragged per-row prefill; scalar appends in
# the middle and near cap (the start clamps to cap - S_new)
CASES = {
    "per_row_decode": (1, [0, CAP - 1, CAP, 5], None),
    "per_row_prefill": (7, [0, 0, 0, 0], [7, 3, 5, 1]),
    "scalar": (4, 3, None),
    "scalar_clamped": (5, CAP - 2, None),
}
STORES = {"posit8": (8, 2), "posit16": (16, 2), "bf16": None}


def _rows(rng, s_new, in_dtype):
    """(B, s_new, KV, D) values with specials; bf16 rows are exact bf16
    values (the f32 bits truncated), so both frameworks hold the same."""
    x = (rng.standard_normal((B, s_new, KV, D))
         * np.exp2(rng.integers(-20, 20, (B, s_new, KV, D)))
         ).astype(np.float32)
    flat = x.reshape(-1)
    flat[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40]
    if in_dtype == "bf16":
        x = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    return x


def _to_torch(x, in_dtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if in_dtype == "bf16" else t


def _to_jax(x, in_dtype):
    return jnp.asarray(x, jnp.bfloat16 if in_dtype == "bf16" else
                       jnp.float32)


def _storage(rng, store):
    """Random initial K/V storage: posit bits, or bf16 values."""
    if store == "bf16":
        x = rng.standard_normal((2, B, CAP, KV, D)).astype(np.float32)
        return (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    n = STORES[store][0]
    dt = np.int8 if n == 8 else np.int16
    return rng.integers(-(1 << (n - 1)), 1 << (n - 1),
                        (2, B, CAP, KV, D)).astype(dt)


def _bits(t: torch.Tensor) -> np.ndarray:
    """Storage as integers, for bitwise comparison."""
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _jax_append(store, init, k_new, v_new, length, new_length, in_dtype):
    if store == "bf16":
        k, v = (jnp.asarray(init[i], jnp.bfloat16) for i in range(2))
    else:
        jf = JPositFormat(*STORES[store])
        k, v = (JPositTensor(jnp.asarray(init[i]), jf, None)
                for i in range(2))
    cache = JKVCache(k, v, jnp.asarray(length, jnp.int32))
    out = cache.append(_to_jax(k_new, in_dtype), _to_jax(v_new, in_dtype),
                       None if new_length is None
                       else jnp.asarray(new_length, jnp.int32))
    raw = [out.k, out.v] if store == "bf16" else [out.k.bits, out.v.bits]
    if store == "bf16":
        raw = [np.array(r.astype(jnp.float32)) for r in raw]
        raw = [_bits(torch.from_numpy(r).to(torch.bfloat16)) for r in raw]
    else:
        raw = [np.asarray(r) for r in raw]
    return raw, np.asarray(out.length)


def _port_append(store, init, k_new, v_new, length, new_length, in_dtype):
    if store == "bf16":
        k, v = (torch.from_numpy(init[i].copy()).to(torch.bfloat16)
                for i in range(2))
    else:
        fmt = PositFormat(*STORES[store])
        k, v = (PositTensor(torch.from_numpy(init[i].copy()), fmt, None)
                for i in range(2))
    cache = KVCache(k, v, torch.tensor(length, dtype=torch.int32))
    out = cache.append(_to_torch(k_new, in_dtype), _to_torch(v_new, in_dtype),
                       new_length)
    raw = [KVCache._raw(out.k), KVCache._raw(out.v)]
    # in place: the returned cache shares the storage it was given
    assert raw[0].data_ptr() == KVCache._raw(k).data_ptr()
    return [_bits(r) for r in raw], out.length.numpy()


@pytest.mark.parametrize("in_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("store", list(STORES))
@pytest.mark.parametrize("case", list(CASES))
def test_append_bitwise_equal_to_reference(case, store, in_dtype):
    s_new, length, new_length = CASES[case]
    rng = np.random.default_rng(len(case) * 7 + len(store) + s_new)
    init = _storage(rng, store)
    k_new, v_new = _rows(rng, s_new, in_dtype), _rows(rng, s_new, in_dtype)
    want, want_len = _jax_append(store, init, k_new, v_new, length,
                                 new_length, in_dtype)
    got, got_len = _port_append(store, init, k_new, v_new, length,
                                new_length, in_dtype)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got_len, want_len)
    if case == "per_row_decode":
        # the row at length == cap wrote nothing
        np.testing.assert_array_equal(got[0][2], _bits(torch.from_numpy(
            init[0][2]).to(torch.bfloat16)) if store == "bf16"
            else init[0][2])


def test_append_refuses_a_block_past_capacity_and_a_scaled_store():
    fmt = PositFormat(8, 2)
    bits = torch.zeros(B, CAP, KV, D, dtype=torch.int8)
    rows = torch.zeros(B, CAP + 1, KV, D)
    with pytest.raises(ValueError, match="capacity"):
        posit_kv_append_torch(rows, rows, bits, bits.clone(),
                              torch.zeros(B, dtype=torch.int32), fmt)
    cache = KVCache(PositTensor(bits, fmt, torch.tensor(2.0)),
                    PositTensor(bits.clone(), fmt, torch.tensor(2.0)),
                    torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError, match="scale"):
        cache.append(rows[:, :1], rows[:, :1])


def test_cpu_tensors_never_reach_the_kernel_loader(monkeypatch):
    def no_loader(name):
        raise AssertionError("a CPU tensor reached the kernel loader")
    monkeypatch.setattr(build, "load", no_loader)
    fmt = PositFormat(16, 2)
    bits = torch.zeros(B, CAP, KV, D, dtype=torch.int16)
    rows = torch.randn(B, 1, KV, D)
    before = posit_kv_append.launches
    posit_kv_append(rows, rows, bits, bits.clone(),
                    torch.arange(B, dtype=torch.int32), fmt)
    assert posit_kv_append.launches == before
    assert torch.equal(bits[1, 1], encode(rows[1, 0], fmt))


# ---------------------------------------------------------------------------
# The kernel's thread -> element map
# ---------------------------------------------------------------------------

def kernel_element_map(batch, s_new, cap, row, per, mode, length):
    """(is_v, source index, destination index) of every element the kernel
    writes, one entry per element: the index math of
    ``posit_kv_append_kernel`` for every thread u < 2 · batch · s_new ·
    row / per (K's units, then V's), ``per`` consecutive values each."""
    row_units = row // per
    units = batch * s_new * row_units
    u = np.arange(2 * units)
    is_v = u >= units
    w = np.where(is_v, u - units, u)
    r = w // row_units
    j = (w - r * row_units) * per
    b = r // s_new
    s = r - b * s_new
    length = np.asarray(length)
    if mode == KV_PER_ROW_DECODE:
        pos = length[b]
        keep = (pos >= 0) & (pos < cap)
    elif mode == KV_PER_ROW_PREFILL:
        pos, keep = s, np.ones_like(s, bool)
    else:
        pos = min(max(int(length), 0), cap - s_new) + s
        keep = np.ones_like(s, bool)
    src = (r * row + j)[keep, None] + np.arange(per)
    dst = ((b * cap + pos) * row + j)[keep, None] + np.arange(per)
    return (np.repeat(is_v[keep], per), src.reshape(-1), dst.reshape(-1))


@pytest.mark.parametrize("per", [8, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_element_map_writes_each_element_once(case, per):
    s_new, length, new_length = CASES[case]
    rng = np.random.default_rng(per + s_new)
    fmt = PositFormat(8, 2)
    init = _storage(rng, "posit8")
    k_new, v_new = _rows(rng, s_new, "f32"), _rows(rng, s_new, "f32")
    want, _ = _jax_append("posit8", init, k_new, v_new, length, new_length,
                          "f32")
    mode = kv_mode(s_new, torch.tensor(length))
    assert mode == {"per_row_decode": KV_PER_ROW_DECODE,
                    "per_row_prefill": KV_PER_ROW_PREFILL}.get(
                        case, KV_SCALAR_LENGTH)
    is_v, src, dst = kernel_element_map(B, s_new, CAP, KV * D, per, mode,
                                        length)
    for which, new in ((False, k_new), (True, v_new)):
        d = dst[is_v == which]
        assert len(np.unique(d)) == len(d), "an element written twice"
        out = init[int(which)].reshape(-1).copy()
        out[d] = encode(torch.from_numpy(new.reshape(-1)[src[is_v == which]]),
                        fmt).numpy()
        np.testing.assert_array_equal(out.reshape(init.shape[1:]),
                                      want[int(which)])
