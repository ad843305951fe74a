"""The FFT stage-range kernel's plan and schedule, on the CPU.

``posit_fft_stages`` runs a range of Stockham stages in one launch, cut
into passes by ``fft_pass_plan``, each pass's state split into groups of
``2^k`` values that a block runs in shared memory (``csrc/posit_fft.cu``).
Here:

* the plan tiles every stage range the FFT path asks for, each pass's
  groups cover every element of every FFT once (``pass_index_map``, the
  kernel's index arithmetic), and the shared memory fits its budget;
* a plain mirror of the kernel's schedule — gather each group by the
  pass's index map, run its ``k`` stages with ``posit_butterfly_torch``,
  scatter into the output layout — is bitwise equal to the stacked stage
  loop and to ``repro.apps.dsp``'s ``rfft_format``/``fft_format`` under
  the reference's Pallas round backend (interpret mode).

The CUDA kernel itself is held against its plain version on the card by
``tests/test_torch_card.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import dsp as jdsp
from repro.core.arith import Arith as JArith
from repro.core.arith import backend_overrides as jbackend
from repro_torch.apps import dsp as tdsp
from repro_torch.core.arith import Arith, backend_overrides
from repro_torch.core.formats import get_format
from repro_torch.kernels import build
from repro_torch.kernels import posit_fft as pf
from repro_torch.kernels.posit_round import posit_butterfly_torch

FMTS = ["posit16", "posit10", "posit8"]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _ranges(n):
    """Every stage range the FFT path runs at length ``n``: ``fft_format``'s
    whole loop and ``_rfft_fused``'s middle stages (none at n = 8)."""
    levels = n.bit_length() - 1
    out = [(0, levels)]
    if levels >= 4:
        out.append((2, levels - 1))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("log_n", range(3, 15))
def test_fft_pass_plan_tiles_every_range(log_n, dtype):
    n = 1 << log_n
    size = torch.empty((), dtype=dtype).element_size()
    for s0, s1 in _ranges(n):
        for batch in (1, 3, 64):
            plan = pf.fft_pass_plan(n, s0, s1, batch, dtype)
            assert plan, (s0, s1, batch)
            assert plan[0].s0 == s0 and plan[-1].s1 == s1
            for a, b in zip(plan, plan[1:]):
                assert a.s1 == b.s0 and a.s1 > a.s0
            tr = True
            for p in plan:
                k = p.s1 - p.s0
                assert p.group == 1 << k
                assert p.shared_bytes == (4 * size * p.groups_per_block
                                          * p.group)
                assert p.shared_bytes <= pf.SMEM_BUDGET
                assert 0 < p.threads <= pf.MAX_THREADS
                groups = batch * n // p.group
                assert p.blocks * p.groups_per_block >= groups
                assert (p.blocks - 1) * p.groups_per_block < groups
                if batch > 3 and n > 1 << 11:
                    continue            # the index map at the small batches
                tr_out = pf.transposed_after(n, p.s0, p.s1, tr)
                ins, outs = pf.pass_index_map(n, p, batch, tr, tr_out)
                # groups x group size = n per FFT: every element once
                for m in (ins, outs):
                    assert m.shape == (groups, p.group)
                    assert torch.equal(torch.sort(m.reshape(-1)).values,
                                       torch.arange(batch * n))
                tr = tr_out


def test_fft_pass_plan_expected_cuts():
    f32, f64 = torch.float32, torch.float64
    # the cough rfft's middle stages at batch 32 (64 FFTs): one pass of
    # 512-value groups, 8 KB a block, 512 blocks
    (p,) = pf.fft_pass_plan(4096, 2, 11, 64, f32)
    assert (p.group, p.groups_per_block, p.threads, p.shared_bytes,
            p.blocks) == (512, 1, 256, 8192, 512)
    # fft_format over all 12 stages at n = 4096: 4096-value groups would
    # take 64 KB, over the budget, so two passes of 64
    for dt in (f32, f64):
        plan = pf.fft_pass_plan(4096, 0, 12, 64, dt)
        assert [(q.s0, q.s1, q.group) for q in plan] == [(0, 6, 64),
                                                         (6, 12, 64)]
    # few FFTs: cut further only while it brings more blocks
    plan = pf.fft_pass_plan(256, 0, 8, 3, f32)
    assert [(q.s0, q.s1) for q in plan] == [(0, 4), (4, 8)]
    # the second pass enters the natural layout
    assert not pf.transposed_after(256, 0, 4, True)
    # any n: a pass's group is bounded by shared memory, not by n
    plan = pf.fft_pass_plan(1 << 20, 0, 20, 1, f32)
    assert max(q.shared_bytes for q in plan) <= pf.SMEM_BUDGET
    assert len(pf.fft_pass_plan(1 << 14, 2, 13, 64, f32)) == 1


def _mirror(z, twiddles, s0, s1, fmt):
    """The kernel's schedule in plain torch: for each pass of the plan,
    gather each group by its index map, run the pass's stages on the
    group alone with ``posit_butterfly_torch``, scatter into the output
    layout.  ``z`` enters transposed, as ``posit_fft_stages``'s does."""
    n = twiddles.shape[-1] + 1
    tr = True
    batch = tuple(z.shape[1:-2])
    nfft = int(np.prod(batch, dtype=np.int64))
    for p in pf.fft_pass_plan(n, s0, s1, nfft, z.dtype):
        k = p.s1 - p.s0
        L0, R0 = 1 << p.s0, n >> p.s0
        tr_out = pf.transposed_after(n, p.s0, p.s1, tr)
        ins, outs = pf.pass_index_map(n, p, nfft, tr, tr_out)
        x = z.reshape(2, -1)[:, ins]                   # (2, groups, 2^k)
        first = ins[:, 0] % n                          # (l0, rr) of member 0
        l0 = first // R0 if tr else first % L0
        for t in range(k):
            h = 1 << (k - t - 1)
            x = x.reshape(2, x.shape[1], 1 << t, 2 * h)
            e, o = x[..., :h], x[..., h:]
            a = torch.arange(1 << t)
            w = twiddles[:, (1 << (p.s0 + t)) - 1
                         + l0[:, None] + a[None, :] * L0][..., None]
            u_re, u_im, v_re, v_im = posit_butterfly_torch(
                e[0], e[1], o[0], o[1], w[0], w[1], fmt)
            x = torch.stack([torch.cat([u_re, v_re], dim=1),
                             torch.cat([u_im, v_im], dim=1)])
        y = torch.empty_like(z.reshape(2, -1))
        y[:, outs] = x.reshape(2, x.shape[1], -1)
        L1, R1 = L0 << k, R0 >> k
        z = y.reshape(2, *batch, *((L1, R1) if tr_out else (R1, L1)))
        tr = tr_out
    return z, tr


@pytest.fixture
def mirrored(monkeypatch):
    """The port's FFT path with its stage range run by the mirror (on CPU
    tensors under the kernel backend)."""
    calls = []

    def stages(z, twiddles, s0, s1, fmt):
        calls.append((s0, s1))
        return _mirror(z, twiddles, s0, s1, fmt)
    monkeypatch.setattr(tdsp, "posit_fft_stages", stages)
    return calls


def _reference(name, x, full):
    """``repro.apps.dsp`` under the Pallas round backend (interpret mode),
    its FFT plan built first under the default backend, so each call
    starts from the same state whatever ran before in the process."""
    ar = JArith.make(name)
    xj = jnp.asarray(x)
    jdsp.get_fft_plan(x.shape[-1], name, str(xj.dtype))
    with jbackend(fused="on", round_backend="pallas"):
        if full:
            return jdsp.fft_format(ar, xj, jnp.zeros_like(xj))
        return jdsp.rfft_format(ar, xj)


@pytest.mark.parametrize("batch", [(3,), (2, 2)])
@pytest.mark.parametrize("n", [64, 256, 4096])
@pytest.mark.parametrize("name", FMTS)
def test_mirror_equals_stage_loop_and_pallas_reference(name, n, batch,
                                                       mirrored):
    rng = np.random.default_rng(n + len(batch))
    x = (rng.standard_normal((*batch, n)) * 30).astype(np.float32)
    ar = Arith.make(name)
    xt = torch.from_numpy(x)
    for full in (False, True):
        with backend_overrides(fused="on", round_backend="torch"):
            loop = (tdsp.fft_format(ar, xt, torch.zeros_like(xt)) if full
                    else tdsp.rfft_format(ar, xt))
        del mirrored[:]
        with backend_overrides(fused="on", round_backend="kernel"):
            got = (tdsp.fft_format(ar, xt, torch.zeros_like(xt)) if full
                   else tdsp.rfft_format(ar, xt))
        levels = n.bit_length() - 1
        assert mirrored == [(0, levels) if full else (2, levels - 1)]
        ref = _reference(name, x, full)
        for g, lp, r in zip(got, loop, ref):
            np.testing.assert_array_equal(_bits(g), _bits(lp))
            np.testing.assert_array_equal(_bits(g), _bits(r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,s0,s1,batch", [
    (4096, 2, 11, (2, 4)),      # the cough middle range, small batch
    (256, 0, 8, (3,)),          # two passes, the second entering natural
    (64, 2, 5, (5,)),           # transposed in, natural out
    (1024, 0, 10, (1,)),
    (128, 3, 7, (2,)),          # a range that starts mid-FFT
])
def test_mirror_equals_plain_version(n, s0, s1, batch, dtype):
    fmt = get_format("posit10")
    plan = tdsp.get_fft_plan(n, fmt.name, dtype, "cpu")
    rng = np.random.default_rng(s0 * 100 + n)
    shape = (2, *batch, 1 << s0, n >> s0)
    z = Arith.make(fmt.name).rnd(
        torch.from_numpy(rng.standard_normal(shape) * 50).to(dtype))
    got, tr_got = _mirror(z, plan.table, s0, s1, fmt)
    want, tr_want = pf.posit_fft_stages_torch(z, plan.table, s0, s1, fmt)
    assert tr_got == tr_want == pf.transposed_after(n, s0, s1, True)
    assert got.shape == want.shape and want.is_contiguous()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_wrapper_takes_the_plain_version_for_cpu_tensors(monkeypatch):
    def no_loader(name):
        raise AssertionError("a CPU tensor reached the kernel loader")
    monkeypatch.setattr(build, "load", no_loader)
    fmt = get_format("posit16")
    plan = tdsp.get_fft_plan(256, fmt.name, torch.float32, "cpu")
    z = torch.randn(2, 3, 4, 64, generator=torch.Generator().manual_seed(0))
    got = pf.posit_fft_stages(z, plan.table, 2, 7, fmt)
    want = pf.posit_fft_stages_torch(z, plan.table, 2, 7, fmt)
    assert got[1] == want[1]
    assert torch.equal(got[0], want[0])
    assert pf.posit_fft_stages.launches == 0


def test_plan_table_holds_every_stage_in_order():
    plan = tdsp.get_fft_plan(64, "posit16", torch.float32, "cpu")
    assert plan.table.shape == (2, 63)
    for s, (wr, wi) in enumerate(plan.stages):
        assert torch.equal(pf.stage_twiddles(plan.table, s)[0], wr)
        assert torch.equal(pf.stage_twiddles(plan.table, s)[1], wi)
