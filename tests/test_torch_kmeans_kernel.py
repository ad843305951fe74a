"""The one-launch 2-means (``kernels/posit_kmeans.py``) against
``apps/kmeans.py::kmeans_1d``'s per-op path, on the CPU.

The kernel sums each centroid's contributions in a fixed order; the per-op
path, its plain version, sums them with ``torch.sum``.  Every other op is
the same.  ``kernel_2means`` below is the kernel's arithmetic in torch ops,
its sums in the kernel's order (``kernel_order_sum``): it is bitwise equal
to the per-op path wherever the order cannot decide a posit rounding (every
case below), and, on data where an f32 sum can be inexact, every difference
must come from the two orders' f32 sums rounding apart.  The route is taken
on the card only (an f32 CUDA tensor, a posit format, fused kernels on,
quire off); here ``kernel_2means`` stands in for the kernel to drive it
inside ``RPeakFold``.  The card tests hold the kernel itself against the
per-op path.
"""
import numpy as np
import pytest
import torch

from repro_torch.apps import bayeslope, kmeans
from repro_torch.apps.kmeans import kmeans_1d, kmeans_route
from repro_torch.core.arith import Arith, backend_overrides
from repro_torch.core.posit import round_posit_math
from repro_torch.data.biosignals import ecg_stream_signal
from repro_torch.kernels import counts
from repro_torch.kernels import posit_kmeans as pk
from repro_torch.obs.trace import Tracer, use

KERNEL_THREADS = 512            # csrc/posit_kmeans.cu kThreads


def kernel_order_sum(v: torch.Tensor) -> torch.Tensor:
    """Column sums of ``v`` (n, k) in the kernel's order: thread ``t`` adds
    rows t, t + KERNEL_THREADS, ... in turn from +0, then the partials are
    added pairwise, s[i] + s[i + h] for h = KERNEL_THREADS/2, ..., 1."""
    n, k = v.shape
    T = KERNEL_THREADS
    rows = -(-n // T)
    pad = torch.zeros((rows * T, k), dtype=v.dtype, device=v.device)
    pad[:n] = v
    acc = torch.zeros((T, k), dtype=v.dtype, device=v.device)
    for r in range(rows):
        acc = acc + pad[r * T:(r + 1) * T]
    h = T
    while h > 1:
        h //= 2
        acc = acc[:h] + acc[h:2 * h]
    return acc[0]


def kernel_2means(x: torch.Tensor, fmt, iters: int = 12, init=None):
    """``posit_kmeans_1d``'s arithmetic in torch ops: ``kmeans_1d``'s
    rounded ops with the centroid sums in the kernel's order."""
    def rnd(v):
        return round_posit_math(v, fmt)

    x = rnd(x)
    if init is not None:
        cent = rnd(torch.as_tensor(init).to(x.device, torch.float32))
    else:
        lo, hi = torch.min(x), torch.max(x)
        cent = rnd(torch.stack([lo + (hi - lo) * 0.0, hi]))
    ids = torch.arange(2, device=x.device)
    for _ in range(iters):
        d = torch.abs(rnd(x[:, None] - cent[None, :]))
        member = torch.argmin(d, dim=1)[:, None] == ids     # (n, 2)
        cnt = torch.clamp(member.sum(dim=0), min=1).to(x.dtype)
        contrib = rnd(torch.where(member, x[:, None],
                                  torch.zeros((), dtype=x.dtype)) / cnt)
        cent = rnd(kernel_order_sum(contrib))
    return cent


POSITS = ("posit8", "posit10", "posit16")
LENGTHS = (1, 2, 100, 499, 500)
NAN, INF = float("nan"), float("inf")


def _bits(t):
    return torch.as_tensor(t).to(torch.float32).view(torch.int32).tolist()


def _reservoir(kind: str, n: int, seed: int) -> np.ndarray:
    """A reservoir of ``n`` scores of ``kind``: the tracker's (the
    logistic's [0.27, 1] and sanitized zeros), one cluster (the other
    count clamps to 1), ties (values midway between the start's
    centroids), or NaN and ±Inf among scores."""
    rng = np.random.default_rng(seed)
    if kind == "scores":
        x = rng.uniform(0.2689, 1.0, n)
        x[rng.random(n) < 0.1] = 0.0
    elif kind == "one_cluster":
        x = np.full(n, 0.3125)
    elif kind == "ties":
        # 0.25, 0.5, 0.75 repeat: a cold start's centroids are 0.25 and
        # 0.75 (n >= 3) and the warm start's too, so 0.5 ties
        x = np.resize([0.5, 0.25, 0.75], n)
    else:
        x = rng.uniform(0.2689, 1.0, n)
        x[::7] = NAN
        x[1::11] = INF
        x[2::13] = -INF
    return np.asarray(x, np.float32)


WARM = np.array([0.25, 0.75], np.float32)


@pytest.mark.parametrize("kind", ["scores", "one_cluster", "ties",
                                  "nonfinite"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("name", POSITS)
def test_plain_version_bitwise_equals_per_op_path(name, n, warm, kind):
    """The kernel's arithmetic (``kernel_2means``) bitwise its plain
    version, the per-op path."""
    ar = Arith.make(name)
    x = torch.from_numpy(_reservoir(kind, n, seed=n))
    init = WARM if warm else None
    want = kmeans_1d(ar, x, k=2, iters=12,
                     init=None if init is None else torch.from_numpy(init))
    got = kernel_2means(x, ar.fmt, iters=12, init=init)
    assert _bits(got) == _bits(want)
    if kind == "one_cluster" and not warm:
        # every value in cluster 0; cluster 1's count clamps to 1
        assert _bits(got[1]) == _bits(0.0)


def _first_divergence(ar, x, init, iters=12):
    """None where the kernel's arithmetic equals the per-op path; else
    the first iteration where they part, each centroid that parts there
    and both orders' f32 sums of its contributions from the shared
    centroids before it."""
    for it in range(iters + 1):
        want = kmeans_1d(ar, x, iters=it, init=init)
        got = kernel_2means(x, ar.fmt, iters=it, init=init)
        if _bits(want) != _bits(got):
            break
    else:
        return None
    prev = kmeans_1d(ar, x, iters=it - 1, init=init)

    def rnd(v):
        return round_posit_math(v, ar.fmt)
    xr = rnd(x)
    member = torch.argmin(torch.abs(rnd(xr[:, None] - prev[None, :])),
                          dim=1)[:, None] == torch.arange(2)
    cnt = torch.clamp(member.sum(dim=0), min=1).to(torch.float32)
    contrib = rnd(torch.where(member, xr[:, None], torch.zeros(())) / cnt)
    tree = kernel_order_sum(contrib)
    parts = []
    for j in range(2):
        if _bits(want[j]) != _bits(got[j]):
            wide = torch.sum(contrib[:, j].contiguous())
            parts.append((j, float(wide), float(tree[j]),
                          _bits(rnd(wide)) == _bits(want[j]),
                          _bits(rnd(tree[j])) == _bits(got[j])))
    return it, parts


@pytest.mark.parametrize("dist", ["uniform", "lognormal"])
def test_wide_data_differs_only_where_the_sum_order_decides(dist):
    """On data spanning many binades an f32 sum can be inexact; the
    kernel's arithmetic may then part from the per-op path, but only at a
    centroid whose two f32 sums differ and round to the two results."""
    for seed in range(60):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1, 501))
        x = (rng.uniform(0, 1, n) if dist == "uniform"
             else rng.lognormal(-2, 2, n)).astype(np.float32)
        ar = Arith.make(POSITS[seed % 3])
        init = None if seed % 2 else np.sort(rng.uniform(0, 1, 2)).astype(
            np.float32)
        found = _first_divergence(
            ar, torch.from_numpy(x),
            None if init is None else torch.from_numpy(init))
        if found is None:
            continue
        it, parts = found
        assert it >= 1 and parts
        for j, wide, tree, ops_ok, tree_ok in parts:
            assert wide != tree and ops_ok and tree_ok, (seed, it, j)


def test_route_only_for_posit_f32_card_fused_without_quire():
    p10 = Arith.make("posit10")
    assert kmeans_route(p10, "cuda") == "kernel"
    assert kmeans_route(p10, torch.device("cuda", 0)) == "kernel"
    assert kmeans_route(p10, "cpu") == "ops"
    assert kmeans_route(p10, "cuda", torch.float64) == "ops"
    for k in (1, 3):                    # the kernel is a 2-means
        assert kmeans_route(p10, "cuda", k=k) == "ops"
    for name in ("fp16", "bfloat16", "fp8e4m3", "fp32"):
        assert kmeans_route(Arith.make(name), "cuda") == "ops"
    with backend_overrides(quire="on"):
        assert kmeans_route(p10, "cuda") == "ops"
    with backend_overrides(fused="off"):
        assert kmeans_route(p10, "cuda") == "ops"
    with backend_overrides(fused="on", quire="off"):
        assert kmeans_route(p10, "cuda") == "kernel"


def _kernel_stand_in(calls):
    """A stand-in for ``posit_kmeans_1d`` on CPU tensors: records each
    call's arguments and returns the kernel's arithmetic."""
    def launch(x, fmt, iters=12, init=None):
        calls.append((x.dtype, x.is_contiguous(), fmt, iters,
                      None if init is None else type(init)))
        return kernel_2means(x, fmt, iters=iters, init=init)
    return launch


def test_kmeans_1d_takes_the_wrapper_where_the_route_says_kernel(
        monkeypatch):
    calls = []
    ar = Arith.make("posit10")
    monkeypatch.setattr(kmeans, "kmeans_route",
                        lambda ar, device, dtype=torch.float32, k=2:
                        "kernel")
    monkeypatch.setattr(kmeans, "posit_kmeans_1d", _kernel_stand_in(calls))
    x = torch.from_numpy(_reservoir("scores", 600, seed=3))[::2]
    got = kmeans_1d(ar, x, iters=7, init=WARM)
    monkeypatch.undo()
    want = kmeans_1d(ar, x, iters=7, init=WARM)
    # the view made contiguous, the warm start left on the host
    assert calls == [(torch.float32, True, ar.fmt, 7, np.ndarray)]
    assert _bits(got) == _bits(want)


def test_wrapper_counts_itself_and_is_in_the_launch_counts():
    """The wrapper is in ``launch_counts``; it takes CUDA tensors only
    (``kmeans_1d`` runs the per-op path elsewhere), and a refused call
    counts no launch."""
    assert counts.launch_counts()["posit_kmeans_1d"] == \
        pk.posit_kmeans_1d.launches
    assert all(n != "posit_kmeans_1d"
               for _, n in counts.STREAM_PLAIN + counts.SERVE_PLAIN)
    before = pk.posit_kmeans_1d.launches
    with pytest.raises(ValueError, match="on the card"):
        pk.posit_kmeans_1d(torch.ones(4), Arith.make("posit10").fmt)
    assert pk.posit_kmeans_1d.launches == before


def test_rpeak_threshold_span_reads_the_route_only_when_traced(
        monkeypatch):
    """``rpeak.threshold``'s ``route`` is read only with a tracer current:
    untraced, ``kmeans_route`` is never asked for it."""
    sig, _ = ecg_stream_signal(20.0, seed=5)
    ar = Arith.make("posit10")
    asked = []
    real = bayeslope.kmeans_route
    monkeypatch.setattr(bayeslope, "kmeans_route",
                        lambda *a, **kw: asked.append(1) or real(*a, **kw))
    bayeslope.detect_rpeaks(ar, sig, device="cpu")
    assert asked == []
    tracer = Tracer()
    with use(tracer):
        bayeslope.detect_rpeaks(ar, sig, device="cpu")
    spans = [ev for ev in tracer.events() if ev[2] == "rpeak.threshold"]
    assert spans and len(asked) == len(spans)
    assert all(ev[6] == {"iters": bayeslope.KMEANS_ITERS, "route": "ops"}
               for ev in spans)


@pytest.mark.parametrize("name", POSITS)
def test_rpeak_fold_same_peaks_and_thresholds_on_the_kernel_route(
        name, monkeypatch):
    """``RPeakFold`` with the 2-means through the kernel's arithmetic
    (``kernel_2means`` standing in for the kernel) gives the per-op path's
    threshold at every window and the same peaks."""
    sig, _ = ecg_stream_signal(40.0, seed=11)
    ar = Arith.make(name)

    def fold_run():
        thrs = []
        real = bayeslope.threshold_update

        def rec(*a, **kw):
            out = real(*a, **kw)
            thrs.append(out[0])
            return out
        monkeypatch.setattr(bayeslope, "threshold_update", rec)
        peaks = bayeslope.detect_rpeaks(ar, sig, device="cpu")
        monkeypatch.setattr(bayeslope, "threshold_update", real)
        return peaks, thrs

    want, want_thr = fold_run()
    calls = []
    monkeypatch.setattr(kmeans, "kmeans_route",
                        lambda *a, **kw: "kernel")
    monkeypatch.setattr(kmeans, "posit_kmeans_1d", _kernel_stand_in(calls))
    got, got_thr = fold_run()
    assert len(calls) == len(got_thr)
    assert len(want) > 20 and got == want
    assert np.array_equal(np.array(got_thr), np.array(want_thr),
                          equal_nan=True)
