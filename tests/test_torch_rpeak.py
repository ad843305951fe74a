"""The port's R-peak core against ``repro.apps.bayeslope`` on the same
inputs.

Tiers (ROADMAP rule 1): the enhancement chain is bitwise; the window scores
pass through the GLF mean and ``exp`` (tier 2, within one format ulp); the
2-means centroids are sums (tier 2); the offline R-peak lists must be
identical, for posit16, posit10 and fp32.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.apps import bayeslope as jb
from repro.apps.kmeans import kmeans_1d as jkmeans
from repro.core.arith import Arith as JArith
from repro.data.biosignals import ecg_stream_signal
from repro_torch.apps import bayeslope as tb
from repro_torch.apps.kmeans import kmeans_1d
from repro_torch.core.arith import Arith
from repro_torch.core.formats import get_format
from repro_torch.core.posit import encode


@pytest.fixture(scope="module")
def record():
    sig, _ = ecg_stream_signal(12.0, seed=42)
    return sig


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _ulp_distance(a, b, name):
    fmt = get_format(name)

    def ordered(v):
        p = encode(torch.from_numpy(np.array(v, np.float32)), fmt)
        p = p.to(torch.int64) & fmt.mask
        return (p ^ fmt.nar_pattern) - fmt.nar_pattern
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("name", ["posit16", "posit10", "posit8"])
def test_enhance_bitwise_and_scores_within_one_ulp(name, record):
    w = record[:2000].reshape(4, 500).astype(np.float32)
    ref_e = jb.enhance(JArith.make(name), jnp.asarray(w))
    got_e = tb.enhance(Arith.make(name), torch.from_numpy(w))
    np.testing.assert_array_equal(_bits(got_e), _bits(ref_e))
    ref = jb.rpeak_window_scores(JArith.make(name), jnp.asarray(w))
    got = tb.rpeak_window_scores(Arith.make(name), torch.from_numpy(w))
    assert int(_ulp_distance(got, ref, name).max()) <= 1


@pytest.mark.parametrize("name", ["posit16", "posit10", "fp32"])
def test_detect_rpeaks_identical(name, record):
    ref = jb.detect_rpeaks(JArith.make(name), record)
    got = tb.detect_rpeaks(Arith.make(name), record, device="cpu")
    assert len(ref) > 10
    assert got == ref


@pytest.mark.parametrize("warm", [False, True])
def test_kmeans_within_one_ulp(warm, record):
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, 500).astype(np.float32)
    init = np.array([0.2, 0.8], np.float32) if warm else None
    ref = jkmeans(JArith.make("posit10"), jnp.asarray(x), k=2,
                  init=None if init is None else jnp.asarray(init))
    got = kmeans_1d(Arith.make("posit10"), torch.from_numpy(x), k=2,
                    init=None if init is None else torch.from_numpy(init))
    assert int(_ulp_distance(got, ref, "posit10").max()) <= 1


def test_stage_three_four_helpers_equal(record):
    """The host-side stitching helpers are copies: same inputs, same
    outputs."""
    rng = np.random.default_rng(7)
    scores = rng.uniform(0, 1, 1500)
    res = np.zeros(0, np.float32)
    assert np.array_equal(tb.reservoir_update(res, scores),
                          jb.reservoir_update(res, scores))
    taken_j, taken_t = [], []
    assert (tb.stitch_peaks(scores, 0, 0, 1400, 1500, 0.7, 55, taken_t)
            == jb.stitch_peaks(scores, 0, 0, 1400, 1500, 0.7, 55, taken_j))
    out_j, out_t = [10], [10]
    rr_j = jb.recover_gaps(scores, 0, out_j, 900, 200.0, 0.7, 55)
    rr_t = tb.recover_gaps(scores, 0, out_t, 900, 200.0, 0.7, 55)
    assert (rr_j, out_j) == (rr_t, out_t)
