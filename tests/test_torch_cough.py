"""The port's cough window core against ``repro.apps`` on the same inputs.

Tiers (ROADMAP rule 1): the posit rfft is bitwise (elementwise rounded
chains) on every realization — fused stage loop, kernel route (its plain
versions on the CPU) and the unfused oracle; features and P(cough) pass
through matmuls, sums and log, so they hold to within one posit16 ulp.
Both packages score the same forest, carried across by
``forest_from_arrays``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.apps import cough as jcough
from repro.apps import dsp as jdsp
from repro.apps.forest import Forest as JForest
from repro.core.arith import Arith as JArith
from repro.data.biosignals import cough_dataset
from repro_torch.apps import cough as tcough
from repro_torch.apps import dsp as tdsp
from repro_torch.apps.forest import forest_from_arrays
from repro_torch.core.arith import Arith, backend_overrides
from repro_torch.core.formats import get_format
from repro_torch.core.posit import encode

B = 3


@pytest.fixture(scope="module")
def windows():
    audio, imu, _ = cough_dataset(B, 7)
    return audio.astype(np.float32), imu.astype(np.float32)


@pytest.fixture(scope="module")
def forests():
    """One trained forest as both packages' ``Forest``."""
    f = tcough.train_reference_forest(24, 123, n_trees=6, depth=4,
                                      device="cpu")
    jf = JForest(f.feat, f.thresh, f.value, f.depth)
    return jf, forest_from_arrays(jf.feat, jf.thresh, jf.value, jf.depth)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _ulp_distance(a, b, name):
    fmt = get_format(name)

    def ordered(v):
        p = encode(torch.from_numpy(np.array(v, np.float32)), fmt)
        p = p.to(torch.int64) & fmt.mask
        return (p ^ fmt.nar_pattern) - fmt.nar_pattern
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("name", ["posit16", "posit8"])
def test_rfft_format_bitwise(name, windows):
    x = windows[0][:, :, :tcough.FFT_N]
    ref_re, ref_im = jdsp.rfft_format(JArith.make(name), jnp.asarray(x))
    for kw in (dict(), dict(round_backend="kernel"), dict(fused="off")):
        with backend_overrides(**kw):
            re, im = tdsp.rfft_format(Arith.make(name), torch.from_numpy(x))
        np.testing.assert_array_equal(_bits(re), _bits(ref_re), str(kw))
        np.testing.assert_array_equal(_bits(im), _bits(ref_im), str(kw))


def test_fft_format_fused_equals_unfused():
    rng = np.random.default_rng(5)
    re = torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32))
    ar = Arith.make("posit16")
    fused = tdsp.fft_format(ar, re, im)
    with backend_overrides(fused="off"):
        unfused = tdsp.fft_format(ar, re, im)
    with backend_overrides(round_backend="kernel"):
        kernel = tdsp.fft_format(ar, re, im)
    for a, b, c in zip(fused, unfused, kernel):
        np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(_bits(a), _bits(c))


@pytest.mark.parametrize("name", ["posit16", "posit8"])
def test_features_and_p_cough_within_one_ulp(name, windows, forests):
    audio, imu = windows
    jforest, tforest = forests
    ref = np.asarray(jcough.extract_features(
        JArith.make(name), jnp.asarray(audio), jnp.asarray(imu)))
    got = tcough.extract_features(Arith.make(name), torch.from_numpy(audio),
                                  torch.from_numpy(imu)).numpy()
    assert got.shape == ref.shape == (B, 65)
    assert int(_ulp_distance(got, ref, name).max()) <= 1
    p_ref = np.asarray(jcough.make_cough_scorer(name, jforest)(
        jnp.asarray(audio), jnp.asarray(imu)))
    p_got = tcough.make_cough_scorer(name, tforest, device="cpu")(
        audio, imu).numpy()
    assert int(_ulp_distance(p_got, p_ref, name).max()) <= 1


def test_forest_from_arrays_keeps_the_trees(forests):
    jf, tf = forests
    for field in ("feat", "thresh", "value"):
        np.testing.assert_array_equal(getattr(tf, field), getattr(jf, field))
    assert tf.depth == jf.depth and tf.feat.dtype == np.int32


def test_imu_features_bitwise_where_no_reduction_reorders(windows):
    """zcr's mean of exact 0/1 flags is exact in any order."""
    imu = windows[1]
    ref = jdsp.zero_crossing_rate(JArith.make("posit16"),
                                  jnp.asarray(imu))
    got = tdsp.zero_crossing_rate(Arith.make("posit16"),
                                  torch.from_numpy(imu))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
