"""The cough window core in fp16 and bf16 against ``repro.apps`` on the same
8 windows.

Tier (ROADMAP rule 1): within one format ulp.  The IEEE FFT, sums and
matmuls are sequential rounded chains, bitwise in both packages; the log
of the MFCC goes through each library's libm, so a feature may move by one
ulp of the format.  The reference compiles its 4096-point FFT graph once
per format here, which is why this file stands on its own.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import cough as jcough
from repro.core.arith import Arith as JArith
from repro.data.biosignals import cough_dataset
from repro_torch.apps import cough as tcough
from repro_torch.core.arith import Arith

_VIEW = {"fp16": (torch.float16, torch.int16),
         "bfloat16": (torch.bfloat16, torch.int16)}


def _ulp_distance(a, b, name):
    """Distance in patterns of the narrow format (1 == one format ulp);
    NaN against NaN counts 0."""
    dt, it = _VIEW[name]

    def ordered(v):
        p = torch.from_numpy(np.asarray(v, np.float32)).to(dt).view(it)
        p = p.to(torch.int64)
        return torch.where(p < 0, -(p & 0x7FFF), p)
    both_nan = np.isnan(a) & np.isnan(b)
    d = (ordered(a) - ordered(b)).abs()
    return torch.where(torch.from_numpy(both_nan), 0, d)


@pytest.mark.parametrize("name", ["fp16", "bfloat16"])
def test_ieee_cough_features_within_one_format_ulp(name):
    audio, imu, _ = cough_dataset(8, 7)
    audio, imu = audio.astype(np.float32), imu.astype(np.float32)
    ref = np.asarray(jcough.extract_features(
        JArith.make(name), jnp.asarray(audio), jnp.asarray(imu)))
    got = tcough.extract_features(Arith.make(name), torch.from_numpy(audio),
                                  torch.from_numpy(imu)).numpy()
    assert got.shape == ref.shape == (8, 65)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    assert int(_ulp_distance(got, ref, name).max()) <= 1
