"""The slice as a whole against the reference on the CPU: the paper's
format study and the quickstart (the mixed fleet with an IEEE pin is in
``test_torch_fleet_ieee.py``).

* R-peak F1 per format equal to the reference's (the fold's peaks are
  integers; scores agree bitwise or within a format ulp of the GLF exp).
* Cough AUC within 0.02 of the reference's: each package trains its own
  forest on its own fp32 features (tier 2: matmuls and sums), so a split
  threshold may move by an ulp.
* The quickstart's numbers equal the reference's; the decode-fused
  product's error within 1e-6 (its f32 sum order is the library's).
"""
import contextlib
import io
import runpy
from pathlib import Path

from repro.apps.bayeslope import run_rpeak_detection as jrun_rpeak
from repro.apps.cough import run_cough_detection as jrun_cough
from repro_torch import quickstart
from repro_torch.apps.bayeslope import run_rpeak_detection
from repro_torch.apps.cough import run_cough_detection

ROOT = Path(__file__).resolve().parents[1]
RPEAK_FORMATS = ["fp32", "posit10", "posit8", "fp16", "fp8e5m2", "fp8e4m3"]


def test_rpeak_f1_equal_per_format():
    kw = dict(n_subjects=1, segments_per_subject=2, segment_s=12.0)
    want = jrun_rpeak(RPEAK_FORMATS, **kw)
    got = run_rpeak_detection(RPEAK_FORMATS, device="cpu", **kw)
    assert got == want
    assert got["fp8e4m3"] < 0.1                 # the paper's failure


def test_cough_auc_within_0_02_per_format():
    kw = dict(n_windows=16, n_train=32)
    want = jrun_cough(["fp32", "fp16"], **kw)
    got = run_cough_detection(["fp32", "fp16"], device="cpu", **kw)
    for name in ("fp32", "fp16"):
        assert abs(got[name]["auc"] - want[name]["auc"]) <= 0.02, name


def test_quickstart_prints_the_reference_numbers():
    ref_out = io.StringIO()
    with contextlib.redirect_stdout(ref_out):
        runpy.run_path(str(ROOT / "examples" / "quickstart.py"))
    got_out = io.StringIO()
    with contextlib.redirect_stdout(got_out):
        got = quickstart.main(["--device", "cpu"])
    ref_lines = ref_out.getvalue().splitlines()
    got_lines = got_out.getvalue().splitlines()
    assert len(got_lines) == len(ref_lines) == 6
    for g, r in zip(got_lines, ref_lines):
        if g.startswith("fused posit16 matmul"):
            ref_err = float(r.split(":")[1])
            assert abs(got["matmul_rel_err"] - ref_err) <= 1e-6
        else:
            assert g == r
