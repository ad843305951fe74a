"""The port's fleet dispatch over a mesh (``repro_torch.distributed``,
``launch/mesh.py``, ``StreamEngine(mesh_info=...)``) on the CPU, held to
the reference's ``tests/test_sharded_fleet.py`` contract:

* ``fleet_pad``, ``make_fleet_mesh_info`` and ``split_mesh_info``, with
  their errors;
* a 1-device mesh equals a meshless engine bitwise;
* the sharded engine (``split_mesh_info(cpu, 4)``, a batch cap of 6, so
  ``fleet_pad(6, 4) = 8`` runs on every dispatch) equals the plain engine
  bitwise on the reference's 64-patient mixed fleet: window outputs and
  peaks bitwise, ledger ``windows`` and ``total_nj`` exact,
  ``padded_windows`` only growing;
* the sharded port against the JAX engine on a small mixed fleet: the same
  windows and ledger rows, outputs at rule 1's tiers (posit ulps);
* the precondition of all of it: the rounded matmul gives a slab's rows
  the bits of the same rows of the whole batch (B3 row independence).
"""
import numpy as np
import pytest
import torch

from repro_torch.apps.cough import train_reference_forest
from repro_torch.core.arith import Arith
from repro_torch.core.formats import get_format
from repro_torch.core.posit import encode, round_posit_math
from repro_torch.data.biosignals import ecg_stream_signal
from repro_torch.distributed import MeshInfo, fleet_pad, make_fleet_batch_fn
from repro_torch.distributed.collectives import ledger_psum
from repro_torch.ingest import FleetSimulator
from repro_torch.kernels.posit_matmul import posit_matmul_round
from repro_torch.launch.mesh import (make_debug_mesh_info,
                                     make_fleet_mesh_info, split_mesh_info)
from repro_torch.stream import StreamEngine, cough_pipeline, rpeak_pipeline

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# pure helpers
# ---------------------------------------------------------------------------
def test_fleet_pad_rounds_to_shard_multiple():
    assert fleet_pad(5, 4) == 8
    assert fleet_pad(8, 4) == 8
    assert fleet_pad(1, 1) == 1
    assert fleet_pad(3, 2) == 4
    assert fleet_pad(6, 4) == 8
    assert fleet_pad(30, 4) == 32
    with pytest.raises(ValueError):
        fleet_pad(4, 0)


def test_make_fleet_mesh_info_host_fallback_and_errors():
    minfo = make_fleet_mesh_info(device="cpu")
    assert minfo.dp_size == 1 and minfo.devices == (CPU,)
    assert make_fleet_mesh_info(1, device="cpu") == minfo
    with pytest.raises(ValueError):
        make_fleet_mesh_info(0, device="cpu")
    with pytest.raises(RuntimeError, match="split_mesh_info"):
        make_fleet_mesh_info(2, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a box without CUDA")
def test_meshes_default_to_the_card_and_raise_without_one():
    for make in (make_fleet_mesh_info, lambda: split_mesh_info(None, 2),
                 make_debug_mesh_info):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_split_mesh_info_names_one_device_per_slab():
    minfo = split_mesh_info("cpu", 4)
    assert minfo.dp_size == 4 and minfo.tp_size == 1
    assert minfo.devices == (CPU,) * 4 and minfo.dp_devices == (CPU,) * 4
    assert minfo.axis_size("data") == 4
    assert hash(minfo) == hash(split_mesh_info("cpu", 4))
    with pytest.raises(ValueError):
        split_mesh_info("cpu", 0)
    dbg = make_debug_mesh_info(device="cpu")
    assert (dbg.dp_size, dbg.tp_size) == (1, 1)
    assert dbg.axis_size(("data", "model")) == 1


def test_mesh_info_lays_devices_out_by_axes():
    devs = tuple(torch.device("cpu", i) for i in range(6))
    m = MeshInfo(devs, ("data", "model"), (3, 2), dp_axes=("data",))
    assert (m.dp_size, m.tp_size) == (3, 2)
    # the first device of each data row: its model shards see the slab
    assert m.dp_devices == (devs[0], devs[2], devs[4])
    m2 = MeshInfo(devs, ("pod", "data", "model"), (2, 3, 1),
                  dp_axes=("pod", "data"))
    assert m2.dp_size == 6 and m2.dp_devices == devs
    m3 = MeshInfo(devs, ("data", "pod"), (3, 2), dp_axes=("pod", "data"))
    assert m3.dp_devices == (devs[0], devs[2], devs[4],
                             devs[1], devs[3], devs[5])
    with pytest.raises(ValueError):
        MeshInfo(devs, ("data",), (4,), dp_axes=("data",))
    with pytest.raises(ValueError):
        MeshInfo(devs, ("data",), (6,), dp_axes=("pod",))


def test_fleet_batch_fn_splits_slabs_and_sums_the_ledger_rows():
    seen = []

    def fn(arrays):
        seen.append(arrays["x"].shape[0])
        return {"y": arrays["x"][:, 0, :].sum(-1), "z": arrays["x"] * 2}

    minfo = split_mesh_info("cpu", 4)
    sharded = make_fleet_batch_fn((fn,) * 4, minfo)
    assert make_fleet_batch_fn([fn] * 4, minfo) is sharded   # cached
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 1, 3)
    mask = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.int32)
    out, row = sharded({"x": x}, mask)
    assert seen == [2, 2, 2, 2]
    assert row.dtype == torch.int64 and row.tolist() == [5, 3]
    np.testing.assert_array_equal(out["y"].numpy(), x[:, 0].sum(-1))
    np.testing.assert_array_equal(out["z"].numpy(), x * 2)
    with pytest.raises(ValueError, match="fleet_pad"):
        sharded({"x": x[:6]}, mask[:6])
    with pytest.raises(ValueError):
        make_fleet_batch_fn((fn, fn), minfo)


def test_ledger_psum_of_slab_rows_is_exact():
    rows = [torch.tensor([7, 1], dtype=torch.int32)] + [
        torch.tensor([2 ** 40 + i, 3], dtype=torch.int64) for i in range(3)]
    got = ledger_psum(rows)
    assert got.dtype == torch.int64
    assert got.tolist() == [7 + 3 * 2 ** 40 + 3, 10]


# ---------------------------------------------------------------------------
# B3 row independence: the precondition of the bit-identity contract
# ---------------------------------------------------------------------------
MAIN_PATH = {"mel": (2049, 20), "centroid": (2049, 1), "dct": (20, 13),
             "votes": (10, 1)}


@pytest.mark.parametrize("shape", sorted(MAIN_PATH))
@pytest.mark.parametrize("name", ["posit16", "posit10"])
def test_rounded_matmul_rows_do_not_depend_on_the_row_count(shape, name):
    """At each main-path shape (K, N), the first M rows of a 64-row batch
    (M = 1, 2, 4, 6) come out bitwise as the whole batch's rows, through
    the wrapper and through ``Arith.matmul``."""
    fmt = get_format(name)
    K, N = MAIN_PATH[shape]
    rng = np.random.default_rng(K + N)
    a = round_posit_math(torch.from_numpy(
        (rng.random((64, K)) * np.exp2(rng.integers(0, 40, (64, K))))
        .astype(np.float32)), fmt)
    b = round_posit_math(torch.from_numpy(
        rng.standard_normal((K, N)).astype(np.float32)), fmt)
    ar = Arith.make(name)
    whole = posit_matmul_round(a, b, fmt)
    whole_ar = ar.matmul(a, b)
    assert torch.equal(whole.view(torch.int32), whole_ar.view(torch.int32))
    for m in (1, 2, 4, 6):
        got = posit_matmul_round(a[:m].contiguous(), b, fmt)
        assert torch.equal(got.view(torch.int32),
                           whole[:m].view(torch.int32)), m
        assert torch.equal(ar.matmul(a[:m], b).view(torch.int32),
                           whole[:m].view(torch.int32)), m


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------
LEDGER_COLS = ("windows", "total_nj", "nj_per_window", "escalated_windows")


def _assert_same_results(rp, rs):
    key = lambda r: (r.patient, r.task, r.widx)        # noqa: E731
    rp, rs = sorted(rp, key=key), sorted(rs, key=key)
    assert [(r.patient, r.task, r.widx, r.fmt) for r in rp] == \
        [(r.patient, r.task, r.widx, r.fmt) for r in rs]
    for a, b in zip(rp, rs):
        assert set(a.outputs) == set(b.outputs)
        for k in a.outputs:
            x, y = np.asarray(a.outputs[k]), np.asarray(b.outputs[k])
            assert x.dtype == y.dtype and x.shape == y.shape, (a.patient, k)
            assert x.tobytes() == y.tobytes(), (a.patient, a.widx, k)


def test_one_device_mesh_degenerates_to_plain_dispatch():
    pipes = {"rpeak": rpeak_pipeline()}
    sig, _ = ecg_stream_signal(4, seed=2)
    engines = [StreamEngine(pipes, max_batch=4, device="cpu"),
               StreamEngine(pipes, max_batch=4,
                            mesh_info=make_fleet_mesh_info(1, device="cpu"))]
    assert engines[1].dp_size == 1 and engines[1].device == CPU
    for eng in engines:
        eng.ingest("p0", "rpeak", "ecg", sig[None, :])
        eng.drain()
    a, b = (e.results_for("p0", "rpeak") for e in engines)
    assert len(a) == len(b) == 2
    _assert_same_results(a, b)
    sa, sb = (e.ledger.summary() for e in engines)
    assert set(sa) == set(sb)
    for key in sa:
        for col in LEDGER_COLS:
            assert sa[key][col] == sb[key][col], (key, col)


@pytest.fixture(scope="module")
def forest():
    return train_reference_forest(48, 123, n_trees=5, depth=4, device="cpu")


def test_sharded_engine_equals_the_plain_engine_bitwise(forest):
    """The reference's 64-patient mixed fleet (cough + ECG, a quarter of
    each arm pinned), batch cap 6 over 4 slabs: every dispatch pads 6 -> 8
    rows, so the remainder path runs on every batch."""
    pipes = {"cough": cough_pipeline(forest), "rpeak": rpeak_pipeline()}
    sim = FleetSimulator(n_patients=64, windows=1, seed=3, mixed=True)
    plain = StreamEngine(pipes, max_batch=6, pad_policy="max", device="cpu")
    shard = StreamEngine(pipes, max_batch=6, pad_policy="max",
                         mesh_info=split_mesh_info("cpu", 4))
    assert shard.dp_size == 4
    sim.run_inproc(plain, arrival_seed=11)
    sim.run_inproc(shard, arrival_seed=11)
    assert len(plain.results) == len(shard.results) == 64
    assert {r.fmt for r in plain.results} == {"posit16", "fp16", "posit10",
                                              "posit8"}
    _assert_same_results(plain.results, shard.results)
    for pid, task in plain._trackers:
        assert plain.tracker_for(pid, task).peaks == \
            shard.tracker_for(pid, task).peaks, pid
    sp, ss = plain.ledger.summary(), shard.ledger.summary()
    assert set(sp) == set(ss)
    for k in sp:
        assert sp[k]["windows"] == ss[k]["windows"], k
        assert sp[k]["total_nj"] == ss[k]["total_nj"], k          # exact
    grew = False
    for (task, fmt), g in plain.ledger.stats.items():
        padded = shard.ledger.stats[(task, fmt)].padded_windows
        assert padded >= g.padded_windows
        grew |= padded > g.padded_windows
    assert grew


def _ulp_distance(a, b, name):
    fmt = get_format(name)

    def ordered(v):
        p = encode(torch.from_numpy(np.array(v, np.float32)), fmt)
        p = p.to(torch.int64) & fmt.mask
        return (p ^ fmt.nar_pattern) - fmt.nar_pattern
    return (ordered(a) - ordered(b)).abs()


def test_sharded_engine_against_the_jax_engine(forest):
    """8 patients x 2 windows (2 cough), cap 6 over 4 slabs, against the
    JAX engine at the same cap on the same forest: the same windows in the
    same formats, the same ledger ``windows`` and ``total_nj`` (exact), the
    same peak counts and tracker peaks, ``p_cough`` and ``scores`` within
    one posit ulp (rule 1: the posit sums are implementation-defined)."""
    from repro.apps.forest import Forest as JForest
    from repro.ingest import FleetSimulator as JSim
    from repro.stream import StreamEngine as JEngine
    from repro.stream import cough_pipeline as jcough
    from repro.stream import rpeak_pipeline as jrpeak

    kw = dict(n_patients=8, windows=2, seed=4, mixed=True, n_cough=2)
    jforest = JForest(forest.feat, forest.thresh, forest.value, forest.depth)
    ref = JEngine({"cough": jcough(jforest), "rpeak": jrpeak()},
                  max_batch=6, pad_policy="max", result_capacity=None)
    JSim(**kw).run_inproc(ref)
    got = StreamEngine({"cough": cough_pipeline(forest),
                        "rpeak": rpeak_pipeline()}, max_batch=6,
                       pad_policy="max", result_capacity=None,
                       mesh_info=split_mesh_info("cpu", 4))
    FleetSimulator(**kw).run_inproc(got)
    rres = {(r.patient, r.widx, r.fmt): r.outputs for r in ref.results}
    gres = {(r.patient, r.widx, r.fmt): r.outputs for r in got.results}
    assert set(gres) == set(rres) and len(gres) == 16
    assert {k[2] for k in gres} == {"posit16", "posit10", "posit8"}
    for key, r in rres.items():
        g = gres[key]
        out = "p_cough" if "p_cough" in r else "scores"
        assert int(_ulp_distance(g[out], r[out], key[2]).max()) <= 1, key
        if out == "scores":
            assert int(g["peak_count"]) == int(r["peak_count"]), key
            np.testing.assert_array_equal(g["peaks"], r["peaks"])
    sr, sg = ref.ledger.summary(), got.ledger.summary()
    assert set(sr) == set(sg)
    for k in sr:
        assert sg[k]["windows"] == sr[k]["windows"], k
        assert sg[k]["total_nj"] == sr[k]["total_nj"], k
