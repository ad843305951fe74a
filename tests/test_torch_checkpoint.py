"""The port's ``CheckpointManager`` and elastic re-mesh on the CPU:

* ports of ``tests/test_substrate.py:36-92`` (roundtrip, retention,
  posit16 quantization, a corrupt newest step, ``largest_valid_mesh``,
  ``remesh``) and ``tests/test_fault_tolerance.py:90-114`` (the restore
  walkback);
* parity with the reference's manager: the same posit16 state saved by
  both gives bitwise-equal ``state.npz`` arrays under every key and the
  same ``meta.json`` fields apart from ``treedef``, and each package
  restores the other's checkpoint;
* an async save snapshots the state at the call: a tensor changed in
  place right after ``save(..., block=False)`` returns still restores to
  its value at the call.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager, flatten_state
from repro_torch.core.formats import get_format
from repro_torch.distributed.fault_tolerance import (ElasticConfig,
                                                     largest_valid_mesh,
                                                     remesh)
from repro_torch.kernels.ops import decode, encode


# -- checkpoint (tests/test_substrate.py) ------------------------------------
def test_checkpoint_roundtrip_and_latest(tmp_path):
    state = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
             "step": torch.tensor(7, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (10, 20, 30):
        mgr.save(s, state)
    assert mgr.all_steps() == [20, 30]  # retention
    assert mgr.latest_step() == 30
    restored, step = mgr.restore(state)
    assert step == 30
    assert torch.equal(restored["w"], state["w"])
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 7


def test_checkpoint_posit_quantized(tmp_path):
    rng = np.random.default_rng(0)
    state = {"w": torch.from_numpy(rng.normal(size=(32, 16))
                                   .astype(np.float32))}
    mgr = CheckpointManager(str(tmp_path), keep=1, quantize_fmt="posit16",
                            async_save=False)
    mgr.save(1, state)
    restored, _ = mgr.restore(state)
    rel = float(torch.linalg.norm(restored["w"] - state["w"])
                / torch.linalg.norm(state["w"]))
    assert rel < 2e-3
    fmt = get_format("posit16")
    assert torch.equal(restored["w"], decode(encode(state["w"], fmt), fmt))
    # footprint on disk is the narrow format's
    npz = tmp_path / "step-000000001" / "state.npz"
    assert os.path.getsize(npz) < state["w"].numel() * 4


def test_checkpoint_skips_corrupt_latest(tmp_path):
    state = {"w": torch.ones((4, 4))}
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(1, state)
    mgr.save(2, {"w": state["w"] * 2})
    with open(tmp_path / "step-000000002" / "state.npz", "wb") as f:
        f.write(b"garbage")
    restored, step = mgr.restore(state)
    assert step == 1
    assert torch.equal(restored["w"], state["w"])


def test_save_is_idempotent_per_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(5, {"w": torch.zeros(2, 2)})
    mgr.save(5, {"w": torch.ones(2, 2)})        # already durable: kept
    restored, _ = mgr.restore({"w": torch.empty(2, 2)})
    assert torch.equal(restored["w"], torch.zeros(2, 2))


# -- walkback (tests/test_fault_tolerance.py) --------------------------------
def _state():
    return {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.zeros((3,), dtype=np.float32)}


def test_restore_walks_back_past_corrupt_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    s = _state()
    for step in (1, 2, 3):
        s["w"] = s["w"] + 1.0
        mgr.save(step, s, block=True)
    with open(tmp_path / "step-000000003" / "state.npz", "wb") as f:
        f.write(b"not a zipfile")
    got, step = mgr.restore(_state())
    assert step == 2
    np.testing.assert_array_equal(got["w"], _state()["w"] + 2.0)
    assert isinstance(got["w"], np.ndarray) and got["w"].dtype == np.float32


def test_restore_raises_when_every_checkpoint_is_corrupt(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    for step in (1, 2):
        mgr.save(step, _state(), block=True)
    for d in tmp_path.glob("step-*"):
        with open(d / "state.npz", "wb") as f:
            f.write(b"torn")
    with pytest.raises(FileNotFoundError, match="no restorable checkpoint"):
        mgr.restore(_state())


# -- leaf order and parity with the reference --------------------------------
def test_leaves_are_numbered_in_jax_order():
    import jax
    tree = {"w": 1, "step": 2, "z": [3, {"b": 4, "a": 5}, None], "a": (6,)}
    leaves, _ = flatten_state(tree)
    assert leaves == jax.tree_util.tree_leaves(tree) == [6, 2, 1, 3, 5, 4]


def _posit_state(rng):
    """A training state: 2-D f32 weights (quantized), a 1-D f32 leaf and
    an int32 step (kept as they are), nested, keys out of sorted order."""
    def f32(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)
    return {"step": np.int32(11),
            "params": {"wq": f32(32, 16), "norm": f32(16),
                       "mlp": {"w_up": f32(16, 48), "w_down": f32(48, 16)}},
            "opt": [f32(32, 16), f32(16)]}


def _as(state, make):
    if isinstance(state, dict):
        return {k: _as(v, make) for k, v in state.items()}
    if isinstance(state, list):
        return [_as(v, make) for v in state]
    return make(state)


def test_posit16_checkpoints_equal_the_references_and_cross_restore(tmp_path):
    import jax.numpy as jnp
    from repro.checkpoint import CheckpointManager as JManager

    base = _posit_state(np.random.default_rng(3))
    jstate = _as(base, jnp.asarray)
    tstate = _as(base, lambda a: torch.as_tensor(np.array(a)))
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    JManager(str(jdir), keep=1, quantize_fmt="posit16",
             async_save=False).save(4, jstate)
    CheckpointManager(str(tdir), keep=1, quantize_fmt="posit16",
                      async_save=False).save(4, tstate)
    metas = [json.loads((d / "step-000000004" / "meta.json").read_text())
             for d in (jdir, tdir)]
    assert metas[0].pop("treedef") and metas[1].pop("treedef")
    assert metas[0] == metas[1]
    assert sum(k.endswith("_posit") for k in metas[1]) == 4
    with np.load(jdir / "step-000000004" / "state.npz") as a, \
            np.load(tdir / "step-000000004" / "state.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
    # each package restores the other's checkpoint, to its own restore
    mine, s1 = CheckpointManager(str(tdir), quantize_fmt="posit16"
                                 ).restore(tstate)
    theirs, s2 = CheckpointManager(str(jdir), quantize_fmt="posit16"
                                   ).restore(tstate)
    assert s1 == s2 == 4
    jmine, _ = JManager(str(jdir), quantize_fmt="posit16").restore(jstate)
    jtheirs, _ = JManager(str(tdir), quantize_fmt="posit16").restore(jstate)
    for a, b, c, d in zip(*(flatten_state(t)[0]
                            for t in (mine, theirs, jmine, jtheirs))):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
        np.testing.assert_array_equal(np.asarray(c), np.asarray(d))
        np.testing.assert_array_equal(np.asarray(c), a.numpy())


@pytest.mark.parametrize("fmt", [None, "posit16"])
def test_async_save_snapshots_the_state_at_the_call(tmp_path, fmt):
    """An in-place change right after ``save(..., block=False)`` returns
    (an optimizer step, say) does not reach the file."""
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8) / 8
    b = torch.ones(8)
    step = torch.tensor(3, dtype=torch.int32)
    state = {"w": w, "b": b, "step": step}
    want = {k: v.clone() for k, v in state.items()}
    mgr = CheckpointManager(str(tmp_path), keep=2, quantize_fmt=fmt,
                            async_save=True)
    mgr.save(1, state, block=False)
    w.mul_(-3.0)
    b.add_(5.0)
    step.fill_(99)
    mgr.wait()
    got, s = mgr.restore(state)
    assert s == 1
    if fmt is not None:
        want["w"] = decode(encode(want["w"], get_format(fmt)),
                           get_format(fmt))
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_async_retention_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1, quantize_fmt="posit16")
    state = {"w": torch.randn(4, 4, generator=torch.Generator()
                              .manual_seed(1))}
    for s in (1, 2):
        mgr.save(s, state)
    mgr.wait()
    assert mgr.all_steps() == [2]
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


# -- elastic re-mesh (tests/test_substrate.py) --------------------------------
def test_elastic_mesh_shrinks_data_axis():
    cfg = ElasticConfig(model_parallel=16)
    assert largest_valid_mesh(256, cfg) == (16, 16)
    assert largest_valid_mesh(240, cfg) == (15, 16)  # lost a host
    assert largest_valid_mesh(17, cfg) == (1, 16)
    with pytest.raises(RuntimeError):
        largest_valid_mesh(8, cfg)


def test_elastic_config_has_the_references_fields():
    cfg = ElasticConfig()
    assert (cfg.model_parallel, cfg.min_data_parallel, cfg.step_deadline_s,
            cfg.max_restarts) == (16, 1, 600.0, 20)


def test_remesh_on_cpu():
    minfo = remesh(["cpu"], cfg=ElasticConfig(model_parallel=1))
    assert minfo.tp_size == 1 and minfo.dp_size == 1
    assert minfo.axis_names == ("data", "model")
    devs = [torch.device("cpu", i) for i in range(7)]
    m = remesh(devs, ElasticConfig(model_parallel=2))
    assert (m.dp_size, m.tp_size) == (3, 2)
    assert m.devices == tuple(devs[:6])
    assert m.dp_devices == (devs[0], devs[2], devs[4])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a box without CUDA")
def test_remesh_defaults_to_the_cards():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        remesh(cfg=ElasticConfig(model_parallel=1))
