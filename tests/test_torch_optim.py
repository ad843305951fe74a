"""The port's optimizer and QAT pieces against the JAX package:

* ``wsd_schedule`` bitwise over steps 0-3000 (warmup, stable, decay and
  the floor);
* ``adamw_update`` on the same f32 params, gradients and state, with the
  clip active and inactive: params, moments and step within 4 f32 ulps
  per element of the reference's op-by-op run (XLA's jitted run contracts
  ``a*b + c`` on the CPU, which cancels differently where the moment
  update nearly cancels; SKILL.md gotchas).  Each library sums a leaf's
  squares in its own order, so on random gradients the two global norms
  may differ in the last bit, and with the clip active ``g · scale`` with
  it; where ``b1·m + (1-b1)·g·scale`` cancels, one ulp of the scale is
  hundreds of ulps of ``m``.  So the per-element bound is held on
  gradients whose sums of squares are exact in f32 in any order (k·2^-e
  for small integers k), and random gradients are held with the clip
  active at 4 ulps on the params and at a relative L2 error of 1e-6 on
  the moments;
* the global norm summed in JAX's leaf order (sorted keys), on leaves
  whose f32 sum differs in the dict's insertion order;
* ``_apply_weight_quant`` choosing the reference's leaves (every f32 or
  bf16 leaf of two or more dims, stacked norm gains included), with the
  same bits;
* ``fake_quant``'s straight-through gradient (the port of
  ``tests/test_quire_quant.py::test_fake_quant_straight_through_grad``),
  its bf16 route equal to the f32 round's bits, and its posit round going
  through the round dispatch's plain-call site that ``TRAIN_PLAIN``
  guards.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.launch.mesh import make_debug_mesh_info
from repro.models import build_model as jbuild_model
from repro.optim.adamw import adamw_update as jadamw_update
from repro.optim.adamw import global_norm as jglobal_norm
from repro.optim.schedule import wsd_schedule as jwsd_schedule
from repro.train.step import _apply_weight_quant as japply_weight_quant
from repro_torch.checkpoint import flatten_state
from repro_torch.core import arith
from repro_torch.core.formats import get_format
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quant import fake_quant
from repro_torch.kernels.counts import TRAIN_PLAIN, PlainCalls
from repro_torch.kernels.posit_round import posit_round_torch
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import wsd_schedule
from repro_torch.optim.adamw import global_norm
from repro_torch.train.step import _apply_weight_quant

ULPS = 4
# insertion order (f, e, d, ...) is not JAX's sorted order (a, b, ...)
SHAPES = {"w": (64, 48), "b": (48,), "emb": {"table": (100, 16)},
          "a": (7, 3, 5)}


def ordered(a):
    """f32 bits as integers that count ulps across zero."""
    i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def max_ulps(a, b):
    return int(np.max(np.abs(ordered(a) - ordered(b))))


def tree_of(shapes, draw):
    if isinstance(shapes, dict):
        return {k: tree_of(v, draw) for k, v in shapes.items()}
    return draw(shapes)


def to_torch(tree):
    return {k: to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_wsd_schedule_bitwise():
    steps = np.arange(3001, dtype=np.int32)
    want = np.asarray(jwsd_schedule(jnp.asarray(steps)))
    got = wsd_schedule(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # a scalar step, as the train step passes it
    for s in (0, 1, 99, 100, 1100, 1500, 2100, 2999):
        assert float(wsd_schedule(torch.tensor(s, dtype=torch.int32))) == \
            float(want[s])


def adamw_both(g, seed=0):
    """The reference's and the port's update of one seeded state by the
    gradients ``g``: ((params, m, v) of each as lists of arrays in JAX's
    leaf order, the reference's global norm)."""
    rng = np.random.default_rng(seed)
    p = tree_of(SHAPES, lambda s: rng.normal(size=s).astype(np.float32))
    m = tree_of(SHAPES, lambda s: (rng.normal(size=s) * 1e-2)
                .astype(np.float32))
    v = tree_of(SHAPES, lambda s: (rng.random(size=s) * 1e-4)
                .astype(np.float32))
    jtree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    lr = np.float32(2.5e-4)
    jp, jo = jadamw_update(jtree(p), jtree(g), {
        "m": jtree(m), "v": jtree(v), "step": jnp.int32(5)}, jnp.float32(lr))
    tp, to = adamw_update(to_torch(p), to_torch(g), {
        "m": to_torch(m), "v": to_torch(v),
        "step": torch.tensor(5, dtype=torch.int32)}, torch.tensor(lr))
    assert int(to["step"]) == int(jo["step"]) == 6
    want = [[np.asarray(w) for w in jax.tree_util.tree_leaves(t)]
            for t in (jp, jo["m"], jo["v"])]
    got = [[t.numpy() for t in flatten_state(x)[0]]
           for x in (tp, to["m"], to["v"])]
    for leaves in got:
        assert all(t.dtype == np.float32 for t in leaves)
    return want, got, float(jglobal_norm(jtree(g)))


@pytest.mark.parametrize("step_exp,kmax", [(10, 3), (3, 8)],
                         ids=["clip_off", "clip_on"])
def test_adamw_update_within_four_ulps(step_exp, kmax):
    rng = np.random.default_rng(1)
    g = tree_of(SHAPES, lambda s: (rng.integers(-kmax, kmax + 1, size=s)
                                   * 2.0 ** -step_exp).astype(np.float32))
    want, got, gnorm = adamw_both(g)
    assert (gnorm > 1.0) == (step_exp == 3)          # the clip is as named
    for w_leaves, t_leaves in zip(want, got):
        for w, t in zip(w_leaves, t_leaves):
            assert max_ulps(t, w) <= ULPS


def test_adamw_update_random_gradients_clip_on():
    rng = np.random.default_rng(2)
    g = tree_of(SHAPES, lambda s: (rng.normal(size=s) * 10.0)
                .astype(np.float32))
    (wp, wm, wv), (tp, tm, tv), gnorm = adamw_both(g)
    assert gnorm > 1.0
    for w, t in zip(wp, tp):
        assert max_ulps(t, w) <= ULPS
    for w, t in zip(wm + wv, tm + tv):
        assert np.linalg.norm(t - w) / np.linalg.norm(w) < 1e-6


def test_adamw_updates_in_place_from_init():
    params = {"w": torch.ones(3, 2), "g": torch.zeros(2)}
    state = adamw_init(params)
    assert int(state["step"]) == 0 and state["step"].dtype == torch.int32
    assert all(torch.equal(t, torch.zeros_like(t))
               for t in flatten_state(state["m"])[0])
    w = params["w"]
    new, opt = adamw_update(params, {"w": torch.full((3, 2), 0.5),
                                     "g": torch.ones(2)}, state, 1e-2,
                            AdamWConfig(weight_decay=0.0))
    assert new["w"] is w and int(opt["step"]) == 1
    # step 1: m̂ = g, v̂ = g², so each element moves by lr · g/(|g| + eps)
    assert torch.allclose(w, torch.full((3, 2), 1 - 1e-2))


def test_global_norm_sums_in_jax_leaf_order():
    rng = np.random.default_rng(20)    # a draw whose norm follows the order
    vals = (rng.normal(size=6) * np.exp(rng.normal(size=6) * 3)).astype(
        np.float32)
    names = ["f", "e", "d", "c", "b", "a"]          # insertion order
    tree = {n: np.array([v]) for n, v in zip(names, vals)}
    want = np.asarray(jglobal_norm(jax.tree_util.tree_map(jnp.asarray,
                                                          tree)))
    got = global_norm(to_torch(tree)).numpy()
    assert got.tobytes() == want.tobytes()
    inserted = np.float32(0)
    for v in vals:                                   # the dict's own order
        inserted = np.float32(inserted + v * v)
    assert np.sqrt(inserted).tobytes() != want.tobytes()


def test_weight_quant_picks_the_references_leaves():
    minfo = make_debug_mesh_info()
    with minfo.mesh:
        jm = jbuild_model(jreduced(JCONFIGS["gemma2-2b"]), minfo)
        jp = jm.init(jax.random.key(0))
        jq = japply_weight_quant(jp, JQuantPolicy(weights="posit8"))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tq = _apply_weight_quant(tp, QuantPolicy(weights="posit8"))
    # gemma2's stacked (L, d) norm gains go through the round too (a quirk
    # the port follows), final_ln (1-D) does not
    assert tq["layers"]["ln1"] is not tp["layers"]["ln1"]
    assert tq["final_ln"] is tp["final_ln"]
    raw = flatten_state(tp)[0]
    for w, t, r in zip(jax.tree_util.tree_leaves(jq), flatten_state(tq)[0],
                       raw):
        assert np.asarray(w).tobytes() == t.numpy().tobytes()
        assert (t is r) == (r.dim() < 2)
    assert _apply_weight_quant(tp, QuantPolicy()) is tp


def test_fake_quant_straight_through_grad():
    x = torch.tensor([0.3, -1.7, 42.0], requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(fake_quant(x, "posit8") * 2.0), x)
    assert torch.equal(g, torch.tensor([2.0, 2.0, 2.0]))


def test_fake_quant_bf16_is_the_f32_round_cast_back():
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=4096).astype(np.float32) * 64).to(torch.bfloat16)
    fmt = get_format("posit16")
    got = fake_quant(x, "posit16")
    assert got.dtype == torch.bfloat16
    want = posit_round_torch(x.to(torch.float32), fmt).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_fake_quant_rounds_through_the_guarded_dispatch(monkeypatch):
    """The posit round of ``fake_quant`` is the dispatch's: on a CPU tensor
    the plain round at ``core.arith.round_to_posit``, the site that
    ``TRAIN_PLAIN`` names (on the card, ``PlainCalls`` and
    ``refuse_plain_on_card`` see it there; ``tests/test_torch_card.py``)."""
    assert ("repro_torch.core.arith", "round_to_posit") in TRAIN_PLAIN
    calls = []
    real = arith.round_to_posit
    monkeypatch.setattr(arith, "round_to_posit",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.linspace(-3, 3, 64)
    fake_quant(x, "posit16")
    assert calls == [1]
    with PlainCalls(TRAIN_PLAIN) as plain:         # CPU tensors: no count
        fake_quant(x, "posit16")
    assert calls == [1, 1] and not any(plain.calls.values())
