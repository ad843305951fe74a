"""The port's layout rules and roofline (``repro_torch.distributed.rules``,
``distributed.sharding``, ``launch.mesh``'s production meshes,
``roofline``) held to the reference's ``tests/test_rules_roofline.py``
and to the reference's rules themselves:

* the reference's four rule and parser tests on a 2 × 4 planning mesh
  (the same records and expected bytes), its roofline dominance test on
  the H100 constants, and its two posit property tests;
* for every config on both production meshes, every leaf's spec of the
  train tree, the serve tree, the zero1 tree, the caches and the batch
  equals the reference's (``jax.eval_shape`` trees on
  ``compat.abstract_mesh``).  Where the port keeps a stack of layers as a
  list of per-layer leaves (the recurrent caches, the encdec cross K/V),
  the reference's leaf must leave the stacked dims whole and lay the rest
  out as the port's;
* every applicable cell's per-device argument bytes equal the reference's
  ``shard_shape`` sums (``launch/dryrun.py:147-151``'s trees), and
  ``model_flops`` is bitwise equal for every arch × shape;
* the MoE expert padding: reduced granite-moe at ``tp_size=3`` has the
  reference's ``init_moe(..., 3)`` stacks and gives the ``tp_size=1``
  logits and loss bitwise;
* ``analyze_step`` counts a matmul, a view, a plain posit round and the
  plain rounded matmul as computed by hand.
"""
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.configs import CONFIGS, reduced
from repro_torch.configs.base import ALL_SHAPES, shape_applies
from repro_torch.core.arith import Arith
from repro_torch.core.formats import get_format
from repro_torch.core.policy import PAPER_POLICY
from repro_torch.core.posit_scalar import decode_scalar, encode_scalar
from repro_torch.distributed.rules import (_first_fit_cache_spec, _leaf_spec,
                                           batch_shardings, cache_shardings,
                                           params_shardings,
                                           zero1_shardings)
from repro_torch.distributed.sharding import (MeshInfo, NamedSharding,
                                              PartitionSpec as P,
                                              logical_spec, replicated,
                                              shard_leaf)
from repro_torch.kernels import posit_matmul
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_info, make_production_mesh
from repro_torch.models import build_model
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import (analyze_step, collective_bytes,
                                           roofline_terms)

META = torch.device("meta")
POSIT16 = get_format("posit16")


def minfo_2x4():
    # a planning mesh: spec-level tests need axis sizes, not 8 devices
    return MeshInfo((META,) * 8, ("data", "model"), (2, 4),
                    dp_axes=("data",))


# -- the production meshes ----------------------------------------------------
def test_production_meshes_on_meta_and_their_errors():
    single = make_mesh_info()
    assert single.axis_names == ("data", "model")
    assert single.axis_sizes == (16, 16) and single.dp_size == 16
    assert single.tp_size == 16 and single.pod_axis is None
    assert set(single.devices) == {META} and len(single.devices) == 256
    multi = make_mesh_info(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.dp_axes == ("pod", "data") and multi.dp_size == 32
    assert multi.pod_axis == "pod" and len(multi.devices) == 512
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="need 256 devices"):
        make_production_mesh(device="cpu")


def test_logical_spec_degrades_to_replication():
    mi = minfo_2x4()
    assert logical_spec(mi, [(8, "batch"), (12, "model"), (5, None)]) == \
        P("data", "model", None)
    assert logical_spec(mi, [(3, "batch"), (10, "model")]) == P(None, None)
    with pytest.raises(ValueError, match="unknown logical axis"):
        logical_spec(mi, [(8, "heads")])
    assert shard_leaf(mi, [(8, "batch")]).shard_shape((8, 6)) == (4, 6)
    assert replicated(mi).shard_shape((8, 6)) == (8, 6)
    multi = make_mesh_info(multi_pod=True)
    sh = NamedSharding(multi, P(("pod", "data"), None, "model"))
    assert sh.shard_shape((64, 3, 32)) == (2, 3, 2)
    with pytest.raises(ValueError, match="does not divide"):
        sh.shard_shape((48, 3, 32))


# -- sharding rules (ports of the reference's tests) ---------------------------
def test_leaf_spec_conventions():
    mi = minfo_2x4()
    # column-parallel weight shards last dim
    assert _leaf_spec(["layers", "attn", "wq", "w"], (8, 16), mi) == \
        P(None, "model")
    # row-parallel shards dim -2
    assert _leaf_spec(["layers", "ffn", "w_down", "w"], (16, 8), mi) == \
        P("model", None)
    # embed table shards vocab
    assert _leaf_spec(["embed", "table"], (128, 8), mi) == P("model", None)
    # MoE expert dim
    assert _leaf_spec(["layers", "moe", "w_gate"], (4, 8, 8, 16), mi) == \
        P(None, "model", None, None)
    # non-divisible → replicate, loudly not wrongly
    assert _leaf_spec(["layers", "attn", "wq", "w"], (8, 10), mi) == P()
    # norms replicate
    assert _leaf_spec(["layers", "ln1"], (8,), mi) == P()


def test_cache_spec_never_tp_on_sequence():
    mi = minfo_2x4()
    # (B, S, KV, D): tp must land on D (last divisible), dp on B
    assert _first_fit_cache_spec((8, 64, 2, 16), mi) == \
        P("data", None, None, "model")
    # batch=1 long-context: dp falls to the sequence dim
    spec = _first_fit_cache_spec((1, 64, 2, 16), mi)
    assert spec[1] == "data" and spec[3] == "model"


def test_a_scaled_posit_leaf_is_refused():
    from repro_torch.core.quant import PositTensor
    leaf = PositTensor(torch.zeros((8, 16), dtype=torch.int16), POSIT16,
                       torch.ones(()))
    with pytest.raises(ValueError, match="scaled PositTensor"):
        params_shardings(minfo_2x4(), {"wq": {"w": leaf}})
    with pytest.raises(ValueError, match="scaled PositTensor"):
        cache_shardings(minfo_2x4(), [leaf])


def test_zero1_adds_data_axis():
    mi = minfo_2x4()
    params = {"layers": {"ffn": {"w_up": {"w": torch.zeros((8, 16))}}}}
    base = params_shardings(mi, params)["layers"]["ffn"]["w_up"]["w"]
    z1 = zero1_shardings(mi, params)["layers"]["ffn"]["w_up"]["w"]
    assert base.spec == P(None, "model")
    assert z1.spec == P("data", "model")


# -- roofline parsing ---------------------------------------------------------
def test_collective_bytes_parser():
    """The reference's HLO lines as records: an f32[1024,16] all-reduce, a
    bf16[64] all-gather, an all-to-all of two s16[8,4], a u8[100]
    collective-permute."""
    out = collective_bytes([
        ("all-reduce", (1024, 16), torch.float32),
        ("all-gather", (64,), torch.bfloat16),
        ("all-to-all", (8, 4), torch.int16),
        ("all-to-all", (8, 4), torch.int16),
        ("collective-permute", (100,), torch.uint8)])
    assert out["all-reduce"] == 1024 * 16 * 4 * 2.0
    assert out["all-gather"] == 64 * 2
    assert out["all-to-all"] == 2 * 8 * 4 * 2
    assert out["collective-permute"] == 100
    assert out["total"] == sum(v for k, v in out.items() if k != "total")


def test_roofline_terms_dominance():
    t = roofline_terms(flops=hw.PEAK_BF16_FLOPS, bytes_=0.0, coll=0.0)
    assert t["dominant"] == "compute" and abs(t["compute_s"] - 1.0) < 1e-9
    t = roofline_terms(flops=0.0, bytes_=hw.HBM_BW, coll=1e9)
    assert t["dominant"] == "memory" and abs(t["memory_s"] - 1.0) < 1e-9
    t = roofline_terms(flops=1e12, bytes_=1e9, coll=hw.IB_NDR_LINK_BW)
    assert t["dominant"] == "collective"
    assert abs(t["collective_s"] - 1.0) < 1e-9
    assert 0 < t["roofline_fraction"] <= 1


def test_roofline_terms_charge_f32_flops_at_the_f32_peak():
    t = roofline_terms(flops=hw.PEAK_BF16_FLOPS + hw.PEAK_F32_FLOPS,
                       bytes_=0.0, coll=0.0, flops_f32=hw.PEAK_F32_FLOPS)
    assert abs(t["compute_s"] - 2.0) < 1e-9 and t["dominant"] == "compute"
    assert roofline_terms(1e12, 1e9, 0.0, 0.0) == \
        roofline_terms(1e12, 1e9, 0.0)


# -- arith double-rounding vs exact oracle ------------------------------------
@settings(max_examples=100, deadline=None)
@given(st.floats(-100, 100, allow_nan=False, allow_subnormal=False, width=32),
       st.floats(-100, 100, allow_nan=False, allow_subnormal=False, width=32))
def test_arith_add_matches_exact_oracle_posit16(a, b):
    """f32-intermediate + round == correctly-rounded posit16 add."""
    ar = Arith.make("posit16")
    ra = float(decode_scalar(encode_scalar(a, POSIT16), POSIT16))
    rb = float(decode_scalar(encode_scalar(b, POSIT16), POSIT16))
    got = float(ar.add(torch.tensor(ra, dtype=torch.float32),
                       torch.tensor(rb, dtype=torch.float32)))
    want = float(decode_scalar(encode_scalar(ra + rb, POSIT16), POSIT16))
    assert got == want, (a, b, got, want)


# -- posit algebraic properties ------------------------------------------------
@settings(max_examples=100, deadline=None)
@given(st.integers(1, (1 << 16) - 1))
def test_posit_negation_is_twos_complement(pat):
    if pat == POSIT16.nar_pattern:
        return
    v = decode_scalar(pat, POSIT16)
    neg_pat = (-pat) & POSIT16.mask
    assert decode_scalar(neg_pat, POSIT16) == -v


# -- the reference's trees -----------------------------------------------------
MESHES = {"single": ((16, 16), ("data", "model"), ("data",)),
          "multi": ((2, 16, 16), ("pod", "data", "model"), ("pod", "data"))}
SERVE_SHAPES = ("decode_32k", "long_500k")


def ref_dryrun():
    """The reference's dry-run module: its import sets ``XLA_FLAGS`` for a
    512-device host, which is put back at once (no backend starts in
    between), so this process keeps its own devices."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


@functools.lru_cache(maxsize=None)
def ref_minfo(mesh: str):
    from repro.compat import abstract_mesh
    from repro.distributed.sharding import MeshInfo as RefMeshInfo
    shape, axes, dp = MESHES[mesh]
    return RefMeshInfo(abstract_mesh(shape, axes), dp_axes=dp)


@functools.lru_cache(maxsize=None)
def ref_trees(arch: str, mesh: str):
    """The reference's abstract params, served params, caches and batches
    of ``arch`` on ``mesh`` (``jax.eval_shape``, nothing allocated)."""
    from repro.configs import CONFIGS as RC
    from repro.core.policy import PAPER_POLICY as RP
    from repro.core.quant import quantize_params
    from repro.models import build_model as rbuild
    ref = ref_dryrun()
    cfg = RC[arch]
    minfo = ref_minfo(mesh)
    model = rbuild(cfg, minfo, RP)
    params = jax.eval_shape(model.init, jax.random.key(0))
    served = jax.eval_shape(lambda p: quantize_params(
        p, RP.fmt("weights"), cast_rest=jnp.bfloat16), params)
    caches = {}
    for name in SERVE_SHAPES:
        shape = ALL_SHAPES[name]
        if not shape_applies(cfg, shape):
            continue
        B, S = shape.global_batch, shape.seq_len
        if cfg.family == "encdec":
            fmt = RP.fmt("kv_cache")
            bits = jax.ShapeDtypeStruct(
                (cfg.n_layers, B, S // 2, cfg.n_kv_heads,
                 cfg.resolved_head_dim), fmt.storage_dtype)
            from repro.core.quant import PositTensor as RPT
            caches[name] = jax.eval_shape(lambda: (
                model.init_cache(B, S // 2),
                (RPT(bits, fmt, None), RPT(bits, fmt, None))))
        else:
            caches[name] = jax.eval_shape(lambda: model.init_cache(B, S))
    batches = {name: ref.input_specs(cfg, ALL_SHAPES[name])
               for name in ALL_SHAPES}
    return params, served, caches, batches


def ref_leaves(tree, shardings):
    """(shape, dtype, spec padded to its dims, shard bytes) of each of the
    reference's leaves, a PositTensor's bits standing for it."""
    from repro.core.quant import PositTensor as RPT
    is_leaf = lambda x: isinstance(x, RPT)  # noqa: E731
    xs = jax.tree_util.tree_leaves(tree, is_leaf=is_leaf)
    shs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    assert len(xs) == len(shs)
    out = []
    for x, sh in zip(xs, shs):
        x = x.bits if isinstance(x, RPT) else x
        spec = tuple(sh.spec) + (None,) * (len(x.shape) - len(sh.spec))
        out.append((tuple(x.shape), np.dtype(x.dtype), spec,
                    math.prod(sh.shard_shape(x.shape))
                    * np.dtype(x.dtype).itemsize))
    return out


def _spec(sh, ndim):
    return tuple(sh.spec) + (None,) * (ndim - len(sh.spec))


def assert_same_layout(port, port_sh, ref, ref_sh, what, stack=()):
    """Node for node.  Where the port holds a list of per-layer subtrees
    and the reference one subtree of stacked leaves, each of the port's
    subtrees is held to it: the reference's stacked dims (``stack``, the
    lists' lengths) whole, the rest laid out as the port's leaf."""
    import dataclasses
    from repro.core.quant import PositTensor as RPT
    from repro_torch.core.quant import PositTensor
    if isinstance(port, list) and not isinstance(ref, list):
        for p, ps in zip(port, port_sh):
            assert_same_layout(p, ps, ref, ref_sh, what, stack + (len(port),))
        return
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref), (what, sorted(port), sorted(ref))
        for k in port:
            assert_same_layout(port[k], port_sh[k], ref[k], ref_sh[k],
                               f"{what}/{k}", stack)
        return
    if isinstance(port, (list, tuple)):
        assert len(port) == len(ref), (what, len(port), len(ref))
        for i, (p, ps, r, rs) in enumerate(zip(port, port_sh, ref, ref_sh)):
            assert_same_layout(p, ps, r, rs, f"{what}/{i}", stack)
        return
    if dataclasses.is_dataclass(port) and not isinstance(port, PositTensor):
        for f in dataclasses.fields(port):
            assert_same_layout(getattr(port, f.name), getattr(port_sh, f.name),
                               getattr(ref, f.name), getattr(ref_sh, f.name),
                               f"{what}/{f.name}", stack)
        return
    x = port.bits if isinstance(port, PositTensor) else port
    r = ref.bits if isinstance(ref, RPT) else ref
    k = len(stack)
    assert tuple(r.shape) == stack + tuple(x.shape), (what, r.shape, x.shape)
    assert str(np.dtype(r.dtype)) == str(x.dtype).replace("torch.", ""), \
        (what, r.dtype, x.dtype)
    r_spec = _spec(ref_sh, len(r.shape))
    assert r_spec[:k] == (None,) * k, (what, r_spec)
    assert r_spec[k:] == _spec(port_sh, x.dim()), (what, r_spec,
                                                   port_sh.spec)


@functools.lru_cache(maxsize=None)
def port_cell(arch: str, mesh: str, shape_name: str, zero1=False,
              zero3=False):
    return dryrun.Cell(CONFIGS[arch], ALL_SHAPES[shape_name],
                       make_mesh_info(multi_pod=mesh == "multi"),
                       PAPER_POLICY, zero1=zero1, zero3=zero3)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_every_spec_equals_the_references(arch, mesh):
    from repro.distributed import rules as R
    params, served, caches, batches = ref_trees(arch, mesh)
    rmi = ref_minfo(mesh)
    mi = make_mesh_info(multi_pod=mesh == "multi")
    cell = port_cell(arch, mesh, "train_4k")
    p = cell.params
    assert_same_layout(p, params_shardings(mi, p), params,
                       R.params_shardings(rmi, params), "train")
    assert_same_layout(p, zero1_shardings(mi, p), params,
                       R.zero1_shardings(rmi, params), "zero1")
    sp = dryrun._serve_params(cell.model, p, PAPER_POLICY)
    assert_same_layout(sp, params_shardings(mi, sp), served,
                       R.params_shardings(rmi, served), "serve")
    for name, cache in caches.items():
        shape = ALL_SHAPES[name]
        state = dryrun._decode_state(cell.model, shape.global_batch,
                                     shape.seq_len)
        assert_same_layout(state, cache_shardings(mi, state), cache,
                           R.cache_shardings(rmi, cache), name)
    for name, batch in batches.items():
        port = dryrun.input_specs(CONFIGS[arch], ALL_SHAPES[name])
        assert_same_layout(port, batch_shardings(mi, port), batch,
                           R.batch_shardings(rmi, batch), name + " batch")


def ref_arg_bytes(arch, mesh, shape_name, zero1=False, zero3=False):
    """``launch/dryrun.py:135-197``'s argument trees, summed over their
    ``shard_shape``s."""
    from repro.distributed import rules as R
    params, served, caches, batches = ref_trees(arch, mesh)
    rmi = ref_minfo(mesh)
    shape = ALL_SHAPES[shape_name]

    def total(tree, shardings):
        return sum(b for *_, b in ref_leaves(tree, shardings))
    if shape.kind == "train":
        opt_fn = R.zero1_shardings if (zero1 or zero3) else \
            R.params_shardings
        p_fn = R.zero1_shardings if zero3 else R.params_shardings
        step = jax.ShapeDtypeStruct((), jnp.int32)
        return (total(params, p_fn(rmi, params))
                + 2 * total(params, opt_fn(rmi, params))
                + total(step, R.cache_shardings(rmi, step))
                + total(batches[shape_name],
                        R.batch_shardings(rmi, batches[shape_name])))
    out = total(served, R.params_shardings(rmi, served))
    if shape.kind == "prefill":
        return out + total(batches[shape_name],
                           R.batch_shardings(rmi, batches[shape_name]))
    tok = jax.ShapeDtypeStruct((shape.global_batch, 1), jnp.int32)
    cache = caches[shape_name]
    return (out + total(cache, R.cache_shardings(rmi, cache))
            + total(tok, R.batch_shardings(rmi, tok)))


CELLS = [(a, s) for a in sorted(CONFIGS) for s in ALL_SHAPES
         if shape_applies(CONFIGS[a], ALL_SHAPES[s])]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_arg_bytes_equal_the_references_shard_sums(arch, shape_name, mesh):
    got = port_cell(arch, mesh, shape_name).arg_bytes
    assert got == ref_arg_bytes(arch, mesh, shape_name)
    if ALL_SHAPES[shape_name].kind == "train":
        for flags in (dict(zero1=True), dict(zero3=True)):
            assert port_cell(arch, mesh, shape_name, **flags).arg_bytes == \
                ref_arg_bytes(arch, mesh, shape_name, **flags), flags


def test_model_flops_bitwise_for_every_arch_and_shape():
    from repro.configs import CONFIGS as RC
    ref = ref_dryrun()
    n = 0
    for arch in sorted(CONFIGS):
        for name, shape in ALL_SHAPES.items():
            got = dryrun.model_flops(CONFIGS[arch], shape)
            want = ref.model_flops(RC[arch], shape)
            assert type(got) is float and got == want, (arch, name)
            n += 1
    assert n == 40


# -- MoE expert padding ---------------------------------------------------------
def test_moe_padding_at_tp3_equals_tp1_bitwise():
    """Reduced granite-moe (4 experts) at tp_size=3 pads its stacks to 6,
    as the reference's ``init_moe(..., 3)`` does; with the real experts'
    weights the same, its logits and loss are tp_size=1's bit for bit."""
    from repro.configs import CONFIGS as RC, reduced as rreduced
    from repro.compat import abstract_mesh
    from repro.distributed.sharding import MeshInfo as RefMeshInfo
    from repro.models import build_model as rbuild
    arch = "granite-moe-3b-a800m"
    cfg = reduced(CONFIGS[arch])
    m3 = build_model(cfg, device="cpu", tp_size=3)
    p3 = m3.init(torch.Generator().manual_seed(0))
    rmodel = rbuild(rreduced(RC[arch]),
                    RefMeshInfo(abstract_mesh((1, 3), ("data", "model")),
                                dp_axes=("data",)))
    ref = jax.eval_shape(rmodel.init, jax.random.key(0))
    for k in ("w_gate", "w_up", "w_down", "router"):
        assert tuple(p3["layers"]["moe"][k].shape) == \
            tuple(ref["layers"]["moe"][k].shape), k
    assert p3["layers"]["moe"]["w_gate"].shape[1] == 6
    p1 = {**p3, "layers": {**p3["layers"], "moe": {
        k: v if k == "router" else v[:, :cfg.n_experts].contiguous()
        for k, v in p3["layers"]["moe"].items()}}}
    m1 = build_model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32))}
    l3, _ = m3.prefill(p3, batch)
    l1, _ = m1.prefill(p1, batch)
    assert torch.equal(l3, l1)
    (loss3, _), (loss1, _) = m3.loss(p3, batch), m1.loss(p1, batch)
    assert torch.equal(loss3, loss1)


# -- analyze_step -----------------------------------------------------------------
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_analyze_step_counts_by_hand(device):
    M, K, N = 8, 16, 4
    a = torch.ones((M, K), device=device)
    b = torch.ones((K, N), device=device)
    out = analyze_step(lambda x, y: x @ y, a, b)
    assert out["flops"] == out["flops_f32"] == 2 * M * N * K
    half = analyze_step(lambda x, y: x @ y, a.bfloat16(), b.bfloat16())
    assert half["flops"] == 2 * M * N * K and half["flops_f32"] == 0
    assert out["bytes"] == 4 * (M * K + K * N + M * N)
    assert out["arg_bytes_per_device"] == 4 * (M * K + K * N)
    assert out["temp_bytes_per_device"] == 4 * M * N
    view = analyze_step(lambda x: x.view(-1), a)
    assert view["bytes"] == 0 and view["ops"] == 0
    rnd = analyze_step(lambda x: Arith.make("posit16").rnd(x), a)
    assert rnd["kernel_ops"] == {"posit_round": 1} and rnd["ops"] == 1
    assert rnd["bytes"] == 2 * 4 * M * K and rnd["flops"] == 0
    mm = analyze_step(
        lambda x, y: posit_matmul.posit_matmul_round(x, y, POSIT16), a, b)
    assert mm["kernel_ops"] == {"posit_matmul_round": 1}
    assert mm["ops"] == 1 and mm["flops"] == 2 * M * N * K
    assert mm["flops_f32"] == mm["flops"]      # B3 multiplies in f32
    assert mm["bytes"] == 4 * (M * K + K * N + M * N)
