"""Multi-pod dry run: plan every (arch × shape × mesh) cell — the
counterpart of ``repro.launch.dryrun``.

The reference lowers and compiles each cell's step on 512 forced host
devices, reads XLA's cost and memory analyses, parses the HLO for
collectives and corrects for scan bodies counted once.  The port has no
partitioner and no compiler to ask, so for each cell this script:

  1. builds the production mesh (16×16 single-pod / 2×16×16 multi-pod) on
     ``meta`` (``launch.mesh.make_mesh_info``);
  2. builds the cell's abstract state on ``meta`` at full width, the MoE
     expert stacks padded to the model axis: for training the f32 params,
     AdamW's ``m``, ``v`` and ``step``; for serving the posit weights
     (``quantize_params(..., cast_rest=bf16)``) and the cache (for
     ``encdec`` the cross K/V too); then the batch.  Its bytes per device
     are the sum of each leaf's ``shard_shape`` under the layout rules
     (``distributed.rules``), with the zero1/zero3 variants as the
     reference chooses them;
  3. traces the step on ``meta`` at the data shard's batch (B / dp where
     dp divides B, else B, as ``batch_shardings`` decides) through
     ``roofline.analysis.analyze_step`` — every op's shape checked at the
     production shape, nothing allocated: the counterpart of the compile
     proof.  ``compile_s`` holds that trace's seconds.  FLOPs, bytes and
     the step's temporaries are the trace's divided by tp: an even split
     over the model axis, the port's assumption (``notes`` says so);
  4. plans the collectives, as records for ``collective_bytes``: (a) in
     training each parameter's local shard reduced over dp (an all-reduce,
     or a reduce-scatter and an all-gather under zero1/zero3); (b) each MoE
     layer's psum over tp of its (T_loc, d) f32 output
     (``repro/models/moe.py:105``), once more in a train step's backward;
     (c) multi-pod with a ``grad_allreduce`` format, the pod branch's posit
     all-reduce of every gradient leaf at its storage width (the trace runs
     ``plain_grads``: no process group); (d) the output of each
     ``ROW_PAR`` weight that the rules shard over tp, all-reduced over tp
     in the forward and once more in a train step's backward — the port's
     model of what GSPMD inserts;
  5. corrects: the Python loops are traced as they run, but the ones whose
     trip count grows with S — chunked attention's key blocks, the sLSTM's
     positions, the mLSTM and SSD chunks — would take the CPU minutes to
     hours at 32k positions.  They are counted by difference: the trace
     runs two, then three, real trips a call (the other trips dispatch
     nothing), and the difference scales to the full trip count, as the
     reference solves its scan bodies (``raw`` is the two-trip trace).
     The peak is scaled the same way, an estimate: it need not grow by
     the same bytes each trip.  Every other loop (the layers) is traced in
     full.  Unlike the reference, the multi-pod cells are corrected too;
     ``--no-corrections`` traces every trip;
  6. adds MODEL_FLOPS and the three roofline terms on the H100 SXM5's
     constants (``roofline.hw``), the FLOPs on f32 operands charged at the
     f32 peak (``notes`` gives their share).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import CONFIGS, get_config
from repro_torch.configs.base import (ALL_SHAPES, ModelConfig, ShapeConfig,
                                      shape_applies)
from repro_torch.core.policy import (AGGRESSIVE_POLICY, NO_QUANT,
                                     PAPER_POLICY, QuantPolicy)
from repro_torch.core.quant import PositTensor, quantize_params
from repro_torch.distributed.rules import (ROW_PAR, _leaf_spec,
                                           batch_shardings,
                                           cache_shardings, params_shardings,
                                           tree_leaves, tree_map_with_path,
                                           zero1_shardings)
from repro_torch.distributed.sharding import MeshInfo
from repro_torch.launch.mesh import make_mesh_info, split_mesh_info
from repro_torch.models import build_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.roofline.analysis import (KernelRecorders, analyze_step,
                                           collective_bytes,
                                           patch_everywhere, roofline_terms)
from repro_torch.train.step import make_train_step

POLICIES = {
    "none": NO_QUANT,
    "paper": PAPER_POLICY,
    "aggressive": AGGRESSIVE_POLICY,
}
META = torch.device("meta")


# ---------------------------------------------------------------------------
# Input specs (meta tensors — no allocation)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                batch: Optional[int] = None, device=META
                ) -> Dict[str, torch.Tensor]:
    """Training/prefill batch stand-ins for one global step (or ``batch``
    rows of it): int32 tokens, bf16 frames and frontend."""
    B = shape.global_batch if batch is None else batch
    S = shape.seq_len

    def sds(s, dtype):
        return torch.empty(s, dtype=dtype, device=device)
    if cfg.family == "encdec":
        return {
            "frames": sds((B, S // 2, cfg.d_model), torch.bfloat16),
            "tokens": sds((B, S // 2), torch.int32),
        }
    if cfg.family == "vlm":
        return {
            "tokens": sds((B, S - cfg.frontend_len), torch.int32),
            "frontend": sds((B, cfg.frontend_len, cfg.d_model),
                            torch.bfloat16),
        }
    return {"tokens": sds((B, S), torch.int32)}


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS (the reference's formulas)
# ---------------------------------------------------------------------------

def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    B, S = shape.global_batch, shape.seq_len
    d, hd = cfg.d_model, cfg.resolved_head_dim
    emb = 2 * cfg.padded_vocab * d
    N = max(cfg.n_active_params() - emb, 1)
    # attention-context term (quadratic layers only)
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        L_attn = cfg.n_layers + cfg.enc_layers
    elif cfg.family == "hybrid":
        L_attn = cfg.n_layers // max(cfg.shared_attn_every, 1)
    else:
        L_attn = 0
    attn_dim = cfg.n_heads * hd

    if shape.kind == "train":
        flops = 6.0 * N * B * S
        flops += 12.0 * L_attn * B * S * S * attn_dim * 0.5
    elif shape.kind == "prefill":
        flops = 2.0 * N * B * S
        flops += 4.0 * L_attn * B * S * S * attn_dim * 0.5
    else:  # decode: one token per sequence against an S-token context
        flops = 2.0 * N * B
        flops += 4.0 * L_attn * B * S * attn_dim
    return flops


# ---------------------------------------------------------------------------
# The cell's state and its bytes
# ---------------------------------------------------------------------------

def _cross_state(model, B: int, S_src: int, device=META):
    """Abstract cross-attention K/V of ``encdec`` decode: one (K, V) pair
    a decoder layer, (B, S_src, KV, hd), posit bits under a KV format."""
    cfg = model.cfg
    fmt = model.policy.fmt("kv_cache")
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shp = (B, S_src, KV, hd)

    def one():
        if fmt is None:
            return torch.empty(shp, dtype=torch.bfloat16, device=device)
        return PositTensor(torch.empty(shp, dtype=fmt.storage_dtype,
                                       device=device), fmt, None)
    return [(one(), one()) for _ in range(cfg.n_layers)]


def _leaf_tensor(leaf) -> torch.Tensor:
    return leaf.bits if isinstance(leaf, PositTensor) else leaf


def shard_bytes(tree, shardings) -> int:
    """Bytes of one device's shards of ``tree``'s leaves."""
    return sum(math.prod(sh.shard_shape(_leaf_tensor(x).shape))
               * _leaf_tensor(x).element_size()
               for x, sh in zip(tree_leaves(tree), tree_leaves(shardings)))


def _serve_params(model, params, policy: QuantPolicy):
    """The served weights: posit bits per policy, the rest in bf16, built
    on ``meta`` through the kernels' plain versions."""
    if policy.weights is None:
        return params
    with KernelRecorders():
        return quantize_params(params, policy.fmt("weights"),
                               cast_rest=torch.bfloat16)


def _decode_state(model, B: int, S: int):
    if model.cfg.family == "encdec":
        return (model.init_cache(B, S // 2), _cross_state(model, B, S // 2))
    return model.init_cache(B, S)


def shard_batch(minfo: MeshInfo, B: int) -> int:
    """The rows a data shard holds, as ``batch_shardings`` lays them."""
    return B // minfo.dp_size if B % minfo.dp_size == 0 and B > 1 else B


# ---------------------------------------------------------------------------
# Collectives (planned)
# ---------------------------------------------------------------------------

def _tokens(cfg: ModelConfig, shape: ShapeConfig, B_loc: int, tower: str
            ) -> int:
    """Positions a layer of ``tower`` ("encoder" or the decoder) runs over
    in one pass of the step, on a data shard."""
    S = shape.seq_len
    if cfg.family == "encdec":
        if tower == "encoder":
            return 0 if shape.kind == "decode" else B_loc * (S // 2)
        return B_loc * (1 if shape.kind == "decode" else S // 2)
    return B_loc * (1 if shape.kind == "decode" else S)


def _uses(model, names) -> int:
    """How many times a pass applies the weight at ``names``: once a
    stacked layer, and zamba's shared block once a group."""
    return model.n_groups if names[0] == "shared" else 1


def plan_collectives(model, params, minfo: MeshInfo, shape: ShapeConfig,
                     policy: QuantPolicy, B_loc: int, *, zero: bool):
    """The cell's collective records (module docstring, step 4)."""
    cfg = model.cfg
    dp, tp = minfo.dp_size, minfo.tp_size
    train = shape.kind == "train"
    passes = 2 if train else 1       # the forward, and a train backward
    records = []
    p_sh = params_shardings(minfo, params)
    if train and dp > 1:             # (a)
        z_sh = zero1_shardings(minfo, params) if zero else p_sh
        for x, ps, zs in zip(tree_leaves(params), tree_leaves(p_sh),
                             tree_leaves(z_sh)):
            local = ps.shard_shape(x.shape)
            if zs.spec == ps.spec:
                records.append(("all-reduce", local, torch.float32))
            else:
                records.append(("reduce-scatter", zs.shard_shape(x.shape),
                                torch.float32))
                records.append(("all-gather", local, torch.float32))
    if tp > 1 and cfg.n_experts:     # (b)
        T = _tokens(cfg, shape, B_loc, "decoder")
        for _ in range(cfg.n_layers * passes):
            records.append(("all-reduce", (T, cfg.d_model), torch.float32))
    fmt = policy.fmt("grad_allreduce")
    if train and fmt is not None and minfo.pod_axis is not None:   # (c)
        for x, ps in zip(tree_leaves(params), tree_leaves(p_sh)):
            records.append(("all-reduce", ps.shard_shape(x.shape),
                            fmt.storage_dtype))
    if tp > 1:                       # (d)
        def row(path, x):
            names = [str(e) for e in path]
            if len(names) < 2 or names[-1] != "w" or \
                    names[-2] not in ROW_PAR or "moe" in names:
                return
            if minfo.tp_axis not in _leaf_spec(names, x.shape, minfo):
                return
            T = _tokens(cfg, shape, B_loc, names[0])
            if not T:
                return
            n = math.prod(x.shape[:-2]) * _uses(model, names) * passes
            for _ in range(n):
                records.append(("all-reduce", (T, x.shape[-1]),
                                torch.bfloat16))
        tree_map_with_path(row, params)
    return records


# ---------------------------------------------------------------------------
# Loops counted by difference
# ---------------------------------------------------------------------------

_COUNTS = ("flops", "flops_f32", "bytes", "temp_bytes_per_device")
BASE_TRIPS = 2        # the real trips a call of the base trace


class _Loops:
    """While entered, the Python loops whose trip count grows with S run
    ``n[kind]`` real trips a call (``BASE_TRIPS`` by default), and their
    other trips dispatch nothing: each ``chunked_attention`` query block
    attends that many key blocks (the carries pass through the rest), and
    each sLSTM, mLSTM or SSD forward runs that many positions or chunks
    (the rest repeat the last step's outputs).  A trip's work is the same
    at every index from the second on (the first takes its carry from
    constants, which need no gradient; the last's carry may go unused), so
    from two real trips on the counts are affine in each ``n``; ``trips``
    maps each kind that ran to the full trip count of its calls."""

    def __init__(self, n=None):
        self.n = dict(n or {})
        self.trips = {}

    def _trips(self, kind, count):
        if self.trips.setdefault(kind, count) != count:
            raise ValueError(f"{kind}: calls of {self.trips[kind]} and "
                             f"{count} trips in one cell")

    def _seq(self, kind, fwd, step, trips_of):
        """Wrap a sequence forward and its step function: the forward
        starts a count, the step runs its first n trips."""
        n, state = self.n.get(kind, BASE_TRIPS), {"calls": 0, "last": None}

        def forward(*a, **kw):
            self._trips(kind, trips_of(*a, **kw))
            state["calls"], state["last"] = 0, None
            return fwd(*a, **kw)

        def one(*a, **kw):
            state["calls"] += 1
            if state["calls"] <= n:
                state["last"] = step(*a, **kw)
            return state["last"]
        patch_everywhere(self._saved, fwd, forward)
        patch_everywhere(self._saved, step, one)

    def __enter__(self):
        from repro_torch.models import attention, ssm, xlstm
        self._saved = []
        pair, n_pair = attention._block_pair, \
            self.n.get("attention key blocks", BASE_TRIPS)

        def block_pair(carry, q_blk, qpos, kb, vb, kj, **kw):
            self._trips("attention key blocks", kb.shape[1])
            return carry if kj >= n_pair else pair(carry, q_blk, qpos, kb,
                                                   vb, kj, **kw)
        patch_everywhere(self._saved, pair, block_pair)

        def chunks(default):
            def count(p, x, cfg, chunk=default):
                return x.shape[1] // min(chunk, x.shape[1])
            return count
        self._seq("sLSTM positions", xlstm.slstm_forward, xlstm._slstm_step,
                  lambda p, x, cfg: x.shape[1])
        self._seq("mLSTM chunks", xlstm.mlstm_forward, xlstm._mlstm_chunk,
                  chunks(xlstm.CHUNK))
        self._seq("SSD chunks", ssm.ssm_forward, ssm._chunk_step,
                  chunks(ssm.CHUNK))
        return self

    def __exit__(self, *exc):
        for mod, attr, val in reversed(self._saved):
            setattr(mod, attr, val)




# ---------------------------------------------------------------------------
# Cell planning
# ---------------------------------------------------------------------------

class Cell:
    """A cell's abstract state on ``meta``: the model (its expert stacks
    padded to the mesh's model axis), its f32 parameters, the argument
    bytes a device holds (``arg_bytes``, under the layout rules), and
    ``trace()``, which traces the step at the data shard's batch."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, minfo: MeshInfo,
                 policy: QuantPolicy, *, microbatches: int = 1,
                 zero1: bool = False, zero3: bool = False):
        B, S = shape.global_batch, shape.seq_len
        self.B_loc = B_loc = shard_batch(minfo, B)
        self.model = model = build_model(cfg, policy, device=META,
                                         tp_size=minfo.tp_size)
        self.params = params = model.init(torch.Generator())
        batch = input_specs(cfg, shape)
        if shape.kind == "train":
            opt = adamw_init(params)
            opt_sh_fn = zero1_shardings if (zero1 or zero3) \
                else params_shardings
            # zero3: the master params sharded over data as well
            p_sh_fn = zero1_shardings if zero3 else params_shardings
            self.arg_bytes = (
                shard_bytes(params, p_sh_fn(minfo, params))
                + 2 * shard_bytes(params, opt_sh_fn(minfo, params))
                + shard_bytes(opt["step"], cache_shardings(minfo,
                                                           opt["step"]))
                + shard_bytes(batch, batch_shardings(minfo, batch)))
            step = make_train_step(model, split_mesh_info(META, 1), policy,
                                   microbatches=microbatches)
            self.trace = lambda: analyze_step(
                step, {"params": params, "opt": opt},
                input_specs(cfg, shape, B_loc))
            return
        sparams = _serve_params(model, params, policy)
        self.arg_bytes = shard_bytes(sparams,
                                     params_shardings(minfo, sparams))
        if shape.kind == "prefill":
            self.arg_bytes += shard_bytes(batch,
                                          batch_shardings(minfo, batch))
            self.trace = lambda: analyze_step(
                lambda p, b: model.prefill(p, b), sparams,
                input_specs(cfg, shape, B_loc))
            return
        state = _decode_state(model, B, S)
        tok = torch.empty((B, 1), dtype=torch.int32, device=META)
        self.arg_bytes += (shard_bytes(state, cache_shardings(minfo, state))
                           + shard_bytes(tok, batch_shardings(minfo, tok)))
        self.trace = lambda: analyze_step(
            lambda p, t, c: model.decode_step(p, t, c), sparams,
            torch.empty((B_loc, 1), dtype=torch.int32, device=META),
            _decode_state(model, B_loc, S))


def plan_cell(cfg: ModelConfig, shape: ShapeConfig, minfo: MeshInfo,
              policy: QuantPolicy, *, corrections: bool = True,
              microbatches: int = 1, zero1: bool = False,
              zero3: bool = False) -> Dict:
    """Plan one cell on ``minfo`` (module docstring): the reference's
    result keys from ``compile_s`` on."""
    tp, dp = minfo.tp_size, minfo.dp_size
    S = shape.seq_len
    cell = Cell(cfg, shape, minfo, policy, microbatches=microbatches,
                zero1=zero1, zero3=zero3)
    model, params, B_loc = cell.model, cell.params, cell.B_loc
    arg_bytes, trace = cell.arg_bytes, cell.trace
    notes = [f"trace at the data shard's batch ({B_loc} of "
             f"{shape.global_batch} rows) on meta; FLOPs, bytes and "
             f"temporaries divided evenly over tp = {tp} (the port's "
             f"assumption: no partitioner)"]
    t0 = time.time()

    if corrections:
        with _Loops() as loops:
            base = trace()
    else:
        base = trace()
    t_base = time.time() - t0
    raw_counts = {k: base[k] / tp for k in _COUNTS}
    corrected_counts = dict(raw_counts)
    for kind, trips in (loops.trips.items() if corrections else ()):
        if trips <= BASE_TRIPS:          # the base trace ran every trip
            continue
        with _Loops({kind: BASE_TRIPS + 1}):
            more = trace()
        for k in _COUNTS:
            corrected_counts[k] += (trips - BASE_TRIPS) \
                * (more[k] - base[k]) / tp
        notes.append(f"loop correction: {trips} {kind} a call, one "
                     f"counted by difference ({BASE_TRIPS} and "
                     f"{BASE_TRIPS + 1} real trips), x{trips - BASE_TRIPS}")

    records = plan_collectives(model, params, minfo, shape, policy, B_loc,
                               zero=zero1 or zero3)
    coll = collective_bytes(records)
    notes.append("collectives planned, not traced: (a) dp gradient "
                 "reduction, (b) MoE psum over tp, (c) multi-pod posit "
                 "all-reduce, (d) ROW_PAR outputs all-reduced over tp")
    temp = corrected_counts["temp_bytes_per_device"]
    result = {
        "compile_s": round(t_base, 1),
        "memory": {"peak_bytes_per_device": float(arg_bytes + temp),
                   "arg_bytes_per_device": float(arg_bytes),
                   "temp_bytes_per_device": float(temp)},
        "raw": {"flops": raw_counts["flops"], "bytes": raw_counts["bytes"],
                "coll_bytes": coll["total"]},
        "coll_breakdown": {k: v for k, v in coll.items() if k != "total"},
    }
    corrected = {"flops": corrected_counts["flops"],
                 "bytes": corrected_counts["bytes"],
                 "coll_bytes": coll["total"]}
    mf = model_flops(cfg, shape)
    n_chips = dp * tp
    result["corrected"] = corrected
    result["model_flops_global"] = mf
    result["model_flops_per_chip"] = mf / n_chips
    result["useful_ratio"] = (mf / n_chips) / max(corrected["flops"], 1.0)
    result["terms"] = roofline_terms(
        corrected["flops"], corrected["bytes"], corrected["coll_bytes"],
        corrected_counts["flops_f32"])
    notes.append(f"compute term: {corrected_counts['flops_f32']:.6g} of "
                 f"the {corrected['flops']:.6g} FLOPs on f32 operands, at "
                 f"the f32 peak; the rest at the bf16 dense peak")
    result["notes"] = notes
    return result


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               policy_name: str = "paper", corrections: bool = True,
               microbatches: int = 1, zero1: bool = False,
               zero3: bool = False,
               timings: Optional[dict] = None) -> Dict:
    cfg = get_config(arch)
    shape = ALL_SHAPES[shape_name]
    policy = POLICIES[policy_name]
    if not shape_applies(cfg, shape):
        return {"skipped": True,
                "reason": "long_500k requires sub-quadratic mixing "
                          "(see DESIGN.md shape-cell skips)"}
    minfo = make_mesh_info(multi_pod=multi_pod)
    result = {"arch": arch, "shape": shape_name,
              "mesh": "2x16x16" if multi_pod else "16x16",
              "policy": policy_name}
    result.update(plan_cell(cfg, shape, minfo, policy,
                            corrections=corrections,
                            microbatches=microbatches, zero1=zero1,
                            zero3=zero3))
    if timings is not None:
        timings[(arch, shape_name, multi_pod)] = result["compile_s"]
    return result


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def iter_cells():
    for arch in sorted(CONFIGS):
        for shape_name in ("train_4k", "prefill_32k", "decode_32k",
                           "long_500k"):
            yield arch, shape_name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--policy", default="paper", choices=sorted(POLICIES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--no-corrections", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--zero3", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = list(iter_cells()) if args.all else [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    for arch, shape_name in cells:
        for multi in meshes:
            tag = f"{arch}__{shape_name}__{'multi' if multi else 'single'}__{args.policy}" + (
                f"__mb{args.microbatches}" if args.microbatches > 1 else "") + (
                "__zero1" if args.zero1 else "") + (
                "__zero3" if args.zero3 else "")
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip cached] {tag}", flush=True)
                continue
            print(f"[cell] {tag}", flush=True)
            t0 = time.time()
            try:
                res = lower_cell(
                    arch, shape_name, multi_pod=multi,
                    policy_name=args.policy,
                    # the reference corrects single-pod cells only; an
                    # uncorrected trace of a 32k cell takes hours here
                    corrections=not args.no_corrections,
                    microbatches=args.microbatches, zero1=args.zero1,
                    zero3=args.zero3)
            except Exception:
                res = {"arch": arch, "shape": shape_name,
                       "mesh": "multi" if multi else "single",
                       "error": traceback.format_exc()}
            res["wall_s"] = round(time.time() - t0, 1)
            with open(path, "w") as f:
                json.dump(res, f, indent=2, default=str)
            status = "ERROR" if "error" in res else (
                "SKIP" if res.get("skipped") else "ok")
            print(f"    -> {status} ({res['wall_s']}s)", flush=True)


if __name__ == "__main__":
    main()
