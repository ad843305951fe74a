"""nJ/token accounting for the serving engine (the port's copy of
``repro.serve.accounting``).

Mirrors ``stream.accounting``'s ledger pattern for the token traffic class:
arithmetic op counts are derived from the model config (the semantic
rounded-op sequence, invariant under backend fusion), converted to nJ via
the paper's calibrated cycles-per-op overhead, and the KV cache's HBM
traffic is billed separately through the Mem Stream FIFO corner at the
STORAGE width — the term the posit cache actually shrinks.

Prefill and decode are split: prefill is compute-bound (one pass over the
prompt, attention cost quadratic in its length), decode is memory-bound
(per token, the whole cache streams past the datapath once).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.energy.model import OpCounts, TokenOpCounts
from repro_torch.stream.accounting import energy_config_for_format


# ---------------------------------------------------------------------------
# Per-token op counts from the model config
# ---------------------------------------------------------------------------

def _linear_token_ops(cfg) -> OpCounts:
    """Context-independent ops of one token position: projections, FFN/MoE,
    norms/rope, unembed.  One MAC = 1 add + 1 mul."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    mac = 0
    # qkv + output projections
    mac += L * (d * hd * (H + 2 * KV) + H * hd * d)
    # FFN (swiglu: gate/up/down; gelu: up/down) or routed MoE experts
    n_mat = 3 if cfg.ffn_kind == "swiglu" else 2
    if cfg.n_experts:
        mac += L * (d * cfg.n_experts            # router scores
                    + cfg.top_k * n_mat * d * cfg.d_ff)
    else:
        mac += L * n_mat * d * cfg.d_ff
    # unembed against the padded vocab
    mac += d * cfg.padded_vocab
    ops = OpCounts(add=mac, mul=mac)
    # norms (2–4 per block + final): ~2 passes of mul+add over d, one
    # rsqrt; rope: 4 mul + 2 add per rotated pair
    n_norms = L * (4 if cfg.attn_softcap > 0 else 2) + 1
    ops.add += n_norms * d
    ops.mul += n_norms * 2 * d
    ops.sqrt += n_norms
    ops.mul += L * (H + KV) * hd * 2
    ops.add += L * (H + KV) * hd
    # activation nonlinearity: table-based, billed as conversions
    act_width = cfg.top_k * cfg.d_ff if cfg.n_experts else cfg.d_ff
    ops.conv += L * act_width
    return ops


def _attention_token_ops(cfg, ctx: float) -> OpCounts:
    """Context-dependent ops of one token attending over ``ctx`` positions:
    qk and pv MACs, plus the softmax (exp via table → conv, sum, scale)."""
    hd, H, L = cfg.resolved_head_dim, cfg.n_heads, cfg.n_layers
    qk_pv = int(2 * L * H * ctx * hd)      # two MAC planes over the context
    ops = OpCounts(add=qk_pv, mul=qk_pv)
    softmax = int(L * H * ctx)
    ops.conv += softmax                     # exp table
    ops.add += softmax                      # denominator sum
    ops.mul += softmax                      # normalize by 1/denom
    ops.div += L * H                        # the reciprocal itself
    return ops


def decode_token_ops(cfg, ctx: int) -> OpCounts:
    """Ops for ONE decode token at context length ``ctx``."""
    ops = _linear_token_ops(cfg)
    a = _attention_token_ops(cfg, ctx)
    ops.add += a.add
    ops.mul += a.mul
    ops.div += a.div
    ops.conv += a.conv
    return ops


def prefill_ops(cfg, prompt_len: int) -> OpCounts:
    """Ops for a WHOLE prompt prefill: linear terms scale with the length,
    causal attention sees the triangular average context (P+1)/2."""
    lin = _linear_token_ops(cfg)
    ops = OpCounts(add=lin.add * prompt_len, mul=lin.mul * prompt_len,
                   div=lin.div * prompt_len, sqrt=lin.sqrt * prompt_len,
                   conv=lin.conv * prompt_len)
    a = _attention_token_ops(cfg, (prompt_len + 1) / 2.0)
    ops.add += a.add * prompt_len
    ops.mul += a.mul * prompt_len
    ops.div += a.div * prompt_len
    ops.conv += a.conv * prompt_len
    return ops


def kv_traffic_bytes(cfg, ctx: int, kv_bits: int):
    """(read, write) cache bytes for one decode token: the whole context's
    K and V stream in once, the new position streams out — both at the
    storage width (the posit cache's halved roofline term)."""
    elems = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.resolved_head_dim
    return ctx * elems * kv_bits / 8.0, elems * kv_bits / 8.0


def token_energy_nj(cfg, ctx: int, policy) -> float:
    """Model nJ for ONE decode token of a ``ServePolicy`` lane: datapath
    ops on the lane's compute corner (width-aware for posits, like
    ``stream.accounting.window_energy_nj``) + Mem-Stream KV traffic at the
    lane's storage width."""
    fmt = policy.weights or "bfloat16"
    read_b, write_b = kv_traffic_bytes(cfg, ctx, policy.kv_bits)
    tok = TokenOpCounts(decode_token_ops(cfg, ctx), read_b, write_b)
    return tok.energy_nj(energy_config_for_format(fmt), fmt=fmt)


def prefill_energy_nj(cfg, prompt_len: int, policy) -> float:
    """Model nJ for one prompt's prefill (cache WRITE traffic only — the
    fresh bf16 k/v feed the prefill attention directly)."""
    fmt = policy.weights or "bfloat16"
    _, write_unit = kv_traffic_bytes(cfg, 0, policy.kv_bits)
    tok = TokenOpCounts(prefill_ops(cfg, prompt_len),
                        0.0, write_unit * prompt_len)
    return tok.energy_nj(energy_config_for_format(fmt), fmt=fmt)


# ---------------------------------------------------------------------------
# Ledger
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LaneStats:
    """Running totals for one precision lane."""

    requests: int = 0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    decode_steps: int = 0          # batched decode launches
    padded_rows: int = 0           # inactive slots carried through a step
    prefill_s: float = 0.0
    decode_s: float = 0.0
    energy_nj: float = 0.0
    kv_read_bytes: float = 0.0


class TokenLedger:
    """Per-lane µs/token + nJ/token, the serving analogue of EnergyLedger."""

    def __init__(self):
        self.stats: Dict[str, LaneStats] = {}

    def _lane(self, lane: str) -> LaneStats:
        return self.stats.setdefault(lane, LaneStats())

    def record_prefill(self, lane: str, n_tokens: int, wall_s: float,
                       energy_nj: float) -> None:
        g = self._lane(lane)
        g.requests += 1
        g.prefill_tokens += n_tokens
        g.prefill_s += wall_s
        g.energy_nj += energy_nj

    def record_decode(self, lane: str, n_tokens: int, n_padded: int,
                      wall_s: float, energy_nj: float,
                      kv_read_bytes: float) -> None:
        g = self._lane(lane)
        g.decode_tokens += n_tokens
        g.decode_steps += 1
        g.padded_rows += n_padded
        g.decode_s += wall_s
        g.energy_nj += energy_nj
        g.kv_read_bytes += kv_read_bytes

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{lane: metrics} plus a "fleet" rollup row."""
        out: Dict[str, Dict[str, float]] = {}
        tot = LaneStats()
        for lane, g in sorted(self.stats.items()):
            out[lane] = self._row(g)
            for f in dataclasses.fields(LaneStats):
                setattr(tot, f.name,
                        getattr(tot, f.name) + getattr(g, f.name))
        out["fleet"] = self._row(tot)
        return out

    @staticmethod
    def _row(g: LaneStats) -> Dict[str, float]:
        return {
            "requests": g.requests,
            "prefill_tokens": g.prefill_tokens,
            "decode_tokens": g.decode_tokens,
            "decode_steps": g.decode_steps,
            "padded_rows": g.padded_rows,
            "us_per_token": (1e6 * g.decode_s / g.decode_tokens
                             if g.decode_tokens else 0.0),
            "prefill_us_per_token": (1e6 * g.prefill_s / g.prefill_tokens
                                     if g.prefill_tokens else 0.0),
            "nj_per_token": (g.energy_nj / g.decode_tokens
                             if g.decode_tokens else 0.0),
            "total_nj": g.energy_nj,
            "kv_read_bytes": g.kv_read_bytes,
        }
