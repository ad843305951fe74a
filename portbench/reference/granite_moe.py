"""granite-moe-3b-a800m's forward pass in plain float32 torch: the
reference that the served logits are held against.

From the configuration's sizes and the benchmark's raw weights (the tree
``make_params`` draws): token embedding, then per layer RMSNorm (gain
1 + γ), grouped-query attention with rotary positions (the port's
half-split convention) under a causal mask, the residual add, RMSNorm,
the router (softmax over the experts, top-k, the kept gates renormalised)
and every routed expert's SwiGLU product, dropless; a final RMSNorm and
the tied unembedding.  The configuration's scalar multipliers apply
(embedding, attention, residual, logits), as the published model defines
them.  No kernel, cache or batching; TF32 off.

``weights`` and ``kv`` round the weights and the attention's K/V onto a
posit format first: the controls, a lower precision in the program's
place.  Nothing of the program is imported.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from portbench.reference.fleet.posit import get_format, round_posit_math

EPS = 1e-6


def sizes(cfg: Dict) -> Dict[str, int]:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"d": d, "L": cfg["num_hidden_layers"], "H": H,
            "KV": cfg["num_key_value_heads"], "hd": d // H,
            "E": cfg["num_local_experts"], "k": cfg["num_experts_per_tok"],
            "ff": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "Vp": (cfg["vocab_size"] + 127) // 128 * 128}


def make_params(cfg: Dict, seed: int, device) -> Dict:
    """The weights, f32 on ``device``, drawn from ``seed`` by a generator on
    the device, one call a stacked leaf: normal at 1/sqrt(fan in) for the
    projections and experts, 0.02 for the embedding and the router, and
    N(0, 0.1) for the norm gains γ (the gain is 1 + γ).  The tree is the
    port's serving layout (layer-stacked leaves)."""
    s = sizes(cfg)
    d, L, H, KV, hd = s["d"], s["L"], s["H"], s["KV"], s["hd"]
    E, ff, Vp = s["E"], s["ff"], s["Vp"]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))

    def draw(shape, std):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.normal_(0.0, std, generator=gen)

    return {
        "embed": {"table": draw((Vp, d), 0.02)},
        "layers": {
            "ln1": draw((L, d), 0.1),
            "ln2": draw((L, d), 0.1),
            "attn": {"wq": {"w": draw((L, d, H * hd), d ** -0.5)},
                     "wk": {"w": draw((L, d, KV * hd), d ** -0.5)},
                     "wv": {"w": draw((L, d, KV * hd), d ** -0.5)},
                     "wo": {"w": draw((L, H * hd, d), (H * hd) ** -0.5)}},
            "moe": {"router": draw((L, d, E), 0.02),
                    "w_gate": draw((L, E, d, ff), d ** -0.5),
                    "w_up": draw((L, E, d, ff), d ** -0.5),
                    "w_down": draw((L, E, ff, d), ff ** -0.5)},
        },
        "final_ln": draw((d,), 0.1),
    }


def _norm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + EPS) \
        * (1.0 + g)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) at positions 0 .. S-1: the first and second halves
    of each head rotate together."""
    S, _, hd = x.shape
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


class Reference:
    """The forward pass over one sequence at a time, all positions'
    logits.  ``weights``/``kv`` (posit format names) round the weights and
    the attention's K/V, for a control."""

    def __init__(self, cfg: Dict, params: Dict, weights: Optional[str] = None,
                 kv: Optional[str] = None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.s = sizes(cfg)
        self.theta = float(cfg["rope_theta"])
        self.emb_mult = float(cfg["embedding_multiplier"])
        self.att_mult = float(cfg["attention_multiplier"])
        self.res_mult = float(cfg["residual_multiplier"])
        self.logits_scaling = float(cfg["logits_scaling"])
        self.p = params
        self.wfmt = get_format(weights) if weights else None
        self.kvfmt = get_format(kv) if kv else None

    def _w(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.wfmt is None else round_posit_math(t, self.wfmt)

    def _kv(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.kvfmt is None else round_posit_math(t, self.kvfmt)

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (S,) int64 → (S, vocab) f32 logits."""
        s, p = self.s, self.p
        H, KV, hd, E, k = s["H"], s["KV"], s["hd"], s["E"], s["k"]
        S = tokens.shape[0]
        lay = p["layers"]
        table = self._w(p["embed"]["table"])
        x = table[tokens] * self.emb_mult
        mask = torch.ones((S, S), dtype=torch.bool,
                          device=x.device).tril()
        for i in range(s["L"]):
            a = lay["attn"]
            h = _norm(x, lay["ln1"][i])
            q = _rope((h @ self._w(a["wq"]["w"][i])).view(S, H, hd),
                      self.theta)
            kk = self._kv(_rope((h @ self._w(a["wk"]["w"][i]))
                                .view(S, KV, hd), self.theta))
            vv = self._kv((h @ self._w(a["wv"]["w"][i])).view(S, KV, hd))
            kk = kk.repeat_interleave(H // KV, dim=1)
            vv = vv.repeat_interleave(H // KV, dim=1)
            att = torch.einsum("qhd,khd->hqk", q, kk) * self.att_mult
            att = torch.softmax(att.masked_fill(~mask, -math.inf), dim=-1)
            o = torch.einsum("hqk,khd->qhd", att, vv).reshape(S, H * hd)
            x = x + self.res_mult * (o @ self._w(a["wo"]["w"][i]))
            h = _norm(x, lay["ln2"][i])
            m = lay["moe"]
            gates = torch.softmax(h @ self._w(m["router"][i]), dim=-1)
            gv, ge = torch.topk(gates, k, dim=-1)
            gv = gv / gv.sum(-1, keepdim=True)
            out = torch.zeros_like(x)
            for e in range(E):
                tok, slot = torch.nonzero(ge == e, as_tuple=True)
                if not tok.numel():
                    continue
                he = h[tok]
                y = torch.nn.functional.silu(he @ self._w(m["w_gate"][i, e])) \
                    * (he @ self._w(m["w_up"][i, e]))
                y = (y @ self._w(m["w_down"][i, e])) * gv[tok, slot][:, None]
                out.index_add_(0, tok, y)
            x = x + self.res_mult * out
        x = _norm(x, p["final_ln"])
        return (x @ table[:s["V"]].T) / self.logits_scaling


def served_gaps(ref: Reference, prompt, served) -> torch.Tensor:
    """For each served token, how far its reference logit lies below the
    reference's best at that position (teacher-forced over prompt +
    served tokens)."""
    dev = ref.p["final_ln"].device
    seq = torch.as_tensor(list(prompt) + list(served[:-1]), dtype=torch.int64,
                          device=dev)
    lg = ref.logits(seq)[len(prompt) - 1:]
    tok = torch.as_tensor(list(served), dtype=torch.int64, device=dev)
    return lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0]


def control_gaps(ref: Reference, low: Reference, prompt, served
                 ) -> torch.Tensor:
    """At each position of the same prompt and served tokens, the gap of
    the token that the lower precision ``low`` puts first."""
    dev = ref.p["final_ln"].device
    seq = torch.as_tensor(list(prompt) + list(served[:-1]), dtype=torch.int64,
                          device=dev)
    lg = ref.logits(seq)[len(prompt) - 1:]
    pick = low.logits(seq)[len(prompt) - 1:].argmax(-1)
    return lg.max(-1).values - lg.gather(1, pick[:, None])[:, 0]
