"""Config dataclasses: architectures and input-shape cells."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 → d_model // n_heads

    # attention features
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen2.5
    attn_softcap: float = 0.0        # gemma2
    final_softcap: float = 0.0       # gemma2
    local_window: int = 0            # gemma2 alternating local/global
    rope_theta: float = 10_000.0

    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25

    # ssm / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    shared_attn_every: int = 0       # zamba2: shared block cadence

    # encoder-decoder
    enc_layers: int = 0

    # modality frontend (stub): precomputed patch/frame embeddings
    frontend: str = "none"           # none | vision_stub | audio_stub
    frontend_len: int = 0            # patches / frames prepended or encoded

    # ffn
    ffn_kind: str = "swiglu"         # swiglu | gelu

    # numerics / memory
    remat: bool = True
    scan_layers: bool = True

    # which shape cells apply (assignment rules)
    supports_long_context: bool = False

    # -- derived -------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to /128 for MXU alignment and 16-way sharding."""
        return _round_up(self.vocab, 128)

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks), for roofline."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.padded_vocab * d
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.family in ("ssm",):
            attn = 0
        ff = 3 * d * self.d_ff if self.n_experts == 0 else 0
        moe = self.n_experts * 3 * d * self.d_ff if self.n_experts else 0
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            d_in = self.ssm_expand * d
            ssm = d * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_head_dim) + d_in * d
        per_layer = attn + ff + moe + ssm
        layers = self.n_layers + self.enc_layers
        return emb * 2 + layers * per_layer

    def n_active_params(self) -> int:
        if not self.n_experts:
            return self.n_params()
        dense = self.n_params() - self.n_layers * self.n_experts * 3 * self.d_model * self.d_ff
        return dense + self.n_layers * self.top_k * 3 * self.d_model * self.d_ff


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = {s.name: s for s in [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]}


def shape_applies(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Assignment rules: long_500k only for sub-quadratic sequence mixers."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True
