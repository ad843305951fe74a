"""Model factory: ``ModelConfig.family`` → model class.  The port has the
``dense``, ``moe``, ``vlm`` and ``encdec`` families; ``ssm`` and ``hybrid``
wait for later slices (ROADMAP.md, queue A item A3)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import QuantPolicy

from .encdec import EncDecLM
from .transformer import DecoderLM

FAMILIES = {"dense": DecoderLM, "moe": DecoderLM, "vlm": DecoderLM,
            "encdec": EncDecLM}


def build_model(cfg: ModelConfig, policy: QuantPolicy = QuantPolicy(),
                device=None):
    """The model of ``cfg`` on ``device`` (None: the card)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP.md, "
            f"queue A item A3)")
    return FAMILIES[cfg.family](cfg, policy, device=device)
