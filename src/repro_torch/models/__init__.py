"""Model factory: ``ModelConfig.family`` → model class.  The port has the
``dense`` and ``moe`` families; ``vlm``, ``encdec``, ``ssm`` and ``hybrid``
wait for later slices (ROADMAP.md, queue A item A3)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import QuantPolicy

from .transformer import DecoderLM

FAMILIES = {"dense": DecoderLM, "moe": DecoderLM}


def build_model(cfg: ModelConfig, policy: QuantPolicy = QuantPolicy(),
                device=None):
    """The model of ``cfg`` on ``device`` (None: the card)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP.md, "
            f"queue A item A3)")
    return FAMILIES[cfg.family](cfg, policy, device=device)
