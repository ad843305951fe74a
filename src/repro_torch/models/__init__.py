"""Model factory: ``ModelConfig.family`` → model class, for the
reference's six families: ``dense``, ``moe`` and ``vlm`` (``DecoderLM``),
``encdec`` (``EncDecLM``), ``ssm`` (``XLSTMLM``) and ``hybrid``
(``ZambaLM``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import QuantPolicy

from .encdec import EncDecLM
from .transformer import DecoderLM
from .xlstm_model import XLSTMLM
from .zamba import ZambaLM

FAMILIES = {"dense": DecoderLM, "moe": DecoderLM, "vlm": DecoderLM,
            "encdec": EncDecLM, "ssm": XLSTMLM, "hybrid": ZambaLM}


def build_model(cfg: ModelConfig, policy: QuantPolicy = QuantPolicy(),
                device=None, tp_size: int = 1):
    """The model of ``cfg`` on ``device`` (None: the card), its MoE expert
    stacks padded for a model axis of ``tp_size`` (the other families
    have nothing to pad)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is none of the reference's "
            f"({', '.join(FAMILIES)})")
    cls = FAMILIES[cfg.family]
    if cls is DecoderLM:
        return cls(cfg, policy, device=device, tp_size=tp_size)
    return cls(cfg, policy, device=device)
