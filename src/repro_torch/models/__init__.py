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
                device=None):
    """The model of ``cfg`` on ``device`` (None: the card)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is none of the reference's "
            f"({', '.join(FAMILIES)})")
    return FAMILIES[cfg.family](cfg, policy, device=device)
