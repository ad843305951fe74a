"""Carry a parameter tree into the port: nested dicts of numpy arrays (for
instance the JAX package's parameters after ``np.asarray``), with posit
leaves given as any object that has ``bits``, ``fmt`` (with ``n`` and
``es``) and ``scale`` — the shape of the reference's ``PositTensor`` —
become the port's tree of tensors and ``PositTensor`` leaves on one
device.  The counterpart of ``apps/forest.py::forest_from_arrays`` for the
language models; nothing here imports the other package.
``train_state_from_jax`` carries a whole training state (parameters,
AdamW moments and step), so both packages can step from the same state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import PositFormat
from repro_torch.core.quant import PositTensor


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: by its bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree, device):
    """The port's parameter tree on ``device`` for ``tree``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if hasattr(tree, "bits") and hasattr(tree, "fmt"):
        scale = getattr(tree, "scale", None)
        return PositTensor(_tensor(tree.bits, device),
                           PositFormat(tree.fmt.n, tree.fmt.es),
                           None if scale is None else _tensor(scale, device))
    return _tensor(tree, device)


def train_state_from_jax(state, device):
    """The port's training state on ``device`` for the reference's
    ``{"params", "opt": {"m", "v", "step"}}`` (as numpy, or anything
    ``np.asarray`` takes): f32 trees and an int32 0-d step."""
    opt = state["opt"]
    return {"params": params_from_jax(state["params"], device),
            "opt": {"m": params_from_jax(opt["m"], device),
                    "v": params_from_jax(opt["v"], device),
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int32, device=device)}}
