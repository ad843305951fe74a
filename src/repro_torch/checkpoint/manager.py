"""Fault-tolerant checkpointing — the counterpart of
``repro.checkpoint.manager``: atomic (a ``.tmp-{step}`` directory, then
``os.replace``), async, retention of the newest ``keep``, and a restore that
walks back past a corrupt newest step.  A posit-quantized checkpoint
(``quantize_fmt``) cuts the footprint by the storage ratio — the paper's
memory-image argument applied to training state.

The files are the reference's: ``step-%09d/state.npz`` with one array
``leaf{i}`` per leaf, and ``meta.json`` with the same fields.  Leaves are
numbered in JAX's pytree order (a dict's keys sorted; lists and tuples in
order; ``None`` holds no leaf), so either package restores the other's
checkpoint.

A float32 leaf of two or more dims is encoded to posit bits on its own
device (on the card, the ``posit_codec.cu`` encode kernel) and decoded on
restore on the device of ``state_like``'s leaf, then cast to that leaf's
dtype.  An async save encodes every leaf and copies it to the host on the
caller's thread before ``save`` returns — a tensor may be changed in place
right after — and leaves only the file writes to the thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.formats import PositFormat, get_format
from repro_torch.kernels.ops import decode as posit_decode
from repro_torch.kernels.ops import encode as posit_encode


def flatten_state(state: Any) -> Tuple[List[Any], str]:
    """(leaves in JAX's pytree order, a description of the structure)."""
    leaves: List[Any] = []

    def walk(x):
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {walk(x[k])}"
                                   for k in sorted(x)) + "}"
        if isinstance(x, (list, tuple)):
            inner = ", ".join(walk(v) for v in x)
            return f"[{inner}]" if isinstance(x, list) else f"({inner})"
        if x is None:
            return "None"
        leaves.append(x)
        return "*"
    return leaves, walk(state)


def unflatten_state(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with ``leaves`` (in JAX's pytree order, as
    ``flatten_state`` gives them) in its places."""
    it = iter(leaves)

    def build(x):
        if isinstance(x, dict):
            got = {k: build(x[k]) for k in sorted(x)}
            return {k: got[k] for k in x}
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        if x is None:
            return None
        return next(it)
    return build(like)


def _host_copy(leaf) -> np.ndarray:
    """A host array of a leaf that owns its memory."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:      # numpy has no bfloat16
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 quantize_fmt: Optional[str] = None, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.fmt: Optional[PositFormat] = (
            get_format(quantize_fmt) if quantize_fmt else None)
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def _quantized(self, leaf) -> bool:
        return (self.fmt is not None and getattr(leaf, "ndim", 0) >= 2
                and (leaf.dtype == torch.float32
                     if isinstance(leaf, torch.Tensor)
                     else np.asarray(leaf).dtype == np.float32))

    # -- save -------------------------------------------------------------
    def save(self, step: int, state: Any, block: bool = False) -> None:
        self.wait()  # serialize with any in-flight async save (same tmp dir)
        if os.path.exists(os.path.join(self.dir, f"step-{step:09d}")):
            return  # idempotent: this step is already durable
        leaves, treedef = flatten_state(state)
        meta = {"step": step, "treedef": treedef, "n_leaves": len(leaves),
                "quantized": self.fmt.name if self.fmt else None}
        payload = {}
        # on the caller's thread: every leaf encoded (on its device) and
        # copied to the host, so later in-place changes cannot reach the file
        for i, leaf in enumerate(leaves):
            if self._quantized(leaf):
                payload[f"leaf{i}"] = _host_copy(
                    posit_encode(torch.as_tensor(leaf), self.fmt))
                meta[f"leaf{i}_posit"] = True
            else:
                payload[f"leaf{i}"] = _host_copy(leaf)

        def _write():
            tmp = os.path.join(self.dir, f".tmp-{step}")
            final = os.path.join(self.dir, f"step-{step:09d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "state.npz"), **payload)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if not os.path.exists(final):
                os.replace(tmp, final)
            self._gc()

        if self.async_save and not block:
            def _run():
                try:
                    _write()
                except BaseException as e:  # noqa: BLE001 — see wait()
                    self._error = e
            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        """Join an in-flight async save; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:09d}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step-") and os.path.exists(
                    os.path.join(self.dir, d, "meta.json")):
                out.append(int(d.split("-")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Any, step: Optional[int] = None
                ) -> Tuple[Any, int]:
        """Restore into the structure of ``state_like``; returns (state,
        step).  A tensor leaf comes back on ``state_like``'s leaf device in
        its dtype, a numpy leaf as a numpy array.  Walks back through the
        retained checkpoints if the newest is corrupt."""
        steps = self.all_steps()
        if step is not None:
            steps = [s for s in steps if s == step]
        for s in reversed(steps):
            try:
                return self._load(state_like, s), s
            except Exception:  # noqa: BLE001 — a torn step: try the previous
                continue
        raise FileNotFoundError(f"no restorable checkpoint in {self.dir}")

    def _load(self, state_like: Any, step: int) -> Any:
        d = os.path.join(self.dir, f"step-{step:09d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        fmt = get_format(meta["quantized"]) if meta["quantized"] else None
        leaves_like, _ = flatten_state(state_like)
        if meta["n_leaves"] != len(leaves_like):
            raise ValueError("structure mismatch")
        leaves = []
        with np.load(os.path.join(d, "state.npz")) as data:
            for i, like in enumerate(leaves_like):
                a = torch.from_numpy(data[f"leaf{i}"])
                is_tensor = isinstance(like, torch.Tensor)
                dev = like.device if is_tensor else torch.device("cpu")
                if meta.get(f"leaf{i}_posit"):
                    a = posit_decode(a.to(dev), fmt, torch.float32)
                if is_tensor:
                    leaves.append(a.to(dev, like.dtype))
                else:
                    dtype = np.asarray(like).dtype
                    leaves.append(a.cpu().numpy().astype(dtype, copy=False))
        return unflatten_state(state_like, leaves)
