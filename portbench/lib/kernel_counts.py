"""Operations and bytes of the program's kernel calls in a traced window.

While entered (and until ``stop``), each kernel wrapper that a path calls
through a module attribute is wrapped to add its call's counts
(``portbench.counts``, from the arguments' shapes) to ``totals[name]``;
``KERNELS`` names the device kernels of each wrapper, as the trace shows
them.  The wrappers are put back on exit.  Nothing here changes what a
call computes.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

import torch

from portbench import counts

# wrapper → the device kernels one call launches (a name is matched as a
# substring of the trace's kernel names)
KERNELS = {
    "posit_fft_stages": ("posit_fft_stages_kernel",),
    "posit_matmul_round": ("posit_matmul_round_kernel",
                           "posit_matmul_round_combine_kernel"),
    "posit_decode": ("posit_decode_kernel",),
    "posit_kv_attention": ("posit_kv_attention_kernel",
                           "posit_kv_combine_kernel"),
}


def _fft(z, twiddles, s0, s1, fmt, *a, **kw):
    return counts.posit_fft_stages(z.numel(), twiddles.shape[-1] + 1,
                                   s1 - s0)


def _matmul_round(a, b, fmt, *args, **kw):
    return counts.posit_matmul_round(a.shape[0], a.shape[1], b.shape[1])


def _decode(bits, fmt, out_dtype=torch.float32, *a, **kw):
    return counts.posit_decode(bits.shape, fmt.n,
                               torch.empty((), dtype=out_dtype)
                               .element_size())


# (module, attribute, wrapper name, count function of the call's arguments)
SITES = (
    ("repro_torch.apps.dsp", "posit_fft_stages", "posit_fft_stages", _fft),
    ("repro_torch.core.arith", "posit_matmul_round", "posit_matmul_round",
     _matmul_round),
    ("repro_torch.core.quant", "posit_decode", "posit_decode", _decode),
)


class KernelCounts:
    def __init__(self):
        self.totals: Dict[str, Dict[str, float]] = {
            k: {"calls": 0, "flops": 0.0, "bytes": 0.0} for k in KERNELS}
        self.on = False
        self._saved: List = []
        self._kv_lengths: List = []

    def _add(self, name: str, c: Dict) -> None:
        t = self.totals[name]
        t["calls"] += 1
        t["flops"] += c["flops"]
        t["bytes"] += c["bytes"]

    def __enter__(self):
        for mod_name, attr, name, fn in SITES:
            mod = importlib.import_module(mod_name)
            real = getattr(mod, attr)

            def counted(*a, _real=real, _name=name, _fn=fn, **kw):
                if self.on and isinstance(a[0], torch.Tensor) \
                        and a[0].is_cuda:
                    self._add(_name, _fn(*a, **kw))
                return _real(*a, **kw)
            self._saved.append((mod, attr, real))
            setattr(mod, attr, counted)
        attn = importlib.import_module("repro_torch.models.attention")
        real_kv = attn.posit_kv_attention

        def kv(q, k_bits, v_bits, length, fmt, *a, **kw):
            if self.on and q.is_cuda:
                # the lengths are read after the window: no sync inside it
                B, KV, G, D = q.shape
                self._kv_lengths.append((B, KV, G, D, fmt.n, length))
            return real_kv(q, k_bits, v_bits, length, fmt, *a, **kw)
        self._saved.append((attn, "posit_kv_attention", real_kv))
        attn.posit_kv_attention = kv
        self.on = True
        return self

    def stop(self) -> None:
        self.on = False

    def __exit__(self, *exc):
        self.on = False
        for mod, attr, real in reversed(self._saved):
            setattr(mod, attr, real)
        self._saved = []
        for B, KV, G, D, nbits, length in self._kv_lengths:
            filled = int(torch.as_tensor(length).to(torch.int64).sum()) \
                if torch.is_tensor(length) and length.dim() else \
                int(length) * B
            self._add("posit_kv_attention",
                      counts.posit_kv_attention(B, KV, G, D, nbits, filled))
        self._kv_lengths = []
        return False
