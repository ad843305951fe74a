"""What a process's kernels did: each wrapper's launch count, and the calls
of the stream kernels' plain versions that were given a CUDA tensor.

Every kernel wrapper counts its launches in ``<wrapper>.launches``
(nowhere else).  ``launch_counts`` reads them all and ``reset_launch_counts``
sets them to 0.  ``PlainCalls`` counts, while entered, the calls of a
path's plain versions (``STREAM_PLAIN``, ``SERVE_PLAIN``) given a tensor on
the card: on the card each of them must stay 0, so a kernel that quietly
fell back to its plain version shows.  ``refuse_plain_on_card`` makes them
raise instead, for a process of its own (a spawned pool worker, whose
launch counts are all it reports); nothing in the library calls it.  The ingest worker pool ships each
worker process's launch counts (``repro_torch.ingest.workers``).
"""
from __future__ import annotations

from typing import Dict


def wrappers():
    """The kernel wrappers, each with its ``launches`` counter."""
    from .posit_codec import posit_decode, posit_encode, posit_kv_append
    from .posit_fft import posit_fft_stages
    from .posit_kv_attention import posit_kv_attention
    from .posit_matmul import posit_matmul, posit_matmul_round
    from .posit_round import posit_butterfly, posit_fma_round, posit_round
    return (posit_round, posit_butterfly, posit_fft_stages,
            posit_matmul_round, posit_decode, posit_encode, posit_kv_append,
            posit_kv_attention, posit_fma_round, posit_matmul)


def launch_counts() -> Dict[str, int]:
    return {w.__name__: w.launches for w in wrappers()}


def reset_launch_counts() -> None:
    for w in wrappers():
        w.launches = 0


# (module, function): the plain versions a path must not call on the card
STREAM_PLAIN = (("repro_torch.kernels.posit_round", "posit_round_torch"),
                ("repro_torch.core.arith", "round_to_posit"),
                ("repro_torch.kernels.posit_fft", "posit_fft_stages_torch"),
                ("repro_torch.apps.dsp", "posit_fft_stages_torch"),
                ("repro_torch.kernels.posit_matmul",
                 "posit_matmul_round_torch"))
SERVE_PLAIN = (("repro_torch.kernels.posit_codec", "posit_decode_torch"),
               ("repro_torch.kernels.posit_codec", "posit_encode_torch"),
               ("repro_torch.kernels.posit_codec", "posit_kv_append_torch"),
               ("repro_torch.kernels.posit_kv_attention",
                "posit_kv_attention_torch"))


class PlainCalls:
    """Counts the calls of plain versions (by default the stream kernels'
    and the torch round backend) that are given a CUDA tensor, while
    entered."""

    def __init__(self, sites=STREAM_PLAIN):
        import importlib
        self.sites = [(importlib.import_module(m), n) for m, n in sites]
        self.calls = {f"{m}.{n}": 0 for m, n in sites}
        self._saved = []

    def __enter__(self):
        import torch
        for mod, name in self.sites:
            real = getattr(mod, name)
            key = f"{mod.__name__}.{name}"

            def counted(*a, _real=real, _key=key, **kw):
                if any(isinstance(t, torch.Tensor) and t.is_cuda
                       for t in (*a, *kw.values())):
                    self.calls[_key] += 1
                return _real(*a, **kw)
            self._saved.append((mod, name, real))
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, real in reversed(self._saved):
            setattr(mod, name, real)
        self._saved = []


def refuse_plain_on_card() -> None:
    """From now on in this process, each plain version in ``STREAM_PLAIN``
    raises when it is given a CUDA tensor: a worker that fell back to one
    fails, and shows in the pool's ``failed_workers``, instead of passing on
    its bits."""
    import importlib
    import torch
    for m, n in STREAM_PLAIN:
        mod = importlib.import_module(m)

        def refused(*a, _real=getattr(mod, n), _key=f"{m}.{n}", **kw):
            if any(isinstance(t, torch.Tensor) and t.is_cuda
                   for t in (*a, *kw.values())):
                raise AssertionError(f"{_key} called on a CUDA tensor in a "
                                     f"process that refuses it")
            return _real(*a, **kw)
        setattr(mod, n, refused)
