"""PyTorch + CUDA port of ``repro``: posit arithmetic, the cough and R-peak
window cores, and the streaming engine, for an NVIDIA H100.

The posit kernels of the main path (round, FFT butterfly, rounded matmul)
are hand-written CUDA under ``kernels/csrc``, built at first use.  Nothing
here imports ``jax`` or ``repro``.
"""
