"""The main path's posit kernels: CUDA for the card, a plain torch version
beside each for CPU tensors and as the kernel's oracle."""
