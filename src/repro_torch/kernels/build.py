"""Build and load the CUDA kernels: ``nvcc`` into one shared library per
source with a plain C interface, loaded through ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/kernels/lib<name>-<digest>.so``
under the repository root, built at first use from the sources in the
checkout; the digest covers the sources and the flags, so an edited kernel
is rebuilt and a stale library is never loaded.  Nothing here runs at
import: a CPU tensor never reaches this module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNEL_SOURCES = ("posit_round", "posit_matmul", "posit_codec",
                  "posit_kv_attention", "posit_fft", "posit_kmeans")
HEADERS = ("posit_math.cuh", "posit_decode.cuh")
# -fmad=false: the rounding chain rounds each product on its own; a
# contracted a*b+c would round once and change the bits.  -Xptxas -v: each
# kernel's registers, shared memory and spills, kept in ``BUILD_LOGS``.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
# the compiler's output of each source built by this process
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (f"{name}.cu", *HEADERS):
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    errors = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, path)       # atomic: never a half-written .so
            BUILD_LOGS[name] = out
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of card ``index``, which the launch plans read."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count
