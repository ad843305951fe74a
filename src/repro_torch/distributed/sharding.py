"""Fleet dispatch over a mesh of devices — the counterpart of the
fleet-dispatch half of ``repro.distributed.sharding``.

``MeshInfo`` lays a tuple of ``torch.device``s out by named axes.  An entry
may name the same physical device more than once: that is how the port
splits one card (or the CPU) into several data slabs, as the reference
splits the host CPU with ``--xla_force_host_platform_device_count``
(``launch.mesh.split_mesh_info``).

``make_fleet_batch_fn`` runs a row-independent batched window function over
the mesh's data axis from one controller, as ``shard_map`` does: the padded
batch and its int32 real-row mask are cut into ``dp_size`` equal slabs along
the leading dim, each slab runs on its device, and each slab's ``[real,
padded]`` row is reduced through ``collectives.ledger_psum``.

The bit-identity contract (the reference's ``distributed/README.md``): a
sharded dispatch gives the single-device dispatch's outputs bit for bit.  It
holds because every window function is row-independent and every kernel on
the path gives a row the same bits whatever the batch's row count — the
rounded matmul's split over K follows K and N alone
(``kernels.posit_matmul.round_matmul_plan``).

The reference's production-mesh half (``logical_spec``, ``shard_leaf``,
``replicated``) serves the 256/512-chip dry run and lands with it
(ROADMAP.md, queue A item A5b).  ``MeshInfo.pod_axis`` is the training
step's: a mesh with a ``pod`` axis takes its posit-compressed cross-pod
gradient branch.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Sequence, Tuple, Union

import numpy as np
import torch

BatchFn = Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """Devices laid out by named axes (row-major over ``axis_names``), and
    the role each axis plays.  Frozen and hashable, so programs can be
    cached per mesh."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    dp_axes: Tuple[str, ...]        # batch data-parallel axes, e.g. ("data",)
    tp_axis: str = "model"

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} axis sizes")
        if math.prod(self.axis_sizes) != len(self.devices):
            raise ValueError(f"a {self.axis_sizes} mesh needs "
                             f"{math.prod(self.axis_sizes)} devices, got "
                             f"{len(self.devices)}")
        for a in self.dp_axes:
            if a not in self.axis_names:
                raise ValueError(f"data axis {a!r} not in {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def pod_axis(self):
        """``"pod"`` where the mesh has that axis (the training step's
        posit-compressed cross-pod gradients), else None."""
        return "pod" if "pod" in self.axis_names else None

    @property
    def dp_size(self) -> int:
        return math.prod(self.shape[a] for a in self.dp_axes)

    @property
    def tp_size(self) -> int:
        """The model axis's size; 1 for a mesh without one."""
        return self.shape.get(self.tp_axis, 1)

    def axis_size(self, name) -> int:
        if isinstance(name, (tuple, list)):
            return math.prod(self.shape[a] for a in name)
        return self.shape[name]

    @property
    def dp_devices(self) -> Tuple[torch.device, ...]:
        """The device of each data slab, in slab order: the first device
        along every other axis (those axes see the batch replicated, so one
        controller runs each slab once)."""
        grid = np.empty(len(self.devices), dtype=object)
        grid[:] = list(self.devices)
        grid = grid.reshape(self.axis_sizes)
        index = tuple(slice(None) if a in self.dp_axes else 0
                      for a in self.axis_names)
        dp = [a for a in self.axis_names if a in self.dp_axes]
        order = [dp.index(a) for a in self.dp_axes]
        return tuple(np.transpose(grid[index], order).reshape(-1))


def fleet_pad(n: int, n_shards: int) -> int:
    """Smallest multiple of ``n_shards`` ≥ ``n`` — the batch size a sharded
    dispatch pads to so every device gets an equal slab.  Padding rows are
    zeros and, because the window functions are row-independent, never
    affect real rows."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be ≥ 1, got {n_shards}")
    return -(-int(n) // int(n_shards)) * int(n_shards)


@functools.lru_cache(maxsize=None)
def _fleet_batch_fn_cached(fns: Tuple[BatchFn, ...], minfo: MeshInfo):
    from .collectives import ledger_psum

    devices = minfo.dp_devices
    k = len(devices)

    def sharded(arrays: Dict[str, Union[np.ndarray, torch.Tensor]],
                mask: Union[np.ndarray, torch.Tensor]):
        arrays = {name: torch.as_tensor(v) for name, v in arrays.items()}
        mask = torch.as_tensor(mask)
        B = mask.shape[0]
        if B % k:
            raise ValueError(f"batch of {B} rows does not split into {k} "
                             f"equal slabs; pad it with fleet_pad")
        per = B // k
        outs, rows = [], []
        # launch every slab before any copy back, so slabs on different
        # cards overlap
        for i, (fn, dev) in enumerate(zip(fns, devices)):
            lo, hi = i * per, (i + 1) * per
            m = mask[lo:hi].to(dev)
            outs.append(fn({name: v[lo:hi].to(dev)
                            for name, v in arrays.items()}))
            rows.append(torch.stack([m.sum(), (1 - m).sum()]))
        # one host buffer per output; each slab copies into its rows once
        host = {name: torch.empty((B, *t.shape[1:]), dtype=t.dtype)
                for name, t in outs[0].items()}
        for i, out in enumerate(outs):
            for name, t in out.items():
                host[name][i * per:(i + 1) * per].copy_(t)
        return host, ledger_psum(rows)

    return sharded


def make_fleet_batch_fn(fns: Sequence[BatchFn], minfo: MeshInfo):
    """Wrap a row-independent batched window function for dispatch over
    the mesh's data axis.

    ``fns`` holds one batched callable per data slab, the one built for
    that slab's device (``minfo.dp_devices``: a pipeline's callable may
    hold tensors on its device).  The wrapper takes a dict of ``(B,
    channels, n)`` host arrays and a ``(B,)`` int32 real-row mask, ``B`` a
    multiple of ``minfo.dp_size`` (``fleet_pad``); it returns the outputs
    as host tensors of ``B`` rows (each slab's rows copied once) and the
    fleet's ``[real, padded]`` row, the exact int64 sum of the slabs' rows.

    Cached per (callables, mesh): engines sharing one pipeline share the
    wrapper."""
    fns = tuple(fns)
    if len(fns) != minfo.dp_size:
        raise ValueError(f"{len(fns)} callables for {minfo.dp_size} data "
                         f"slabs")
    return _fleet_batch_fn_cached(fns, minfo)
