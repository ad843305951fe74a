"""Path-based layout rules for parameter, cache and batch trees on the
production meshes — the counterpart of ``repro.distributed.rules``.

Rules are matched on leaf path names (the reference's naming conventions
are the contract).  Dims that don't divide the mesh axis degrade to
replication.  The port has no partitioner: the rules give each leaf a
``NamedSharding`` whose ``shard_shape`` is one device's piece, from which
the dry run (``launch.dryrun``) sums the argument bytes a device holds and
plans the collectives.

The trees are the port's: nested dicts and lists, the models' cache
dataclasses (``KVCache``, ``SSMCache``, ``MLSTMCache``, ``SLSTMCache``),
tuples (the encdec cross K/V), and leaves that are tensors (any device,
``meta`` included) or ``PositTensor``s.  A ``PositTensor`` takes its bits'
layout; a scaled one is refused, as the reference asserts.  A rule's output
mirrors its input tree with a ``NamedSharding`` at every leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

from repro_torch.core.quant import PositTensor

from .sharding import MeshInfo, NamedSharding, PartitionSpec as P, dp_spec

# column-parallel (shard output features = last dim)
COL_PAR = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "w_z", "w_x",
           "w_h", "w_i", "w_f"}
# row-parallel (shard input features = dim -2 of the weight)
ROW_PAR = {"wo", "w_down", "out_proj", "w_out"}


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` at every leaf of a port tree (``path``: the keys,
    indices and field names from the root), in a tree of the same
    structure, visited in JAX's leaf order.  A ``PositTensor`` and a
    ``NamedSharding`` are one leaf; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):     # JAX's order: the keys sorted
        return {k: tree_map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [tree_map_with_path(fn, v, path + (i,))
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    if dataclasses.is_dataclass(tree) and \
            not isinstance(tree, (PositTensor, NamedSharding)):
        return type(tree)(**{
            f.name: tree_map_with_path(fn, getattr(tree, f.name),
                                       path + (f.name,))
            for f in dataclasses.fields(tree)})
    return fn(path, tree)


def tree_leaves(tree) -> List[Any]:
    """The leaves of a port tree, in JAX's order."""
    out = []
    tree_map_with_path(lambda _, x: out.append(x), tree)
    return out


def _path_names(path) -> List[str]:
    return [str(e) for e in path]


def _bits_shape(leaf, what: str):
    if isinstance(leaf, PositTensor):
        # a scale-less PositTensor is its bits; a scaled one has a second
        # leaf the reference's dry-run trees never carry
        if leaf.scale is not None:
            raise ValueError(f"scaled PositTensor at {what}")
        return tuple(leaf.bits.shape)
    return tuple(leaf.shape)


def _leaf_spec(names: List[str], shape: Sequence[int], minfo: MeshInfo) -> P:
    tp, tpax = minfo.tp_size, minfo.tp_axis
    nd = len(shape)

    def at(dim: int) -> P:
        if dim < 0:
            dim += nd
        if dim < 0 or dim >= nd or shape[dim] % tp != 0:
            return P()
        spec = [None] * nd
        spec[dim] = tpax
        return P(*spec)

    leaf = names[-1] if names else ""
    base = leaf if leaf not in ("w", "b") else (names[-2] if len(names) >= 2
                                                  else leaf)

    if base == "table":
        return at(nd - 2)  # (vocab, d) [padded /128 → divisible]
    if "moe" in names and base in ("w_gate", "w_up", "w_down"):
        return at(nd - 3)  # experts dim (padded to tp multiple)
    if base in ROW_PAR and leaf == "w":
        return at(nd - 2)
    if base in COL_PAR:
        return at(nd - 1)  # w and its bias both shard the feature dim
    return P()


def params_shardings(minfo: MeshInfo, params_like) -> Any:
    """A ``NamedSharding`` tree matching ``params_like``; a
    ``PositTensor`` takes its bits' sharding."""
    def visit(path, leaf):
        names = _path_names(path)
        return NamedSharding(minfo, _leaf_spec(
            names, _bits_shape(leaf, "/".join(names)), minfo))

    return tree_map_with_path(visit, params_like)


def _first_fit_cache_spec(shape, minfo: MeshInfo) -> P:
    """Caches: dp on the first divisible dim (batch; falls back to the
    sequence dim for batch=1 long-context cells); tp on the LAST divisible
    dim (head_dim / state features), never on the sequence dim, where a
    decode step writes one position."""
    dp, tp = minfo.dp_size, minfo.tp_size
    nd = len(shape)
    spec: List[Any] = [None] * nd
    dp_dim = None
    for d in range(nd):
        if shape[d] % dp == 0 and shape[d] > 1:
            spec[d] = dp_spec(minfo)
            dp_dim = d
            break
    for d in range(nd - 1, -1, -1):
        if d != dp_dim and shape[d] % tp == 0 and shape[d] > 1:
            spec[d] = minfo.tp_axis
            break
    return P(*spec)


def cache_shardings(minfo: MeshInfo, cache_like) -> Any:
    def visit(path, leaf):
        shape = _bits_shape(leaf, "a dry-run cache tree")
        if len(shape) == 0:
            return NamedSharding(minfo, P())
        return NamedSharding(minfo, _first_fit_cache_spec(shape, minfo))

    return tree_map_with_path(visit, cache_like)


def batch_shardings(minfo: MeshInfo, batch_like) -> Any:
    dp = minfo.dp_size

    def visit(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) >= 1 and shape[0] % dp == 0 and shape[0] > 1:
            return NamedSharding(minfo, P(*([dp_spec(minfo)]
                                            + [None] * (len(shape) - 1))))
        return NamedSharding(minfo, P())

    return tree_map_with_path(visit, batch_like)


def zero1_shardings(minfo: MeshInfo, params_like) -> Any:
    """Optimizer-state shardings: the params sharding plus the data axes
    on the first still-replicated divisible dim (ZeRO-1), which cuts m/v
    memory by dp×."""
    dp = minfo.dp_size

    def visit(path, leaf):
        names = _path_names(path)
        shape = _bits_shape(leaf, "/".join(names))
        base = _leaf_spec(names, shape, minfo)
        spec = list(base) + [None] * (len(shape) - len(base))
        for d in range(len(shape)):
            if spec[d] is None and shape[d] % dp == 0 and shape[d] > 1:
                spec[d] = dp_spec(minfo)
                return NamedSharding(minfo, P(*spec))
        return NamedSharding(minfo, base)

    return tree_map_with_path(visit, params_like)
