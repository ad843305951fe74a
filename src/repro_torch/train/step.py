"""The train step — the counterpart of ``repro.train.step``: loss →
gradients (``torch.autograd``) → (optional posit-compressed cross-pod
all-reduce) → AdamW.

Weight quantization during training is QAT-style: master weights stay
f32, the forward sees posit-rounded values with straight-through
gradients (``fake_quant``; on the card the round kernel, B1, once a
rounded leaf and step).  The reference's rule picks the leaves: every f32
or bf16 leaf of two or more dims, stacked norm gains included.

The step's order keeps one extra copy of the parameters at a time: the
rounded tree lives through the forward and backward only, and is released
before AdamW updates the master weights in place, one leaf at a time.

The pod-compressed branch (a mesh with a ``pod`` axis and a policy with a
``grad_allreduce`` format) runs one process per pod under
``torch.distributed``: each rank takes its rows of the global batch (the
reference's ``shard_map`` over ``P(pod)``), computes their gradients and
sends each through ``distributed.collectives.posit_all_reduce`` (the codec
kernels, B5, on the card); the loss and the metrics are averaged over the
group.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.checkpoint.manager import flatten_state, unflatten_state
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quant import fake_quant
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import wsd_schedule


class TrainState(dict):
    """{params, opt: {m, v, step}}: a plain dict."""


def init_train_state(params) -> dict:
    return {"params": params, "opt": adamw_init(params)}


def _apply_weight_quant(params, policy: QuantPolicy):
    """The tree with every f32 or bf16 leaf of two or more dims through
    ``fake_quant`` (the reference's rule); the rest as it is."""
    fmt = policy.weights
    if fmt is None:
        return params

    def q(x):
        if isinstance(x, dict):
            return {k: q(v) for k, v in x.items()}
        if x.dim() >= 2 and x.dtype in (torch.float32, torch.bfloat16):
            return fake_quant(x, fmt)
        return x

    return q(params)


def _rows(batch, lo: int, hi: int):
    return {k: torch.as_tensor(v)[lo:hi] for k, v in batch.items()}


def make_train_step(model, minfo, policy: QuantPolicy = QuantPolicy(),
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    microbatches: int = 1):
    """Returns ``step(state, batch) -> (state, metrics)``; the state's
    tensors are updated in place.

    ``microbatches`` > 1 accumulates f32 gradients over leading-batch
    splits and divides by ``microbatches``; the loss and metrics are the
    microbatches' means."""
    compress_fmt = policy.fmt("grad_allreduce")
    pod_axis = minfo.pod_axis

    def single_grads(params, batch):
        leaves, _ = flatten_state(params)
        live = [t.detach().requires_grad_() for t in leaves]
        with torch.enable_grad():
            loss, metrics = model.loss(
                _apply_weight_quant(unflatten_state(params, live), policy), batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        # the rounded tree and the graph are gone here
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def plain_grads(params, batch):
        if microbatches == 1:
            return single_grads(params, batch)
        rows = torch.as_tensor(batch["tokens"]).shape[0]
        if rows % microbatches:
            raise ValueError(f"{rows} rows do not split into {microbatches} "
                             f"microbatches")
        n = rows // microbatches
        acc, losses, metricses = None, [], []
        for i in range(microbatches):
            loss, metrics, grads = single_grads(
                params, _rows(batch, i * n, (i + 1) * n))
            if acc is None:
                acc = [torch.zeros_like(g, dtype=torch.float32)
                       for g in grads]
            for a, g in zip(acc, grads):
                a.add_(g.to(torch.float32))
            del grads
            losses.append(loss)
            metricses.append(metrics)
        for a in acc:
            a.div_(microbatches)
        return (torch.stack(losses).mean(), {
            k: torch.stack([m[k] for m in metricses]).mean()
            for k in metricses[0]}, acc)

    if compress_fmt is not None and pod_axis is not None:
        import torch.distributed as dist
        from repro_torch.distributed.collectives import posit_all_reduce
        pod_size = minfo.shape[pod_axis]

        def grads_fn(params, batch):
            """This rank's rows' gradients, posit-compressed and averaged
            over the pods."""
            if dist.get_world_size() != pod_size:
                raise ValueError(f"the mesh has {pod_size} pods, the "
                                 f"process group {dist.get_world_size()} "
                                 f"ranks")
            rank = dist.get_rank()
            rows = torch.as_tensor(batch["tokens"]).shape[0]
            if rows % pod_size:
                raise ValueError(f"{rows} rows do not split over "
                                 f"{pod_size} pods")
            n = rows // pod_size
            loss, metrics, grads = plain_grads(
                params, _rows(batch, rank * n, (rank + 1) * n))
            grads = [posit_all_reduce(g, compress_fmt) for g in grads]
            out = torch.stack([loss, *metrics.values()])
            dist.all_reduce(out)
            out = out / pod_size
            return out[0], dict(zip(metrics, out[1:])), grads
    else:
        grads_fn = plain_grads

    def step(state, batch):
        loss, metrics, grads = grads_fn(state["params"], batch)
        lr = wsd_schedule(state["opt"]["step"])
        params, opt = adamw_update(
            state["params"], unflatten_state(state["params"], grads),
            state["opt"], lr, opt_cfg)
        del grads
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["lr"] = lr
        return {"params": params, "opt": opt}, metrics

    return step
