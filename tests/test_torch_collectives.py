"""The port's posit-compressed collectives on ``torch.distributed`` (gloo
on the CPU), against the reference's ``tests/test_collectives.py``:

* at world size 1, in this process: ``posit_all_reduce`` is bitwise
  ``decode(encode(x))``, and the EF variant's residual is exactly
  ``x − decode(encode(x))``;
* the tensors handed to the collectives are ``uint8`` views carrying the
  storage width (2 bytes an element for posit16, 1 for posit8);
* at world size 4, spawned processes (gloo over a file store) against the
  reference's ``posit_all_reduce`` on a forced 4-device host split, in a
  subprocess, on the same input: within one posit16 ulp per element (the
  implementation-defined tier: the f32 sum of the received chunks runs in
  another order), the reference's ``rel < 5e-3`` against the mean, every
  rank the same bits.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core.formats import get_format
from repro_torch.distributed import collectives
from repro_torch.kernels.ops import decode, encode

ENV = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}


@pytest.fixture
def world1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture
def wire(monkeypatch):
    """Record (collective, dtype, elements) of each tensor sent."""
    seen = []
    a2a, ag = dist.all_to_all_single, dist.all_gather

    def all_to_all_single(out, inp, **kw):
        seen.append(("all_to_all_single", inp.dtype, inp.numel()))
        return a2a(out, inp, **kw)

    def all_gather(outs, inp, **kw):
        seen.append(("all_gather", inp.dtype, inp.numel()))
        return ag(outs, inp, **kw)
    monkeypatch.setattr(dist, "all_to_all_single", all_to_all_single)
    monkeypatch.setattr(dist, "all_gather", all_gather)
    return seen


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("name,width", [("posit16", 2), ("posit8", 1),
                                        ("posit10", 2)])
@pytest.mark.parametrize("shape", [(3, 5, 7), (64,), (1,)])
def test_world_one_all_reduce_is_decode_of_encode(world1, wire, name,
                                                  width, shape):
    fmt = get_format(name)
    rng = np.random.default_rng(len(shape) + fmt.n)
    x = torch.from_numpy((rng.standard_normal(shape)
                          * np.exp2(rng.integers(-12, 12, shape)))
                         .astype(np.float32))
    out = collectives.posit_all_reduce(x, fmt)
    q = decode(encode(x, fmt), fmt)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert torch.equal(_bits(out), _bits(q))
    n = x.numel()
    assert wire == [("all_to_all_single", torch.uint8, n * width),
                    ("all_gather", torch.uint8, n * width)]


def test_world_one_ef_residual_is_exact(world1):
    fmt = get_format("posit16")
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    r0 = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)
                          * 1e-3)
    for residual in (None, r0):
        out, res = collectives.posit_all_reduce_ef(x, residual, fmt)
        xf = x if residual is None else x + residual
        q = decode(encode(xf, fmt), fmt)
        assert torch.equal(_bits(res), _bits(xf - q))
        assert torch.equal(_bits(out), _bits(q))
        # the residual carries exactly what the wire lost
        assert torch.equal(_bits(q + res), _bits(xf))


RANKS = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def rank_main(rank, world, store, out):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        from repro_torch.core.formats import get_format
        from repro_torch.distributed import collectives as C
        sent = []
        a2a, ag = dist.all_to_all_single, dist.all_gather
        def all_to_all_single(o, i, **kw):
            sent.append(["all_to_all_single", str(i.dtype), i.numel()])
            return a2a(o, i, **kw)
        def all_gather(o, i, **kw):
            sent.append(["all_gather", str(i.dtype), i.numel()])
            return ag(o, i, **kw)
        dist.all_to_all_single, dist.all_gather = all_to_all_single, all_gather
        fmt = get_format("posit16")
        x = np.random.default_rng(0).normal(size=(world, 64))
        x = torch.from_numpy(x.astype(np.float32)[rank])
        y = C.posit_all_reduce(x, fmt)
        y_ef, res = C.posit_all_reduce_ef(x, None, fmt)
        np.savez(f"{out}/rank{rank}.npz", y=y.numpy(), y_ef=y_ef.numpy(),
                 res=res.numpy())
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(sent, f)
        dist.destroy_process_group()

    if __name__ == "__main__":
        out = sys.argv[1]
        mp.start_processes(rank_main, args=(4, f"{out}/store", out),
                           nprocs=4, start_method="spawn")
        print("RANKS_OK")
""")

JAX_SIDE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_mesh, shard_map
    from repro.core.formats import POSIT16
    from repro.distributed.collectives import posit_all_reduce
    assert jax.device_count() == 4
    mesh = make_mesh((4,), ("pod",))
    x = np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32)
    fn = shard_map(lambda v: posit_all_reduce(v, "pod", 4, POSIT16),
                   mesh=mesh, in_specs=P("pod"), out_specs=P("pod"),
                   check_vma=False)
    np.save(sys.argv[1], np.asarray(fn(x)))
    print("JAX_OK")
""")


def _ulps(a, b, fmt):
    def ordered(v):
        p = encode(torch.from_numpy(np.asarray(v, np.float32)), fmt)
        p = p.to(torch.int64) & fmt.mask
        return (p ^ fmt.nar_pattern) - fmt.nar_pattern
    return (ordered(a) - ordered(b)).abs()


def test_world_four_within_one_ulp_of_the_reference(tmp_path):
    script = tmp_path / "ranks.py"
    script.write_text(RANKS)
    jax_out = tmp_path / "jax.npy"
    jobs = [subprocess.Popen([sys.executable, str(script), str(tmp_path)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=ENV),
            subprocess.Popen([sys.executable, "-c", JAX_SIDE, str(jax_out)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=ENV)]
    try:
        outs = [j.communicate(timeout=300) for j in jobs]
    finally:
        for j in jobs:
            j.kill()
    assert "RANKS_OK" in outs[0][0], outs[0][0] + outs[0][1]
    assert "JAX_OK" in outs[1][0], outs[1][0] + outs[1][1]
    fmt = get_format("posit16")
    x = np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32)
    want = np.load(jax_out)
    mean = x.mean(axis=0)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(4)]
    for r, g in enumerate(got):
        assert g["y"].tobytes() == got[0]["y"].tobytes(), r
        assert g["y_ef"].tobytes() == g["y"].tobytes(), r
        assert int(_ulps(g["y"], want[r], fmt).max()) <= 1, r
        rel = np.linalg.norm(g["y"] - mean) / np.linalg.norm(mean)
        assert rel < 5e-3, (r, rel)
        xr = torch.from_numpy(x[r])
        q = decode(encode(xr, fmt), fmt)
        assert torch.equal(_bits(torch.from_numpy(g["res"])), _bits(xr - q))
        sent = json.loads((tmp_path / f"rank{r}.json").read_text())
        # 64 values a rank, 16 a chunk: 2 bytes each on the wire, twice
        # for the all-reduce and twice for its EF call
        assert sent == [["all_to_all_single", "torch.uint8", 128],
                        ["all_gather", "torch.uint8", 32]] * 2
