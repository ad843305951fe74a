"""The port's synthetic token pipeline (``repro_torch.data.tokens``)
against the JAX package's: the port of
``tests/test_substrate.py::test_pipeline_deterministic_and_resumable``, and
the tokens bitwise equal to the reference's for several (seed, step,
host slice), as ``torch.int32`` on the CPU."""
import numpy as np
import pytest
import torch

from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.data.tokens import TokenPipelineConfig as JTokenPipelineConfig
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig


def test_pipeline_deterministic_and_resumable():
    cfg = TokenPipelineConfig(vocab=128, seq_len=32, global_batch=8, seed=3)
    p1, p2 = TokenPipeline(cfg), TokenPipeline(cfg)
    b1 = p1.batch_at(17)
    b2 = p2.batch_at(17)
    assert torch.equal(b1["tokens"], b2["tokens"])
    # host sharding: slices of the global batch match
    lo = p1.batch_at(17, host_slice=slice(0, 4))
    assert torch.equal(lo["tokens"], b1["tokens"][:4])


@pytest.mark.parametrize("seed,step,host_slice,vocab", [
    (0, 0, None, 512),
    (0, 49, None, 256000),
    (3, 17, slice(2, 6), 128),
    (7, 1000, slice(5, None), 50304),
    (1, 3, slice(0, 8, 3), 32000),
])
def test_tokens_equal_the_references(seed, step, host_slice, vocab):
    kw = dict(vocab=vocab, seq_len=64, global_batch=8, seed=seed)
    want = JTokenPipeline(JTokenPipelineConfig(**kw)).batch_at(
        step, host_slice)["tokens"]
    got = TokenPipeline(TokenPipelineConfig(**kw)).batch_at(
        step, host_slice)["tokens"]
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_iteration_walks_the_steps():
    pipe = TokenPipeline(TokenPipelineConfig(vocab=64, seq_len=8,
                                             global_batch=2))
    it = iter(pipe)
    for step in range(3):
        assert torch.equal(next(it)["tokens"], pipe.batch_at(step)["tokens"])
