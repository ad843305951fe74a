"""The port's trainer (``repro_torch.launch.train``) on the CPU:

* the port of ``tests/test_system.py::test_training_reduces_loss``:
  reduced gemma2-2b, 60 steps of 8 × 64 tokens, the mean of the last 10
  losses 0.01 below the first 10's;
* the port of ``test_resume_is_exact``, stricter: reduced qwen3-8b, 60
  steps straight against 50 steps with a checkpoint and a resume to 60,
  the last 10 losses EQUAL (the reference holds rtol 1e-4), and the
  resumed run's final state bitwise the straight run's;
* posit16 QAT and microbatching through the trainer;
* the CLI with ``--device cpu``;
* ``train()`` without a device resolving to the card, which raises here.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import flatten_state
from repro_torch.core.policy import QuantPolicy
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import train


def test_training_reduces_loss():
    _, losses = train("gemma2-2b", steps=60, batch=8, seq=64, log_every=1000,
                      device="cpu")
    assert len(losses) == 60 and np.all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.01


def test_resume_is_exact(tmp_path):
    full_state, full = train("qwen3-8b", steps=60, batch=4, seq=32,
                             log_every=1000, device="cpu")
    d = tmp_path / "ckpt"
    _, first = train("qwen3-8b", steps=50, batch=4, seq=32, ckpt_dir=str(d),
                     log_every=1000, device="cpu")
    state, resumed = train("qwen3-8b", steps=60, batch=4, seq=32,
                           ckpt_dir=str(d), log_every=1000, device="cpu")
    assert first == full[:50]
    assert len(resumed) == 10 and resumed == full[-10:]
    assert int(state["opt"]["step"]) == 60
    for a, b in zip(flatten_state(state)[0], flatten_state(full_state)[0]):
        assert torch.equal(a, b)


def test_qat_and_microbatches_through_the_trainer(capsys):
    state, losses = train("qwen3-8b", steps=3, batch=4, seq=16,
                          policy=QuantPolicy(weights="posit16"),
                          microbatches=2, log_every=1, device="cpu")
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert int(state["opt"]["step"]) == 3
    assert capsys.readouterr().out.count("[train] step=") == 3


def test_cli_on_the_cpu(tmp_path, capsys):
    state, losses = train_cli.main([
        "--arch", "xlstm-1.3b", "--steps", "2", "--batch", "2", "--seq",
        "16", "--weights-format", "posit16", "--ckpt", str(tmp_path),
        "--device", "cpu"])
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert state["params"]["embed"]["table"].device.type == "cpu"
    assert (tmp_path / "step-000000002" / "state.npz").exists()
    assert "[train] step=1" in capsys.readouterr().out


def test_train_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train("qwen3-8b", steps=1, batch=2, seq=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--steps", "1"])
