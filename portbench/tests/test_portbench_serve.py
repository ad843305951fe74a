"""The serve cells' comparison at a size a CPU run holds: the served
tokens of the program's ``ServingEngine`` (its plain versions on the CPU)
lie close to the float32 reference's best, the control (the reference's
weights in posit8) lies several times farther, and each fault a serve
cell can have, planted under the timed path, turns ``correct`` false."""
import numpy as np
import pytest
import torch

from portbench.reference import granite_moe as ref
from portbench.tests import tiny

CPU = torch.device("cpu")
STEPS = 40


def run_cell(seed=tiny.SEED, steps=STEPS, **cfg):
    """The cell's set-up, then a fixed number of engine steps (not a
    timed window, so that the sample of finished requests repeats)."""
    cell = tiny.serve_cell()
    cell.config.update(cfg)
    r = tiny.driver(cell.traffic["driver"]).Run(cell, seed, CPU)
    r.setup()
    for _ in range(steps):
        r._step()
    r.failed = sum(len(q.tokens) != q.budget for q in r.done)
    return r


def test_served_tokens_match_reference():
    r = run_cell()
    checks = r.check()
    assert tiny.failed(checks) == [], checks
    assert r.done and r.failed == 0


def test_control_lies_several_times_farther():
    """The control (the reference with its weights in the configuration's
    control format) against the program, on the same sampled prompts and
    served tokens at the cell's 40 experts top-8: at this width the widest
    gap swings from seed to seed, so the test pools four seeds' gaps and
    holds their means apart by three times."""
    sound, ctl = [], []
    for k in range(4):
        r = run_cell(tiny.SEED + k, steps=30, num_local_experts=40,
                     num_experts_per_tok=8, moe_capacity_factor=5.0,
                     intermediate_size=16)
        r.release()
        full = ref.Reference(r.cfg, r.params)
        low = ref.Reference(r.cfg, r.params, **r.cfg["control"])
        for q in r.sample():
            sound.append(ref.served_gaps(full, q.prompt, q.tokens))
            ctl.append(ref.control_gaps(full, low, q.prompt, q.tokens))
    sound, ctl = torch.cat(sound), torch.cat(ctl)
    assert float(ctl.mean()) >= 3 * float(sound.mean()), (sound.mean(),
                                                          ctl.mean())


def _token_altered(monkeypatch):
    from repro_torch.serve import engine
    real = engine._Lane.decode

    def altered(self, seed):
        toks = real(self, seed)
        toks[0] = (toks[0] + 1) % self.model.cfg.vocab
        self.cur[0] = int(toks[0])
        return toks
    monkeypatch.setattr(engine._Lane, "decode", altered)


def _half_batch(monkeypatch):
    """The second half of each decode batch takes the mean logits of the
    first half."""
    from repro_torch.models.transformer import DecoderLM
    real = DecoderLM.decode_step

    def half(self, params, tokens, caches):
        logits, new = real(self, params, tokens, caches)
        B = logits.shape[0]
        keep = max(B // 2, 1)
        logits = logits.clone()
        logits[keep:] = logits[:keep].mean(0, keepdim=True)
        return logits, new
    monkeypatch.setattr(DecoderLM, "decode_step", half)


def _state_unchanged(monkeypatch):
    """A decode step's K/V never reaches the cache: its storage is
    returned unchanged (the lengths advance)."""
    from repro_torch.models.attention import KVCache
    real = KVCache.append

    def stale(self, k_new, v_new, new_length=None):
        if k_new.shape[1] > 1:
            return real(self, k_new, v_new, new_length)
        return KVCache(self.k, self.v, self.length + k_new.shape[1])
    monkeypatch.setattr(KVCache, "append", stale)


@pytest.mark.parametrize("fault", [_token_altered, _half_batch,
                                   _state_unchanged])
def test_fault_turns_correct_false(fault, monkeypatch):
    fault(monkeypatch)
    r = run_cell()
    monkeypatch.undo()
    assert tiny.failed(r.check())


def test_every_seed_runs_the_same_schedule_of_lengths():
    """Each round deals out the log-normal's quantiles once each, the same
    for every seed; the seed draws the token ids and the clients' order."""
    cell = tiny.serve_cell(clients=16, output={"median": 129, "sigma": 0.8},
                           prompt={"median": 1020, "sigma": 0.5})
    drv = tiny.driver(cell.traffic["driver"])
    a, b = drv.Run(cell, tiny.SEED, CPU), drv.Run(cell, tiny.SEED + 1, CPU)
    for r in (a, b):
        r._lengths()
    assert np.median(a.prompt_set) == pytest.approx(1020, rel=0.05)
    assert np.median(a.budget_set) == pytest.approx(129, rel=0.05)
    for k in range(3):
        pa, ba = a._round(k)
        pb, bb = b._round(k)
        assert (pa == pb).all() and (ba == bb).all()
        assert sorted(pa) == sorted(a.prompt_set)
        assert sorted(ba) == sorted(a.first_set if k == 0 else a.budget_set)
    assert (a.first_set <= a.budget_set).all() and a.first_set.min() >= 1
    assert sorted(a._draw(c, 1).budget for c in range(16)) == sorted(
        b._draw(c, 1).budget for c in range(16))
    assert (a._draw(0, 1).prompt[:8] != b._draw(0, 1).prompt[:8]).any()


def test_program_runs_none_of_the_published_multipliers():
    from portbench.lib import harness
    cfg = harness.load_json(
        harness.BENCH / "configs/granite-moe-3b-a800m.json")
    drv = tiny.driver("serve_closed")
    assert drv.model_config(cfg).n_experts == 40
    for k, v in cfg["published"].items():
        if k in cfg["reduced"]:
            with pytest.raises(ValueError):
                drv.model_config({**cfg, k: v})


def test_reference_applies_the_configuration_multipliers():
    cell = tiny.serve_cell()
    cfg = cell.config
    params = ref.make_params(cfg, tiny.SEED, CPU)
    toks = torch.arange(12) % cfg["vocab_size"]
    base = ref.Reference(cfg, params).logits(toks)
    scaled = ref.Reference({**cfg, "logits_scaling": 6.0}, params)
    assert torch.allclose(scaled.logits(toks), base / 6.0, atol=1e-6)
    other = ref.Reference({**cfg, "residual_multiplier": 0.22}, params)
    assert not torch.allclose(other.logits(toks), base, atol=1e-3)
