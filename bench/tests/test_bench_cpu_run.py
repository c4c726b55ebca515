"""The whole harness on the CPU at a reduced configuration: sound runs come
out correct, and with the timed path broken underneath ``correct`` comes
out false, once for each fault a served cell can have (a step that leaves
its state as it was, half of the batch left out, a token altered where it
is produced).  The look for a card is skipped: ``cell.run`` is called with
``device="cpu"``."""
import math

import pytest
import torch

import tiny_cell
from repro_torch.serving import server


@pytest.mark.parametrize("kind", ["backlog", "poisson"])
def test_sound_run_is_correct(tmp_path, kind):
    r = tiny_cell.run(tmp_path, kind=kind)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    names = set(r["metrics"])
    assert "setup_s" in names and "tpot_p95_ms" in names
    assert "tok_s" in names
    assert list(r)[-1] == "checks"
    assert r["checks"]["logit_gap"]["value"] <= r["checks"]["logit_gap"]["limit"]


@pytest.mark.parametrize("kind", ["backlog", "poisson"])
def test_traced_run_reads_its_layers(tmp_path, kind):
    """A ``--trace 1`` run on the CPU: the profiler sees no kernel, so the
    device readers find nothing to read and stay out of the line; the host
    readers report."""
    r = tiny_cell.run(tmp_path, kind=kind, trace=True)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert m["accept_len"]["value"] >= 1.0 and m["tick_ms"]["value"] > 0
    assert "mfu.step" in m and 0 < m["mfu.step"]["value"] < 100
    assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0
    assert "gemm_roofline" not in m and "attn_roofline" not in m
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def _unchanged(orig):
    def step_fn(self, state):
        return state
    return step_fn


def _half(orig):
    def step_fn(self, state):
        length, tokens = state["length"].clone(), state["tokens"].clone()
        state = orig(self, state)
        keep = math.ceil(length.shape[0] / 2)
        state["length"][keep:] = length[keep:]
        state["tokens"][keep:] = tokens[keep:]
        return state
    return step_fn


def _altered(orig):
    def step_fn(self, state):
        before = state["length"].clone()
        state = orig(self, state)
        V = self.engine.model.cfg.vocab_size
        for r in range(before.shape[0]):
            a, b = int(before[r]), int(state["length"][r])
            if b > a:
                state["tokens"][r, a] = (state["tokens"][r, a] + 1) % V
        return state
    return step_fn


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("kind", ["backlog", "poisson"])
def test_broken_step_is_not_correct(tmp_path, monkeypatch, fault, kind):
    monkeypatch.setattr(server._Lane, "step_fn", fault(server._Lane.step_fn))
    # arrivals fast enough to fill every slot of the open loop
    r = tiny_cell.run(tmp_path, kind=kind, seconds=1.5, drain_cap=2.0,
                      rate=40.0 if kind == "poisson" else None)
    assert not r["correct"], r["checks"]


def test_reference_matches_the_program_forward():
    """The plain reference against the program's own W8A8 forward at the
    reduced size, float32 on both sides: the same logits to rounding."""
    import json

    from benchkit import program, reference, weights

    root, _ = tiny_cell.make(tiny_cell.Path(__import__("tempfile").mkdtemp()))
    cfg = json.loads((root / "bench/configs/tiny.json").read_text())
    raw = weights.make(reference.layout(cfg["model"]), 3, "cpu")
    mcfg = program.model_config(cfg)
    eng = program.engine(mcfg, cfg, "cpu")
    prepared = eng.prepare_params(program.program_params(mcfg, raw))
    tok = torch.randint(0, cfg["model"]["vocab_size"], (40,),
                        generator=torch.Generator().manual_seed(1))
    ours, _ = eng.model.forward(prepared, tok[None])
    ref = reference.logits(cfg["model"], raw, [tok.long()], [0])[0]
    assert (ours[0, :-1] - ref).abs().max() < 2e-3
