"""Each plain reference against the port on the CPU at a reduced size,
through the harness's own driver and check, with float32 weights (test
code may import both)."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.lib import serve, traffic, weights  # noqa: E402
from perfbench.reference import ssm as ref_ssm  # noqa: E402

SEED = 2 ** 31 + 4242          # beyond 32 signed bits, as a run's may be


def tiny_ssm(dtype: str = "float32") -> dict:
    return {"name": "t", "family": "ssm", "n_layers": 2, "d_model": 64,
            "n_heads": 0, "n_kv_heads": 0, "d_ff": 0, "vocab": 512,
            "ssm_state": 16, "ssm_headdim": 16, "ssm_expand": 2,
            "ssm_chunk": 16, "conv_width": 4, "tie_embeddings": True,
            "param_dtype": dtype, "act_dtype": dtype, "remat": "full",
            "optimizer": "adamw"}


def mix(batch, prompt_len, gen, batches, rows) -> dict:
    return {"kind": "serve", "loop": "closed", "clients": 1, "batch": batch,
            "prompt_len": prompt_len, "gen": gen, "ids": "uniform",
            "check": {"batches": batches, "rows": rows}}


CASES = {
    "ssm-prefill": (tiny_ssm, mix(3, 64, 1, 2, 1)),
    "ssm-decode": (tiny_ssm, mix(3, 64, 5, 2, 2)),
}


def run_case(name: str, precision=None):
    model, m = CASES[name]
    cell = serve.Serve({"model": model()}, m, SEED, "cpu")
    cell.setup()
    batches, _ = cell.window(0.0, min_batches=m["check"]["batches"] + 1)
    return cell, batches


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_agrees_with_port(name):
    cell, batches = run_case(name)
    numbers = cell.check(batches)
    assert numbers["token_gap"] <= 1e-5
    if "state_err" in numbers:
        assert numbers["state_err"] <= 1e-5


@pytest.mark.parametrize("name", ["ssm-decode", "ssm-prefill"])
def test_control_departs(name):
    """The float8 control lies farther from the reference than the port."""
    cell, batches = run_case(name)
    mine = cell.check(batches)
    control = cell.check(batches, against="fp8")
    key = "state_err" if "state_err" in mine else "token_gap"
    assert control[key] > 100 * max(mine[key], 1e-7)


@pytest.mark.parametrize("size,batches", [(1, 9), (4, 4), (4, 40)])
def test_check_sample_is_a_reservoir(size, batches):
    """The check's sample holds ``size`` batches at most at any time, ends
    with as many as it can, and is the same for the same seed."""
    m = mix(2, 16, 1, size, 1)

    def draw():
        sample, held = traffic.CheckSample(m, SEED), set()
        for i in range(batches):
            kept, out = sample.offer(i)
            if out is not None:
                held.remove(out)
            if kept:
                held.add(i)
            assert len(held) <= size
        assert held == set(sample.kept)
        return sorted(held)
    first = draw()
    assert len(first) == min(size, batches) and first == draw()


def test_window_keeps_states_of_the_sample_only():
    """A serving window holds the states the check compares for the
    sampled batches alone, however many batches it finishes."""
    model, m = CASES["ssm-prefill"]
    cell = serve.Serve({"model": model()}, m, SEED, "cpu")
    cell.setup()
    batches, _ = cell.window(0.0, min_batches=7)
    held = [b.index for b in batches if b.states]
    assert held == sorted(cell.sample.kept)
    assert len(held) == m["check"]["batches"]


def test_sample_reaches_every_batch():
    """Over seeds, every finished batch is sometimes compared, the last
    too: the reservoir is uniform over the window."""
    m = mix(2, 16, 1, 2, 1)
    seen = set()
    for seed in range(64):
        sample = traffic.CheckSample(m, seed)
        for i in range(8):
            sample.offer(i)
        seen |= set(sample.kept)
    assert seen == set(range(8))


def test_ssm_chunked_matches_the_plain_recurrence():
    """The reference's chunked prompt pass against its token-by-token
    recurrence from a zero state, on the same layer."""
    m = tiny_ssm()
    params = weights.make(m, SEED, "cpu")
    p = {k: v[0] for k, v in params["layers"]["ssm"].items()}
    h = torch.randn(2, 48, 64, generator=torch.Generator().manual_seed(1))
    out, state, _ = ref_ssm.mixer_prompt(m, p, h, "fp32")
    zero = {"x": torch.zeros(2, 3, 128), "B": torch.zeros(2, 3, 16),
            "C": torch.zeros(2, 3, 16)}
    step = ref_ssm.mixer_step(m, p, h, torch.zeros(2, 8, 16, 16), zero,
                              "fp32")
    torch.testing.assert_close(out, step, rtol=1e-4, atol=1e-5)
