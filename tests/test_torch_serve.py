"""repro_torch's server (launch/serve.py) and chip_smoke.py's
phases H, J and K at a small size, against the JAX package, on the CPU.

Weights come from the JAX package's ``init_params`` (carried with
``params_from_numpy``), prompts from seeded numpy; the port's greedy
tokens must equal those of a greedy loop over the reference's
``M.prefill`` and ``M.decode_step`` (no mesh). The reference's MoE
without a mesh is ``_moe_dense``; at ``capacity_factor`` 8 no token
overflows, so the port's dispatch path computes the same layer.
"""
import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the JAX ISA
import repro_torch.kernels  # noqa: F401 — registers the port's ISA
from repro.configs import get_config as jget_config
from repro.core import isa as jisa
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.kernels import flashattn as fa
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.models.params import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "kimi-k2-1t", "--reduced", "--device", "cpu",
        "--batch", "2", "--prompt-len", "12", "--gen", "5"]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_serve",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_greedy(jcfg, jp, prompts: np.ndarray, gen: int) -> np.ndarray:
    logits, cache = jax.jit(lambda p, b: JM.prefill(jcfg, p, b))(
        jp, {"tokens": jnp.asarray(prompts)})
    s = prompts.shape[1]
    cache = JM.grow_cache(jcfg, cache, s, s + gen)
    step = jax.jit(lambda p, c, t, pos: JM.decode_step(jcfg, p, c, t, pos))
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out = [tok]
    for i in range(gen - 1):
        logits, cache = step(jp, cache, tok, jnp.int32(s + i))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


def carried(arch, **over):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                            "cpu")


def test_main_generates_gen_tokens_per_row(capsys):
    gen = serve.main(ARGS)
    assert gen.shape == (2, 5) and gen.dtype == np.int32
    assert ((gen >= 0) & (gen < 512)).all()
    out = capsys.readouterr().out
    assert "prefill 2×12" in out and "decoded 5 tokens" in out


def test_greedy_is_deterministic():
    np.testing.assert_array_equal(serve.main(ARGS), serve.main(ARGS))


def test_sampling_follows_the_generator_seed():
    hot = ARGS + ["--temperature", "1.0"]
    a = serve.main(hot + ["--seed", "3"])
    np.testing.assert_array_equal(a, serve.main(hot + ["--seed", "3"]))
    logits = torch.randn(4, 50)
    draws = [serve.sample(logits, torch.Generator().manual_seed(s), 1.0)
             for s in (1, 1)]
    assert torch.equal(*draws) and draws[0].dtype == torch.int32
    assert torch.equal(serve.sample(logits, None, 0.0)[:, 0],
                       logits.argmax(-1).int())


@pytest.mark.parametrize("arch,over", [
    ("kimi_k2_1t", {"capacity_factor": 8.0}),
    ("llama3_8b", {}),
])
def test_generate_equals_a_greedy_loop_over_the_reference(arch, over):
    jcfg, cfg, jp, tp = carried(arch, **over)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (2, 16))
    want = jax_greedy(jcfg, jp, prompts.astype(np.int32), 6)
    got, t_prefill, t_decode = serve.generate(
        cfg, tp, torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and t_prefill > 0 and t_decode > 0


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "hymba_1p5b"])
def test_generate_ssm_families_equal_a_greedy_loop_over_the_reference(arch):
    # 48 tokens: whole chunks (16 reduced), and past Hymba's window (32)
    jcfg, cfg, jp, tp = carried(arch)
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, (2, 48))
    want = jax_greedy(jcfg, jp, prompts.astype(np.int32), 6)
    got, t_prefill, t_decode = serve.generate(
        cfg, tp, torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and t_prefill > 0 and t_decode > 0


SSM_ARGS = ["--arch", "mamba2-1.3b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "32", "--gen", "6"]


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_main_sched_gives_the_unscheduled_tokens(arch, capsys):
    args = SSM_ARGS[:1] + [arch] + SSM_ARGS[2:]
    plain = serve.main(args)
    # a target no CPU step misses, however loaded the machine
    sched = serve.main(args + ["--sched", "--sched-policy", "fifo",
                               "--slo-ms", "60000"])
    np.testing.assert_array_equal(sched, plain)
    out = capsys.readouterr().out
    assert "sched[fifo]: 5 steps, 0 past the 60000 ms SLO" in out


def test_main_sched_reports_slo_tail_trace_blame_and_metrics(
        tmp_path, capsys, monkeypatch):
    from repro_torch.core import artifact
    from repro_torch.obs import trace as ttrace
    import json
    import re
    import urllib.request
    scraped, printed = [], []

    def scrape(seconds):      # --metrics-hold: the endpoint still answers
        printed.append(capsys.readouterr().out)
        port = re.search(r"metrics http://127\.0\.0\.1:(\d+)/metrics",
                         printed[0]).group(1)
        for path in ("/metrics", "/metrics.json"):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=10) as r:
                scraped.append(r.read().decode())

    monkeypatch.setattr(serve.time, "sleep", scrape)
    paths = {k: tmp_path / f"{k}.json" for k in ("tail", "trace", "sched")}
    plain = serve.main(SSM_ARGS)
    capsys.readouterr()
    gen = serve.main(SSM_ARGS + [
        "--sched", "--slo-shed", "--slo-ms", "5000",
        "--obs-tail", str(paths["tail"]), "--obs-trace", str(paths["trace"]),
        "--sched-trace", str(paths["sched"]), "--metrics", "0",
        "--metrics-hold", "1", "--region-slots", "1",
        "--plan-cache", str(tmp_path / "plans")])
    np.testing.assert_array_equal(gen, plain)        # nothing shed
    out = "".join(printed) + capsys.readouterr().out
    assert len(printed) == 1 and len(scraped) == 2
    for line in ("sched[edf]: 5 steps, 0 past the 5000 ms SLO",
                 "regions[lru]: 1 slots/lane", "slo[decode]: burn",
                 "sched trace (", "obs trace (", "obs tail: kept",
                 "blame[decode]:"):
        assert line in out, line
    assert "slo-shed:" not in out
    assert "# TYPE repro_sched_latency_seconds histogram" in scraped[0]
    assert json.loads(scraped[1])["repro_slo_burn_rate"]["kind"] == "gauge"
    assert json.loads(paths["trace"].read_text())["traceEvents"]
    for line in paths["tail"].read_text().splitlines():
        json.loads(line)
    assert len(paths["sched"].read_text().splitlines()) > 5
    # the run's tracer and plan cache are put back
    assert ttrace.get_tracer() is None
    assert artifact._STATE == (False, None)


def test_main_slo_shed_drops_steps_past_the_slo(capsys, monkeypatch):
    # every step takes over the 1 ms target (a 3 ms pause in it), so the
    # first completion breaches; the burn windows (20 and 200 ms) still
    # hold it at the next arrival, which is shed, and so are the rest
    # (a shed counts as a bad event). No token for a shed step.
    step = serve.M.decode_step

    def slow_step(*args):
        time.sleep(3e-3)
        return step(*args)

    monkeypatch.setattr(serve.M, "decode_step", slow_step)
    gen = serve.main(SSM_ARGS + ["--gen", "40", "--sched", "--slo-shed",
                                 "--slo-ms", "1"])
    out = capsys.readouterr().out
    shed = int(re.search(r"slo-shed: (\d+) decode steps shed", out).group(1))
    assert shed > 0 and gen.shape == (2, 40 - shed)
    assert "BURNING" in out and "sched[edf]: 1 steps, 1 past" in out


# ---------------------------------------------------------------------------
# chip_smoke.py's phase H at a small size
# ---------------------------------------------------------------------------

def test_smoke_phase_h_matches_jax(smoke):
    # Kimi-K2's router shape (384 experts, top-8: padded to 512 lanes) and
    # attention on c6, at reduced widths
    over = dict(capacity_factor=8.0, n_experts=384, top_k=8,
                attn_impl="kernel")
    jcfg, cfg, jp, tp = carried("kimi_k2_1t", **over)
    prompts = smoke.serve_prompts(0, cfg, 2, 16, "cpu")
    with jisa.use("interpret"):
        want = jax_greedy(jcfg, jp, prompts.numpy().astype(np.int32), 4)
    got = smoke.phase_h(cfg, tp, prompts, 4, "interpret")[0]
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke.phase_h(cfg, tp, prompts, 4, "kernel")


def test_smoke_lm_config_keeps_every_published_width(smoke):
    cfg, full = smoke.lm_config(), get_config("kimi_k2_1t")
    changed = {k for k, v in dataclasses.asdict(cfg).items()
               if v != getattr(full, k)}
    assert changed == {"n_layers", "attn_impl"}
    assert (cfg.n_layers, cfg.attn_impl) == (2, "kernel")
    assert 67.8 < smoke.weight_bytes(cfg) / 2**30 < 68.0     # GiB
    assert smoke.PEAK_MEM_LIMIT["H"] == smoke.weight_bytes(cfg) + 8e9


def test_smoke_taps_record_and_restore(smoke):
    fn = serve.sample
    with smoke.Tap(serve, "sample") as tap:
        serve.sample(torch.zeros(2, 3), None, 0.0)
    assert serve.sample is fn and len(tap.calls) == 1


def test_smoke_attention_bound_holds_and_catches_an_error(smoke):
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, s, 32),
                                                    dtype=np.float32))
               for s in (64, 128, 128))
    got = fa.flash_attention_plain(q, k, v)
    want = ref.flash_attention(q, k, v)
    bound = smoke.attn_bound(q, k, v)
    assert bound.shape == (2, 3, 64, 1)
    assert smoke.attn_misses(got, want, bound)[0] == 0
    bad = got.clone()
    bad[1, 2, 5, 7] += 1e-2
    assert smoke.attn_misses(bad, want, bound)[0] == 1
    # bfloat16: the bound plus one ulp at |want| + bound
    gb, wb = got.to(torch.bfloat16), want.to(torch.bfloat16)
    assert smoke.attn_misses(gb, wb, bound)[0] == 0
    assert float(smoke.bf16_ulp(torch.tensor([1.0, 3.0]))[1]) == 2 ** -6


def test_smoke_routing_agreement(smoke):
    a = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]])
    b = torch.tensor([[3, 2, 1, 0], [4, 5, 6, 9]])
    assert smoke.routing_agreement(a, b) == 7 / 8


# ---------------------------------------------------------------------------
# chip_smoke.py's phases J and K at a small size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2_1p3b", "hymba_1p5b"])
def test_smoke_phase_ssm_matches_jax(smoke, arch):
    jcfg, cfg, jp, tp = carried(arch)
    prompts = smoke.serve_prompts(0, cfg, 2, 48, "cpu")
    with jisa.use("interpret"):
        want = jax_greedy(jcfg, jp, prompts.numpy().astype(np.int32), 4)
    got = smoke.phase_h(cfg, tp, prompts, 4, "interpret")[0]
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke.phase_h(cfg, tp, prompts, 4, "kernel")


def test_smoke_ssm_serves_keep_every_published_width(smoke):
    for phase, (arch, batch, prompt, gen) in smoke.SSM_SERVES.items():
        cfg = get_config(arch)
        assert cfg == get_config(arch.replace("_", "-"))
        assert prompt % cfg.ssm_chunk == 0 and gen > 1
        limit = smoke.PEAK_MEM_LIMIT[phase]
        assert limit == smoke.ssm_peak_limit(cfg, batch, prompt)
        assert limit > smoke.weight_bytes(cfg)
    arch, batch, prompt, _ = smoke.SSM_SERVES["J"]
    cfg = get_config(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
            cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk, cfg.vocab) == \
        (48, 2048, 4096, 64, 64, 128, 256, 50280)
    # each layer's state scan at phase G's shape
    assert (batch, prompt // cfg.ssm_chunk, cfg.ssm_heads) == smoke.SSD_SHAPE
    assert (cfg.ssm_headdim, cfg.ssm_state) == smoke.SSD_STATE
    assert 2.50 < smoke.weight_bytes(cfg) / 2**30 < 2.51        # GiB
    arch, batch, prompt, _ = smoke.SSM_SERVES["K"]
    cfg = get_config(arch)
    assert prompt == 2 * cfg.swa_window and cfg.n_layers == 32
    assert 2.96 < smoke.weight_bytes(cfg) / 2**30 < 2.97


def test_smoke_event_kinds_and_top_kernels(smoke):
    events = [("void k4_state_scan", 0.2), ("vectorized_elementwise_kernel",
                                             3.0),
              ("ampere_sgemm_128x64", 1.0), ("vectorized_elementwise_kernel",
                                             2.0), ("softmax_warp", 0.5)]
    ms = smoke.ms_by_kind(events, smoke.LM_KINDS)
    assert ms["K4"] == 0.2 and ms["elementwise"] == 5.0
    assert ms["matmul"] == 1.0 and ms["other"] == 0.5     # softmax
    assert smoke.top_events(events, n=2, width=10) == [
        ["vectorized", 5.0, 2], ["ampere_sge", 1.0, 1]]


def test_smoke_scheduled_serve_helper(smoke):
    extra = ["--reduced", "--device", "cpu"]
    plain, _ = smoke.scheduled_serve("mamba2_1p3b", 2, 32, 5, extra)
    # a target no CPU step can miss: a shed step would change the tokens
    sched, text = smoke.scheduled_serve(
        "mamba2_1p3b", 2, 32, 5,
        extra + ["--sched", "--slo-shed", "--slo-ms", "60000"])
    np.testing.assert_array_equal(sched, plain)
    assert "sched[edf]:" in text and "slo[decode]:" in text


_CHILD = textwrap.dedent("""
    import sys
    import repro_torch.models.model
    import repro_torch.models.ssm
    import repro_torch.obs
    import repro_torch.launch.serve
    from repro_torch.kernels import _cuda
    assert _cuda._LOADED == {}
    bad = [m for m in ("jax", "repro", "triton", "ml_dtypes")
           if m in sys.modules]
    assert not bad, bad
    maps = open("/proc/self/maps").read()
    assert "libcuda." not in maps and "libcudart" not in maps
    print("ok")
""")


def test_import_of_model_and_serve_loads_no_jax_triton_or_cuda_library():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"
