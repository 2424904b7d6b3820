"""A configuration, a traffic mix, a per-layer metric and a cell are added
by new files and BENCHMARK.json entries alone: in a temporary copy of
the benchmark, with no file of it edited, the new cell runs (on the CPU,
at a reduced size, the look for a chip skipped) and reports the new
metric. Once for a family the benchmark already has (``ssm``), once
for one it has no file of (the port's ``dense`` transformer), whose
plain reference, weight layout and laws come in a new
``perfbench/reference/dense.py``, and once (``dense-tree``) with that
reference giving the whole weight tree (``layout``, its norms stated
in float32) and a metric that reads a program counter over the window
(``readers.counter``; the counter stands in for one the program would
register, counting ``serve.prefill`` calls: the window's batches, not
set-up's warm-up)."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

DRIVE = """
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
from perfbench import run
if len(sys.argv) > 3:                 # count serve.prefill calls
    from repro_torch.launch import serve
    from repro_torch.obs.metrics import REGISTRY
    prefill, calls = serve.prefill, REGISTRY.counter(sys.argv[3])

    def counted(*a, **k):
        calls.inc()
        return prefill(*a, **k)
    serve.prefill = counted
bench, cell, config, mix = run.load_cell(sys.argv[2])
result, bad = run.run_cell(bench, cell, config, mix, 2 ** 40 + 3, 0.0, True,
                           device="cpu")
print(json.dumps(result))
"""

DENSE = '''"""Plain float32 dense transformer: pre-norm grouped-query attention
with RoPE and a SwiGLU MLP, each added to the residual."""
import torch

from .layers import logits, mm, rmsnorm, rope, silu

WHOLE_BATCH = False


def layer_layout(m):
    d, h, kv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    f = m["d_ff"]
    return {"norm1": ((d,), "ones"),
            "attn": {"wq": ((d, h, hd), d), "wk": ((d, kv, hd), d),
                     "wv": ((d, kv, hd), d), "wo": ((h, hd, d), h * hd)},
            "norm2": ((d,), "ones"),
            "mlp": {"w_in": ((d, f), d), "w_gate": ((d, f), d),
                    "w_out": ((f, d), f)}}


def forward(m, params, prompts, served, precision="fp32"):
    x = params["embed"][torch.cat([prompts, served[:, :-1]], 1).long()]
    x = x.float()
    b, s, _ = x.shape
    h, kv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    pos = torch.arange(s, device=x.device)
    causal = pos[:, None] >= pos[None, :]
    for i in range(m["n_layers"]):
        at = {k: v[i] for k, v in params["layers"]["attn"].items()}
        ml = {k: v[i] for k, v in params["layers"]["mlp"].items()}
        a = rmsnorm(x, params["layers"]["norm1"][i])
        q = rope(mm(a, at["wq"], precision), pos, m["rope_theta"])
        k = rope(mm(a, at["wk"], precision), pos, m["rope_theta"])
        v = mm(a, at["wv"], precision)
        q = q.reshape(b, s, kv, h // kv, hd)
        sc = torch.einsum("bskgd,btkd->bkgst", q, k) * hd ** -0.5
        w = torch.softmax(sc.masked_fill(~causal, float("-inf")), -1)
        o = torch.einsum("bkgst,btkd->bskgd", w, v).reshape(b, s, h, hd)
        x = x + mm(o, at["wo"], precision, contract=2)
        a = rmsnorm(x, params["layers"]["norm2"][i])
        gate = silu(mm(a, ml["w_gate"], precision)) * mm(a, ml["w_in"],
                                                           precision)
        x = x + mm(gate, ml["w_out"], precision)
    x = rmsnorm(x[:, prompts.shape[1] - 1:], params["final_norm"])
    return {"logits": logits(x, params["unembed"], m["vocab"], precision)}
'''

DENSE_TREE = DENSE + '''

def layout(m):
    from perfbench.lib import weights
    d = m["d_model"]
    one = layer_layout(m)
    one["norm1"] = ((d,), "ones", "float32")
    one["norm2"] = ((d,), "ones", "float32")
    return {**weights.ends(m), "final_norm": ((d,), "ones", "float32"),
            "layers": weights.stacked(one, m["n_layers"])}
'''

COUNTER = "perfbench_test_prefill_calls_total"
COUNTER_METRIC = f"""from perfbench.lib import readers


def read(run):
    return readers.counter(run, "{COUNTER}")
"""

SSM_MODEL = {"name": "tiny-ssm", "family": "ssm", "n_layers": 2,
             "d_model": 64, "n_heads": 0, "n_kv_heads": 0, "d_ff": 0,
             "vocab": 512, "ssm_state": 16, "ssm_headdim": 16,
             "ssm_expand": 2, "ssm_chunk": 16, "conv_width": 4,
             "tie_embeddings": True, "param_dtype": "bfloat16",
             "act_dtype": "bfloat16", "remat": "full", "optimizer": "adamw"}
DENSE_MODEL = {"name": "tiny-dense", "family": "dense", "n_layers": 2,
               "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
               "d_ff": 128, "vocab": 512, "rope_theta": 10000.0,
               "tie_embeddings": False, "param_dtype": "float32",
               "act_dtype": "float32", "attn_impl": "chunked",
               "optimizer": "adamw"}

DENSE_MIX = {"batch": 2, "prompt_len": 32, "gen": 4,
             "check": {"batches": 2, "rows": 2}}
CASES = {
    # (model, mix, limits, new files under perfbench/, counter read)
    "ssm": (SSM_MODEL, {"batch": 2, "prompt_len": 128, "gen": 1,
                        "check": {"batches": 1, "rows": 1}},
            {"token_gap": 0.5, "state_err": 0.2}, {}, None),
    "dense": (DENSE_MODEL, DENSE_MIX, {"token_gap": 1e-3},
              {"reference/dense.py": DENSE}, None),
    "dense-tree": (dict(DENSE_MODEL, name="tiny-dense-tree"), DENSE_MIX,
                   {"token_gap": 1e-3}, {"reference/dense.py": DENSE_TREE},
                   COUNTER),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cell_added_by_files_alone(tmp_path, case):
    model, mix, limits, files, counter = CASES[case]
    family = model["family"]
    config, traffic = model["name"], f"serve-{case}"
    workload = f"{config}.{traffic}"
    metric = f"rows_served.{traffic}"
    counted = f"prefill_calls.{traffic}"
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", copy / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    os.symlink(ROOT / "src", copy / "src")
    before = {p: p.read_bytes() for p in (copy / "perfbench").rglob("*")
              if p.is_file()}

    pb = copy / "perfbench"
    for name, text in files.items():
        assert not (pb / name).exists()
        (pb / name).write_text(text)
    (pb / "configs" / f"{config}.json").write_text(json.dumps(
        {"name": config, "source": "https://arxiv.org/abs/2405.21060",
         "reduced": [], "family": family, "model": model}))
    (pb / "traffic" / f"{traffic}.json").write_text(json.dumps(
        dict(mix, kind="serve", loop="closed", clients=1, ids="uniform")))
    (pb / "metrics" / f"{metric}.py").write_text(
        "def read(run):\n    return float(sum(b.rows for b in run.batches))\n")
    if counter:
        (pb / "metrics" / f"{counted}.py").write_text(COUNTER_METRIC)
    (pb / "limits" / f"{workload}.json").write_text(json.dumps(limits))
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": config, "source":
                             "https://arxiv.org/abs/2405.21060",
                             "file": f"perfbench/configs/{config}.json",
                             "reduced": [], "why": "a test's cell"})
    bench["workloads"].append({"name": workload, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "a test's cell"})
    bench["end_to_end"][[m["name"] for m in bench["end_to_end"]]
                        .index("prefill_tok_s")]["workloads"].append(workload)
    bench["per_layer"].append({"name": metric, "unit": "rows",
                               "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "prefill_tok_s",
                               "workloads": [workload]})
    if counter:
        bench["per_layer"].append(dict(bench["per_layer"][-1], name=counted,
                                       unit="calls"))
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", DRIVE, str(copy), workload]
                         + ([counter] if counter else []),
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(limits)
    rows = result["metrics"][metric]["value"]
    assert rows >= mix["batch"]
    if counter:                 # a prefill a batch, the warm-up left out
        assert result["metrics"][counted]["value"] == rows / mix["batch"]
    after = {p: p.read_bytes() for p in before}
    assert after == before          # no file of the benchmark was edited
