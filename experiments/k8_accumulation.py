"""How K8's p·v accumulation sets its accuracy on the H100.

Builds variants of ``src/repro_torch/kernels/csrc/flashattn.cu`` in a
temporary directory and holds each against the float64 result with
chip_smoke.py's helpers, at the LM prefill's attention shape
(4, 64, 1024, 128) bf16 causal with unit-scale logits (q, k, v standard
normal):

* ``per k-step`` — the source as it is: each k-step's three wgmmas (16
  keys, p in three bf16 terms) go into a fresh accumulator that is then
  added to the output's in fp32;
* ``two terms`` — the same with p's third bf16 term zeroed;
* ``chained`` — the three terms' wgmmas accumulate straight into the
  output's accumulator over all keys (the tensor cores round each sum
  toward zero at the running total's magnitude).

For each, and for K8's fp32 FMA instance on the same values rounded to
bf16 (PR 13's arithmetic), it prints the elements beyond one bf16 ulp of
float64 beside the plain version's, the elements outside chip_smoke's
per-element bound, the elements further from float64 than the plain
version plus one bf16 ulp, and the device ms (``chip_smoke.time_ms``).
Needs the card, nvcc and the checkout's ``src``; run from the root of the
checkout:

    python3 experiments/k8_accumulation.py
"""
from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import flashattn as fa  # noqa: E402

SHAPE = (4, 64, 1024, 128)
SEEDS = (0, 1)
THIRD = "a3[r] = pack_bf16(x0, x1);"
FRESH = """      float t[D / NT][NT / 2];
#pragma unroll
      for (int n = 0; n < D / NT; ++n) {
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) t[n][i] = 0.f;
        fence_regs(t[n]);
      }
"""
ALIAS = """      float(&t)[D / NT][NT / 2] =
          *reinterpret_cast<float(*)[D / NT][NT / 2]>(acc);
#pragma unroll
      for (int n = 0; n < D / NT; ++n) fence_regs(t[n]);
"""
FIRST = "wgmma_pv<NT>(t[n], a1, bd, 0);"
ADD = ("#pragma unroll\n        for (int i = 0; i < NT / 2; ++i) "
       "acc[n * NT / 2 + i] += t[n][i];\n")


def variants(src: str) -> dict[str, str]:
    for piece in (THIRD, FRESH, FIRST, ADD):
        assert src.count(piece) == 1, piece
    chained = src.replace(FRESH, ALIAS).replace(FIRST, FIRST[:-3] + "1);")
    return {"per k-step": src,
            "two terms": src.replace(THIRD, "a3[r] = 0u;"),
            "chained": chained.replace(ADD, "")}


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    if not torch.cuda.is_available():
        print("k8_accumulation: needs a CUDA device", file=sys.stderr)
        return 1
    smoke = load_smoke()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    csrc = _cuda.CSRC
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_TORCH_BUILD_DIR"] = str(Path(tmp) / "build")
        for i, (name, text) in enumerate(
                variants((csrc / "flashattn.cu").read_text()).items()):
            d = Path(tmp) / f"csrc{i}"
            shutil.copytree(csrc, d)
            (d / "flashattn.cu").write_text(text)
            _cuda.CSRC = d
            _cuda._LOADED.pop("flashattn", None)
            libs[name] = _cuda.load("flashattn", fa._SIGNATURES)
            usage = _cuda.ptxas_usage(_cuda.BUILD_LOG["flashattn"]["ptxas"])
            print(name, "D=128:", [u for k, u in usage.items()
                                   if "wgmma" in k and "ILi128E" in k],
                  flush=True)
        _cuda.CSRC = csrc

        def k8(name, q, k, v):
            _cuda._LOADED["flashattn"] = libs[name]
            return fa.K8(q, k, v)

        for seed in SEEDS:
            rng = np.random.default_rng(seed)
            q, k, v = (torch.from_numpy(rng.standard_normal(
                SHAPE, dtype=np.float32)).to(dev, torch.bfloat16)
                for _ in range(3))
            plain = fa.flash_attention_plain(q, k, v)
            exact = smoke.exact_attention(q, k, v)[0]
            ulp = smoke.bf16_ulp(exact.float()).double()
            err_plain = (plain.double() - exact).abs()
            runs = {name: (lambda name=name: k8(name, q, k, v))
                    for name in libs}
            runs["fp32 FMA"] = lambda: fa.K8(q.float(), k.float(),
                                             v.float()).to(torch.bfloat16)
            for name, run in runs.items():
                out = run()
                res = smoke.attn_f64_misses(out, plain, q, k, v)
                worse = int(((out.double() - exact).abs()
                             > err_plain + ulp).sum())
                ms = smoke.time_ms(run)[0]
                print(f"seed {seed} {name}: {res['over_one_bf16_ulp_f64']} "
                      f"beyond one bf16 ulp of float64 (plain "
                      f"{res['plain_over_one_bf16_ulp_f64']}; alone "
                      f"{res['over_alone']} against {res['plain_over_alone']}"
                      f"), {res['outside_element_bound_f64']} outside the "
                      f"element bound, {worse} beyond plain's error + one "
                      f"ulp, {ms:.4f} ms", flush=True)
            del q, k, v, plain, exact, ulp, err_plain
        _cuda._LOADED.pop("flashattn", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
