"""Batched serving: prefill a prompt batch, then decode tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch kimi-k2-1t \\
        --reduced --device cpu --batch 4 --prompt-len 64 --gen 32

The port of ``src/repro/launch/serve.py`` on one device: random params
from ``--seed``, random prompts from the same seed, a prefill that
builds the KV cache, the cache grown to prompt + gen positions, then a
decode loop (greedy at ``--temperature 0``). It runs on the GPU
(``--device cuda``, the default) or, at a small size, on the CPU. On
CUDA tensors the model's instructions launch their kernels (K7 top-k and
K3 prefix sum in the MoE router, and K8 attention where ``attn_impl`` is
``"kernel"``; this entry point keeps the reference's ``attn_impl="chunked"``).

The reference's scheduler, metrics, observability, SLO and region flags
are not accepted yet: they need ``sched/``, ``obs/`` and ``regions/``,
which are not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import model as M


def sample(logits: torch.Tensor, generator: torch.Generator | None,
           temperature: float) -> torch.Tensor:
    """(B, vocab) logits → (B, 1) int32 tokens: argmax at temperature 0,
    else a draw from softmax(logits / T) with ``generator``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params: dict, prompts: torch.Tensor, gen: int,
             temperature: float = 0.0,
             generator: torch.Generator | None = None):
    """Prefill ``prompts`` (B, P) int, then decode to ``gen`` new tokens
    per row. Returns (tokens (B, gen) int32, prefill seconds, decode
    seconds): host wall time, each ending in a synchronize on CUDA."""
    prompt_len = prompts.shape[1]
    capacity = prompt_len + gen
    t0 = time.perf_counter()
    logits, cache = M.prefill(cfg, params, {"tokens": prompts})
    cache = M.grow_cache(cfg, cache, prompt_len, capacity)
    tok = sample(logits, generator, temperature)
    _sync(prompts.device)
    t_prefill = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = M.decode_step(cfg, params, cache, tok, prompt_len + i)
        tok = sample(logits, generator, temperature)
        out.append(tok)
    _sync(prompts.device)
    return torch.cat(out, dim=1), t_prefill, time.perf_counter() - t0


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="llama3-8b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, attn_impl="chunked")
    device = torch.device(args.device)
    g = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init_params(cfg, g, device)
    prompts = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (args.batch, args.prompt_len))).to(device)

    gen, t_prefill, dt = generate(cfg, params, prompts, args.gen,
                                  args.temperature, g)
    print(f"prefill {args.batch}×{args.prompt_len} in "
          f"{t_prefill*1e3:.1f} ms "
          f"({args.batch*args.prompt_len/t_prefill:.0f} tok/s)")
    print(f"decoded {args.gen} tokens × batch {args.batch} in "
          f"{dt*1e3:.1f} ms ({args.batch*(args.gen-1)/max(dt,1e-9):.0f} tok/s)")
    gen = gen.cpu().numpy()
    print("sample row:", gen[0][:16], "...")
    return gen


if __name__ == "__main__":
    main()
