"""Plain AdamW, global-norm clipping and the warmup-cosine schedule, in
float32, as a configuration's ``train`` block states them. Imports
nothing of the program.

The update of a leaf p with gradient g at step t (0-based), moments m,
v from zero:

    m = b1 m + (1 - b1) g;   v = b2 v + (1 - b2) g^2
    u = (m / (1 - b1^(t+1))) / (sqrt(v / (1 - b2^(t+1))) + eps) + wd p
    p = p - lr(t) u

with lr(t) rising linearly from 0 to ``lr`` over ``warmup`` steps, then
a cosine to ``floor`` x ``lr`` at ``total_steps``. The new p is stored in
the dtype of its leaf.
"""
from __future__ import annotations

import math

import torch


def lr_at(t: dict, step: int) -> float:
    if step < t["warmup"]:
        return t["lr"] * step / max(t["warmup"], 1)
    frac = min(max((step - t["warmup"]) / max(t["total_steps"] - t["warmup"],
                                              1), 0.0), 1.0)
    return t["lr"] * (t["floor"] + (1 - t["floor"]) * 0.5
                      * (1 + math.cos(math.pi * frac)))


def clip(grads: dict, max_norm: float) -> dict:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}


def step(t: dict, params: dict, grads: dict, state: dict, n: int,
         store) -> None:
    """One update of ``params`` (name → float32 values) in place; ``state``
    holds the moments; ``store(name, value)`` rounds a leaf's new value
    to the dtype it is stored in."""
    lr = lr_at(t, n)
    c1 = 1 - t["b1"] ** (n + 1)
    c2 = 1 - t["b2"] ** (n + 1)
    for k, p in params.items():
        g = grads[k]
        m, v = state.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
        m = t["b1"] * m + (1 - t["b1"]) * g
        v = t["b2"] * v + (1 - t["b2"]) * g * g
        state[k] = (m, v)
        u = (m / c1) / (torch.sqrt(v / c2) + t["eps"]) + t["weight_decay"] * p
        params[k] = store(k, p - lr * u)
