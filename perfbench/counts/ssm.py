"""Model FLOPs of Mamba2 (SSD) requests, counted from a configuration's
``model`` block: the products of the chunked SSD algorithm as the paper
gives it, the causal half of each chunk's quadratic form, with the
projections and the logits; norms, gates and decays (elementwise work)
are not counted."""
from __future__ import annotations


def _widths(m: dict):
    d, n = m["d_model"], m["ssm_state"]
    din = m["ssm_expand"] * d
    return d, n, din, din // m["ssm_headdim"]


def dense_flops(m: dict) -> int:
    """One token's products outside the recurrence, a layer: the
    in-projections (z, x, B, C, dt), the convolution and the
    out-projection."""
    d, n, din, h = _widths(m)
    return (2 * d * (2 * din + 2 * n + h) + 2 * m["conv_width"] * (din + 2 * n)
            + 2 * din * d)


def prompt_token_flops(m: dict) -> float:
    """One prompt token's FLOPs, a layer: the dense products, the
    intra-chunk form (C B^T and its product with x over the causal half,
    (Q + 1) / 2 positions on average) and the chunk states in and out."""
    d, n, din, h = _widths(m)
    q = m["ssm_chunk"]
    return dense_flops(m) + 2 * (q + 1) / 2 * (n + din) + 4 * n * din


def step_token_flops(m: dict) -> int:
    """One decoded token's FLOPs, a layer: the dense products, the state
    update and the read-out."""
    d, n, din, h = _widths(m)
    return dense_flops(m) + 4 * n * din


def logits_flops(m: dict) -> int:
    return 2 * m["d_model"] * m["vocab"]


def request_flops(m: dict, rows: int, prompt_len: int, gen: int) -> float:
    """A batch of ``rows`` requests: the prompts, ``gen`` - 1 decoded
    tokens each and the logits of the ``gen`` served positions."""
    layers = m["n_layers"]
    per_row = (layers * (prompt_len * prompt_token_flops(m)
                         + (gen - 1) * step_token_flops(m))
               + gen * logits_flops(m))
    return rows * per_row


def train_flops(m: dict, rows: int, seq_len: int) -> float:
    """A training step of ``rows`` x ``seq_len`` tokens: the forward (every
    position's logits too) and the backward at twice the forward; remat's
    recomputed forward is not model work."""
    per_row = (m["n_layers"] * seq_len * prompt_token_flops(m)
               + seq_len * logits_flops(m))
    return 3 * rows * per_row
