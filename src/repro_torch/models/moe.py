"""Mixture-of-Experts with sorting-network routing + prefix-sum dispatch
(``src/repro/models/moe.py``, on one device).

This layer is where the paper's two showcase instructions live in a
modern LM:

  * c5_topk — per-token expert selection is a key/payload bitonic network
    (K7 on CUDA tensors);
  * c3_prefixsum — the position-in-expert slot of every token is an
    exclusive prefix sum over assignment masks (K3 on CUDA tensors).

Two dispatch implementations:
  'dense'     — every expert on every token (oracle for tests; tiny
                configs);
  'ep' / 'tp' — capacity-bucketed top-k dispatch (:func:`_dispatch_combine`).
                The reference runs it under ``shard_map`` over a mesh; on
                one device its all_to_all and psum are identities, and this
                is what it computes there, with no EP or TP axis.

Fixed per-expert capacity (token dropping, standard), and a
dispatch-microbatch knob that bounds buffer memory.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

from .layers import gelu


def _route(cfg: ModelConfig, logits: torch.Tensor):
    """logits (t, E) fp32 → (gates (t,k) fp32, ids (t,k) int32, aux)."""
    vals, ids = kops.topk(logits, cfg.top_k)
    gates = torch.softmax(vals, dim=-1)
    # load-balance aux (Switch-style): E · Σ_e f_e · p_e
    probs = torch.softmax(logits, dim=-1)
    e = cfg.n_experts
    frac = F.one_hot(ids[:, 0].long(), e).float().mean(dim=0)
    aux = e * torch.sum(frac * probs.mean(dim=0))
    return gates, ids, aux


def _capacity(cfg: ModelConfig, tokens: int) -> int:
    c = math.ceil(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _slots(cfg: ModelConfig, ids: torch.Tensor, cap: int) -> torch.Tensor:
    """Position-in-expert via exclusive prefix sum (c3_prefixsum). The sums
    are of 0/1 values below 2**24, so they are exact in fp32."""
    flat = ids.reshape(-1).long()
    onehot = F.one_hot(flat, cfg.n_experts).float()               # (tk,E)
    # scan along the token axis, one row per expert → the carried-scan op
    exc = kops.exclusive_prefix_sum(onehot.T).T                   # (tk,E)
    slot = torch.gather(exc, 1, flat[:, None])[:, 0].to(torch.int32)
    valid = slot < cap
    dst = torch.where(valid, flat * cap + slot, cfg.n_experts * cap)
    return dst  # (tk,) flat (expert, slot) index; overflow row = E*cap


def _expert_ffn(cfg: ModelConfig, recv: torch.Tensor, w: dict):
    """recv (E, C, D) × expert weights → (E, C, D)."""
    h = torch.bmm(recv, w["w_in"])
    if cfg.mlp_gated:
        g = torch.bmm(recv, w["w_gate"])
        a = F.silu(g.float()).to(recv.dtype) * h
    else:
        a = gelu(h.float()).to(recv.dtype)
    return torch.bmm(a, w["w_out"])


def _moe_dense(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Oracle: compute every expert on every token (tiny configs only)."""
    b, s, d = x.shape
    toks = x.reshape(-1, d)
    logits = (toks @ p["router"]).float()
    gates, ids, aux = _route(cfg, logits)
    weights = torch.zeros_like(logits).scatter(1, ids.long(), gates)  # (t,E)
    h = torch.einsum("td,edf->tef", toks, p["w_in"])
    if cfg.mlp_gated:
        g = torch.einsum("td,edf->tef", toks, p["w_gate"])
        a = F.silu(g.float()).to(x.dtype) * h
    else:
        a = gelu(h.float()).to(x.dtype)
    y = torch.einsum("tef,efd->ted", a, p["w_out"])
    out = torch.einsum("ted,te->td", y, weights.to(x.dtype))
    return out.reshape(b, s, d), aux


def _dispatch_combine(cfg: ModelConfig, toks: torch.Tensor, p: dict):
    """Capacity-bucketed top-k dispatch for one token block. toks: (t, D).

    The scatter is ``index_add_``: every valid (expert, slot) row receives
    exactly one token, so its result does not depend on the order of the
    adds; only the dropped overflow row (E·cap) gathers several."""
    t, d = toks.shape
    logits = (toks @ p["router"]).float()
    gates, ids, aux = _route(cfg, logits)
    cap = _capacity(cfg, t)
    e = cfg.n_experts
    dst = _slots(cfg, ids, cap)

    rep = toks.repeat_interleave(cfg.top_k, dim=0)                # (tk, D)
    send = toks.new_zeros((e * cap + 1, d)).index_add_(0, dst, rep)
    recv = send[:e * cap].reshape(e, cap, d)

    ret = _expert_ffn(cfg, recv, p).reshape(e * cap, d)

    padded = torch.cat([ret, ret.new_zeros((1, d))], dim=0)
    gathered = padded[dst].reshape(t, cfg.top_k, d)
    comb = torch.sum(gathered.float() * gates[..., None], dim=1)  # (t, D)
    return comb.to(toks.dtype), aux


def moe_layer(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: (B, S, D) → (out (B,S,D), aux load-balance loss)."""
    if cfg.moe_impl == "dense":
        return _moe_dense(cfg, p, x)
    b, s, d = x.shape
    toks = x.reshape(-1, d)
    mb = cfg.dispatch_microbatch
    if mb > 1 and toks.shape[0] % mb == 0:
        # bound dispatch-buffer memory: one block of tokens at a time
        outs, auxs = zip(*(_dispatch_combine(cfg, blk, p)
                           for blk in toks.reshape(mb, -1, d)))
        out, aux = torch.cat(outs), torch.stack(auxs).mean()
    else:
        out, aux = _dispatch_combine(cfg, toks, p)
    return out.reshape(b, s, d), aux
