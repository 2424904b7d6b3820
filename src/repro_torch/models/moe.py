"""Mixture-of-Experts with sorting-network routing + prefix-sum dispatch
(``src/repro/models/moe.py``).

This layer is where the paper's two showcase instructions live in a
modern LM:

  * c5_topk — per-token expert selection is a key/payload bitonic network
    (K7 on CUDA tensors);
  * c3_prefixsum — the position-in-expert slot of every token is an
    exclusive prefix sum over assignment masks (K3 on CUDA tensors).

Three dispatch implementations:
  'dense' — every expert on every token (oracle for tests; tiny configs);
  'ep'    — expert parallelism: capacity-bucketed all_to_all over the
            mesh's ``data`` ranks (E % data == 0; kimi-k2);
  'tp'    — experts whole over ``data``, each expert's FFN dim split
            over ``model`` (E % data != 0; grok-1), partial sums
            all-reduced over ``model``.
Both sharded ones are :func:`_dispatch_combine` on each rank's tokens
(:func:`_moe_sharded`, the reference's ``shard_map`` body as per-rank
code with explicit collectives). In the model's block (a
``sharding.ModelSplit`` given) the layer receives the tokens the block
entered with (under SP the gathered sequence) and leaves through the
block's exit, as the MLP does: the partial sums over ``model`` are
reduce-scattered over the sequence there (all-reduced without SP)
instead of all-reduced here. On one rank (no mesh) the port runs
:func:`_dispatch_combine` with no EP or TP group, as before (the
reference goes dense there): its all_to_all and all-reduce are
identities, and K7 and K3 stay on the one-device path.

Fixed per-expert capacity (token dropping, standard), and a
dispatch-microbatch knob that bounds buffer memory.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding
from repro_torch.kernels import ops as kops

from .layers import gelu


def _route(cfg: ModelConfig, logits: torch.Tensor, batch_group=None):
    """logits (t, E) fp32 → (gates (t,k) fp32, ids (t,k) int32, aux).
    With a ``batch_group`` (the ranks holding the other rows of the
    batch) the aux loss's token means are over all their tokens, so it is
    the unsharded model's."""
    vals, ids = kops.topk(logits, cfg.top_k)
    gates = torch.softmax(vals, dim=-1)
    # load-balance aux (Switch-style): E · Σ_e f_e · p_e
    probs = torch.softmax(logits, dim=-1)
    e = cfg.n_experts
    frac = F.one_hot(ids[:, 0].long(), e).float().mean(dim=0)
    mean_p = probs.mean(dim=0)
    if batch_group is not None:
        n = C.size(batch_group)
        frac = C.all_reduce(frac, batch_group) / n
        mean_p = C.all_reduce(mean_p, batch_group) / n
    aux = e * torch.sum(frac * mean_p)
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


def _dispatch_combine(cfg: ModelConfig, toks: torch.Tensor, p: dict,
                      ep_group=None, tp_group=None, n_ep: int = 1,
                      batch_group=None, reduce: bool = True):
    """Shared EP/TP dispatch for one token block. toks: (t, D) local.

    The scatter is ``index_add_``: every valid (expert, slot) row receives
    exactly one token, so its result does not depend on the order of the
    adds; only the dropped overflow row (E·cap) gathers several. Under EP
    the (E·cap, D) buffer goes to the experts' owners in one all_to_all
    (row block j, experts [j·E/n_ep, (j+1)·E/n_ep), to data rank j) and
    comes back in another; under TP the expert FFN gives partial sums
    over ``model``, all-reduced on the combined (t, D) (left partial when
    not ``reduce``)."""
    t, d = toks.shape
    logits = (toks @ p["router"]).float()
    gates, ids, aux = _route(cfg, logits, batch_group)
    cap = _capacity(cfg, t)
    e = cfg.n_experts
    dst = _slots(cfg, ids, cap)

    rep = toks.repeat_interleave(cfg.top_k, dim=0)                # (tk, D)
    send = toks.new_zeros((e * cap + 1, d)).index_add_(0, dst, rep)
    send = send[:e * cap]

    if ep_group is not None:                                      # EP a2a
        recv = C.all_to_all(send, ep_group)
        e_loc = e // n_ep
        recv = recv.reshape(n_ep, e_loc, cap, d).transpose(0, 1)
        recv = recv.reshape(e_loc, n_ep * cap, d)
    else:
        recv = send.reshape(e, cap, d)

    part = _expert_ffn(cfg, recv, p)                              # partial/f

    if ep_group is not None:
        e_loc = e // n_ep
        back = part.reshape(e_loc, n_ep, cap, d).transpose(0, 1)
        ret = C.all_to_all(back.reshape(e * cap, d), ep_group)
    else:
        ret = part.reshape(e * cap, d)

    padded = torch.cat([ret, ret.new_zeros((1, d))], dim=0)
    gathered = padded[dst].reshape(t, cfg.top_k, d)
    comb = torch.sum(gathered.float() * gates[..., None], dim=1)  # (t, D)
    if tp_group is not None and reduce:  # finish TP partial sums
        comb = C.all_reduce(comb, tp_group)
    return comb.to(toks.dtype), aux


def _blocks(cfg: ModelConfig, toks: torch.Tensor, fn):
    """``fn`` over ``toks`` in ``cfg.dispatch_microbatch`` blocks (a
    memory bound on the dispatch buffers) when they divide the tokens."""
    mb = cfg.dispatch_microbatch
    if mb > 1 and toks.shape[0] % mb == 0:
        outs, auxs = zip(*(fn(blk) for blk in
                           toks.reshape(mb, -1, toks.shape[1])))
        return torch.cat(outs), torch.stack(auxs).mean()
    return fn(toks)


def _moe_sharded(cfg: ModelConfig, p: dict, x: torch.Tensor, mesh,
                 use_ep: bool, specs: dict, reduce: bool = True):
    """The reference's ``shard_map`` body on this rank: ``x`` its rows
    (B_loc, S, D), ``p`` its shards of the layer's MoE leaves as
    ``specs`` (one layer's) place them. The router is gathered; each
    expert weight is resharded to experts over ``data`` under EP (whole
    under TP) and its FFN dim over ``model``. The aux loss averages its
    token statistics over the batch's ranks, where the reference keeps
    one rank's. Without ``reduce`` the output is left a partial sum over
    ``model``."""
    ep = "data" if use_ep else None
    tp = "model" if "model" in mesh.axis_names else None
    n_ep = mesh.shape["data"] if use_ep else 1
    want = {"router": (None, None), "w_in": (ep, None, tp),
            "w_out": (ep, tp, None)}
    if cfg.mlp_gated:
        want["w_gate"] = want["w_in"]
    p = {k: sharding.reshard(p[k], specs[k], want[k], mesh) for k in want}
    ep_group = mesh.group("data") if use_ep else None
    tp_group = mesh.group("model") if tp else None
    rows = mesh.group(tuple(a for a in ("pod", "data")
                            if a in mesh.axis_names))
    b_l, s, d = x.shape
    out, aux = _blocks(cfg, x.reshape(-1, d), lambda blk: _dispatch_combine(
        cfg, blk, p, ep_group, tp_group, n_ep, rows, reduce))
    return out.reshape(b_l, s, d), aux


def moe_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, tp=None):
    """x: (B, S, D) → (out (B,S,D), aux load-balance loss). On an active
    mesh (``sharding.use``): ``p`` holds this rank's shards, EP when the
    experts divide over ``data``, else TP. With ``tp`` (the block's
    ``sharding.ModelSplit``) the output leaves through ``tp.exit``: the
    model peers' partial sums reduced there, a whole output sliced to
    the rank's rows."""
    act = sharding.active()
    if act is not None:
        mesh, specs = act
        mspecs = {k: v[1:] for k, v in specs["layers"]["moe"].items()}
    if cfg.moe_impl == "dense":
        if act is not None:
            p = sharding.gather_tree(p, mspecs, mesh)
        out, aux = _moe_dense(cfg, p, x)
        return (out if tp is None else tp.exit(out, False)), aux
    if act is not None:
        use_ep = (cfg.moe_impl == "ep" and "data" in mesh.axis_names
                  and cfg.n_experts % mesh.shape["data"] == 0)
        out, aux = _moe_sharded(cfg, p, x, mesh, use_ep, mspecs,
                                reduce=tp is None)
        return (out if tp is None else tp.exit(out, True)), aux
    b, s, d = x.shape
    out, aux = _blocks(cfg, x.reshape(-1, d),
                       lambda blk: _dispatch_combine(cfg, blk, p))
    return out.reshape(b, s, d), aux
