"""Attention: GQA/MQA/MHA with RoPE, qk_norm, SWA; three implementations
(``src/repro/models/attention.py``, on one device).

impl='full'     — paper baseline ("base ISA"): materialised logits.
impl='chunked'  — online softmax over q chunks in plain torch: the
                  flash-attention recurrence that the c6 kernel fuses;
                  bounds activation memory at long seq.
impl='kernel'   — the c6_flashattn instruction (K8 on CUDA tensors) in
                  prefill when there is no sliding window.

Decode: one new token against the KV cache (B, T, KV, hd); it launches
no kernel, in the reference either.

Under a split over ``model`` (``sharding.ModelSplit``) ``wq``/``wk``/
``wv`` hold the rank's heads (column-parallel) and ``wo`` its rows
(row-parallel), so the output is a partial sum over the model peers;
RoPE and ``q_norm``/``k_norm`` act on the local heads. When the query
heads split and the KV heads do not (fewer KV heads than ranks), the
rank's KV are whole and it reads the ones its query heads use
(:func:`_kv_for_q`). Both ``chunked`` and ``kernel`` run on the local
heads; the cache holds the rank's KV heads.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

from .layers import apply_rope, rmsnorm

NEG_INF = -1e30


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 positions: torch.Tensor):
    """x: (B, S, D) → q (B,S,H,hd), k/v (B,S,KV,hd), RoPE'd + qk-normed."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _kv_for_q(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor, h: int,
              tp) -> tuple[torch.Tensor, torch.Tensor]:
    """The KV heads (dim 2) that this rank's ``h`` query heads read. Only
    when the query heads are split and the KV heads whole does it select
    them: the heads of the rank's contiguous query block, as a narrow
    when each query group or each KV head falls in the block whole, else
    one KV head a query head."""
    if h == cfg.n_heads or k.shape[2] < cfg.n_kv_heads:
        return k, v
    g = cfg.n_heads // cfg.n_kv_heads
    lo = tp.index * h
    if h % g == 0:
        return k.narrow(2, lo // g, h // g), v.narrow(2, lo // g, h // g)
    if g % h == 0:
        return k.narrow(2, lo // g, 1), v.narrow(2, lo // g, 1)
    idx = torch.div(torch.arange(lo, lo + h, device=k.device), g,
                    rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


def _mask(q_pos, k_pos, window: int):
    """Additive mask from 1D position vectors — (len(q), len(k)) only."""
    m = q_pos[:, None] >= k_pos[None, :]
    if window:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return torch.where(m, 0.0, NEG_INF).float()


def _full_attn(cfg: ModelConfig, q, k, v, q_pos, k_pos):
    """Materialised-logits GQA attention. q:(B,S,H,hd) k/v:(B,T,KV,hd)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    logits = logits * hd ** -0.5
    logits = logits + _mask(q_pos, k_pos, cfg.swa_window)[None, None, None]
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", w.to(q.dtype), v)
    return o.reshape(b, s, h, hd)


def _chunked_attn(cfg: ModelConfig, q, k, v, q_pos, k_pos):
    """Online-softmax over q chunks: O(chunk·T) live logits."""
    b, s, h, hd = q.shape
    if cfg.attn_flat_heads:
        k = k.repeat_interleave(h // k.shape[2], dim=2)
        v = v.repeat_interleave(h // v.shape[2], dim=2)
    kvh = k.shape[2]
    g = h // kvh
    c = min(cfg.attn_chunk, s)
    pad = (-s) % c
    if pad:  # pad the q side only (k/v untouched); slice output back
        q = torch.cat([q, q.new_zeros((b, pad) + q.shape[2:])], dim=1)
        q_pos = torch.cat([q_pos, q_pos[-1:].expand(pad)])
    sq = s + pad
    qg = q.reshape(b, sq // c, c, kvh, g, hd)
    qp = q_pos.reshape(sq // c, c)
    outs = []
    for i in range(sq // c):
        logits = torch.einsum("bckgd,btkd->bkgct", qg[:, i], k).float()
        logits = logits * hd ** -0.5
        logits = logits + _mask(qp[i], k_pos,
                                cfg.swa_window)[None, None, None]
        w = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bkgct,btkd->bckgd", w.to(q.dtype), v))
    o = torch.stack(outs, dim=1).reshape(b, sq, h, hd)
    return o[:, :s]


def attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
              positions: torch.Tensor, return_cache: bool = False,
              tp=None):
    """Training / prefill self-attention. Returns (B, S, D), a partial
    sum over the model peers when the heads are split (``tp``: the
    pass's ``ModelSplit``), (+ the rolled (k, v) decode cache of the
    rank's KV heads when return_cache)."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    ks, vs = _kv_for_q(cfg, k, v, q.shape[2], tp)
    if cfg.attn_impl == "kernel" and not cfg.swa_window:
        kvh, h = ks.shape[2], q.shape[2]
        kk = ks.repeat_interleave(h // kvh, dim=2)
        vv = vs.repeat_interleave(h // kvh, dim=2)
        o = kops.flash_attention(
            q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
            causal=True).transpose(1, 2)
    elif cfg.attn_impl == "chunked" or cfg.attn_impl == "kernel":
        o = _chunked_attn(cfg, q, ks, vs, positions, positions)
    else:
        o = _full_attn(cfg, q, ks, vs, positions, positions)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    if return_cache:
        t = cache_len(cfg, q.shape[1])
        return out, (k[:, -t:], v[:, -t:])
    return out


# ---------------------------------------------------------------------------
# decode (single-token serve step)
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Rolling window for SWA archs; full seq otherwise."""
    return min(seq_len, cfg.swa_window) if cfg.swa_window else seq_len


def attention_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int,
                     tp=None):
    """x: (B, 1, D); caches (B, T, KV, hd); pos: the current position.

    Returns (out (B,1,D), k_cache, v_cache). The new token's k and v are
    written into the caches IN PLACE (the reference returns updated
    copies); the returned caches are the same tensors."""
    b = x.shape[0]
    t = k_cache.shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)

    slot = pos % t if cfg.swa_window else pos
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]

    kc, vc = _kv_for_q(cfg, k_cache, v_cache, q.shape[2], tp)
    h, kvh, hd = q.shape[2], kc.shape[2], q.shape[3]
    g = h // kvh
    qg = q.reshape(b, kvh, g, hd)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, kc).float()
    logits = logits * hd ** -0.5

    slot_idx = torch.arange(t, device=x.device)[None, :]    # (1, T)
    valid = slot_idx <= (min(pos, t - 1) if cfg.swa_window else pos)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", w.to(x.dtype), vc)
    o = o.reshape(b, 1, h, hd)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, k_cache, v_cache
