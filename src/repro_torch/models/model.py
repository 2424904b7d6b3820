"""The LM: blocks, the stack of layers, prefill and decode
(``src/repro/models/model.py``, serving side, on one device).

Params and caches are nested dicts of tensors in the reference's layout:
layer params stacked on a leading (L,) axis; the cache as (L, B, T, KV,
hd) ``k`` and ``v`` for attention, and for the SSM mixer its conv
windows ``conv: {x, B, C}`` (L, B, W-1, ·) in the activation dtype and
its ``state`` (L, B, H, P, N) in float32. Every family is served: dense,
MoE, ``ssm`` (Mamba2) and ``hybrid`` (Hymba: attention and SSM heads in
parallel, averaged). The reference's ``lax.scan`` over layers is a
Python loop over the stacked leaves. :class:`LM` gives the functions an
``nn.Module`` face.

Not ported yet: the training side (``loss_fn``, remat; ROADMAP Queue 1
item 14).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import embed_tokens, mlp, rmsnorm, unembed
from .params import DTYPES, init_params, tree_map


def _layer(tree: dict, i: int) -> dict:
    """Layer i's params (or cache) from the stacked (L, ...) leaves."""
    return tree_map(lambda a: a[i], tree)


def _ffn(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """The block's second residual branch (dense MLP or MoE), if any."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.d_ff or cfg.n_experts:
        h2 = rmsnorm(x, p["norm2"])
        if cfg.n_experts:
            y, aux = moe_mod.moe_layer(cfg, p["moe"], h2)
        else:
            y = mlp(p["mlp"], h2, cfg.mlp_gated)
        x = x + y
    return x, aux


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _mixer(cfg: ModelConfig, p: dict, h: torch.Tensor, positions):
    if cfg.family == "ssm":
        return ssm_mod.ssd_forward(cfg, p["ssm"], h)
    if cfg.family == "hybrid":  # Hymba: parallel attention + mamba heads
        a = attn.attention(cfg, p["attn"], h, positions)
        s = ssm_mod.ssd_forward(cfg, p["ssm"], h)
        return (a + s) * 0.5
    return attn.attention(cfg, p["attn"], h, positions)


def block(cfg: ModelConfig, p: dict, x: torch.Tensor, positions):
    """One transformer/ssm/hybrid block. Returns (x, aux)."""
    h = rmsnorm(x, p["norm1"])
    x = x + _mixer(cfg, p, h, positions)
    return _ffn(cfg, p, x)


def stack(cfg: ModelConfig, layer_params: dict, x: torch.Tensor, positions):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a = block(cfg, _layer(layer_params, i), x, positions)
        aux = aux + a
    return x, aux / cfg.n_layers


def _embed(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    if "embeddings" in batch:            # stubbed VLM/audio frontend
        return batch["embeddings"].to(DTYPES[cfg.act_dtype])
    return embed_tokens(params["embed"],
                        batch["tokens"]).to(DTYPES[cfg.act_dtype])


def forward(cfg: ModelConfig, params: dict, batch: dict, train: bool = False):
    """The stack's final hidden states (B, S, D) and the MoE aux loss."""
    if train:
        raise NotImplementedError("the training side (loss_fn, remat) is "
                                  "not ported yet (ROADMAP Queue 1 item 14)")
    x = _embed(cfg, params, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, aux = stack(cfg, params["layers"], x, positions)
    return rmsnorm(x, params["final_norm"]), aux


def _unembed_w(cfg: ModelConfig, params: dict) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def _abstract_layer_cache(cfg: ModelConfig, batch: int, seq_len: int):
    """One layer's cache leaves as (shape, dtype)."""
    dt = DTYPES[cfg.act_dtype]
    c = {}
    if cfg.has_attention:
        kv = (batch, attn.cache_len(cfg, seq_len), cfg.n_kv_heads,
              cfg.head_dim)
        c["k"] = (kv, dt)
        c["v"] = (kv, dt)
    if cfg.has_ssm:
        w = cfg.conv_width - 1
        c["conv"] = {"x": ((batch, w, cfg.d_inner), dt),
                     "B": ((batch, w, cfg.ssm_state), dt),
                     "C": ((batch, w, cfg.ssm_state), dt)}
        c["state"] = ((batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                      torch.float32)
    return c


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device="cuda"):
    """Zero stacked (L, ...) caches of :func:`_abstract_layer_cache`."""
    return tree_map(lambda leaf: torch.zeros((cfg.n_layers,) + leaf[0],
                                             dtype=leaf[1], device=device),
                    _abstract_layer_cache(cfg, batch, seq_len))


def grow_cache(cfg: ModelConfig, cache: dict, prefill_len: int,
               capacity: int) -> dict:
    """Make a prefill cache decodable up to `capacity` positions.

    Non-SWA: zero-pad the seq dim. SWA: the rolling cache is already at
    window size; rotate entries so absolute position p sits at slot
    p % window (the decode-side invariant)."""
    if not cfg.has_attention:
        return cache
    new = dict(cache)
    for key in ("k", "v"):
        c = cache[key]
        if cfg.swa_window:
            w = c.shape[-3]
            if prefill_len > w:
                c = torch.roll(c, shifts=prefill_len % w, dims=-3)
        else:
            pad = capacity - c.shape[-3]
            if pad > 0:
                c = torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad))
        new[key] = c
    return new


def _block_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                  pos: int) -> torch.Tensor:
    """One block of a decode step; ``cache`` holds the layer's views of
    the stacked leaves, which are updated in place."""
    h = rmsnorm(x, p["norm1"])
    outs = []
    if cfg.has_attention:
        a, _, _ = attn.attention_decode(cfg, p["attn"], h, cache["k"],
                                        cache["v"], pos)
        outs.append(a)
    if cfg.has_ssm:
        s, conv, state = ssm_mod.ssd_decode(cfg, p["ssm"], h, cache["conv"],
                                            cache["state"])
        for key, window in conv.items():
            cache["conv"][key].copy_(window)
        cache["state"].copy_(state)
        outs.append(s)
    mix = outs[0] if len(outs) == 1 else (outs[0] + outs[1]) * 0.5
    x, _ = _ffn(cfg, p, x + mix)
    return x


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int):
    """One serve step: tokens (B, 1) int, pos the current position.

    Returns (logits (B, vocab) fp32, cache). Each layer's new k and v,
    conv windows and SSM state are written into ``cache`` in place (the
    reference returns updated copies); the returned cache is the same
    dict."""
    x = embed_tokens(params["embed"], tokens).to(DTYPES[cfg.act_dtype])
    for i in range(cfg.n_layers):
        x = _block_decode(cfg, _layer(params["layers"], i), x,
                          _layer(cache, i), pos)
    x = rmsnorm(x, params["final_norm"])
    logits = unembed(_unembed_w(cfg, params), x[:, 0], cfg.vocab)
    return logits, cache


def _block_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor, positions):
    """block() that also emits the decode cache (no double compute)."""
    h = rmsnorm(x, p["norm1"])
    cache, outs = {}, []
    if cfg.has_attention:
        a, (k, v) = attn.attention(cfg, p["attn"], h, positions,
                                   return_cache=True)
        cache["k"], cache["v"] = k, v
        outs.append(a)
    if cfg.has_ssm:
        s, (state, conv) = ssm_mod.ssd_forward(cfg, p["ssm"], h,
                                               return_state=True)
        cache["conv"], cache["state"] = conv, state
        outs.append(s)
    mix = outs[0] if len(outs) == 1 else (outs[0] + outs[1]) * 0.5
    x, _ = _ffn(cfg, p, x + mix)
    return x, cache


def prefill(cfg: ModelConfig, params: dict, batch: dict):
    """Full-sequence pass building the decode cache.

    Returns (last-position logits (B, vocab) fp32, stacked cache)."""
    x = _embed(cfg, params, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    caches = []
    for i in range(cfg.n_layers):
        x, c = _block_prefill(cfg, _layer(params["layers"], i), x, positions)
        caches.append(c)
    cache = tree_map(lambda *leaves: torch.stack(leaves), *caches)
    x = rmsnorm(x, params["final_norm"])
    logits = unembed(_unembed_w(cfg, params), x[:, -1], cfg.vocab)
    return logits, cache


# ---------------------------------------------------------------------------
# the nn.Module face
# ---------------------------------------------------------------------------

class _Tree(nn.Module):
    """A nested dict of tensors as frozen parameters (leaves) and
    submodules (sub-dicts), under the dict's own keys."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def as_dict(self) -> dict:
        return {**self._parameters,
                **{k: m.as_dict() for k, m in self._modules.items()}}


class LM(_Tree):
    """A model of ``cfg`` holding its params. Its ``state_dict`` keys are
    the reference's tree paths joined by '.' (``layers.attn.wq``), so
    weights carried with ``params_from_numpy`` map onto it directly."""

    def __init__(self, cfg: ModelConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__(params if params is not None
                         else init_params(cfg, generator, device))
        self.cfg = cfg

    @property
    def params(self) -> dict:
        """The params as the nested dict the functions take."""
        return self.as_dict()

    def forward(self, batch: dict):
        return forward(self.cfg, self.params, batch)

    def prefill(self, batch: dict):
        return prefill(self.cfg, self.params, batch)

    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int):
        return decode_step(self.cfg, self.params, cache, tokens, pos)
