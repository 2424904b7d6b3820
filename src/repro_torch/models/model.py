"""The LM: blocks, the stack of layers, prefill and decode
(``src/repro/models/model.py``, serving side, on one device).

Params and caches are nested dicts of tensors in the reference's layout:
layer params stacked on a leading (L,) axis, the cache as
(L, B, T, KV, hd). The reference's ``lax.scan`` over layers is a Python
loop over the stacked leaves. :class:`LM` gives the functions an
``nn.Module`` face.

Not ported yet: the SSM and hybrid mixers (``models/ssm.py``, ROADMAP
Queue 1 item 13) and the training side (``loss_fn``, remat; item 14).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig

from . import attention as attn
from . import moe as moe_mod
from .layers import embed_tokens, mlp, rmsnorm, unembed
from .params import DTYPES, init_params, tree_map

_SSM_TODO = ("the {} family needs models/ssm.py, which is not ported yet "
             "(ROADMAP Queue 1 item 13)")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.has_ssm:
        raise NotImplementedError(_SSM_TODO.format(cfg.family))


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

def block(cfg: ModelConfig, p: dict, x: torch.Tensor, positions):
    """One transformer block. Returns (x, aux)."""
    _check_family(cfg)
    h = rmsnorm(x, p["norm1"])
    x = x + attn.attention(cfg, p["attn"], h, positions)
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
    _check_family(cfg)
    kv = (batch, attn.cache_len(cfg, seq_len), cfg.n_kv_heads, cfg.head_dim)
    dt = DTYPES[cfg.act_dtype]
    return {"k": (kv, dt), "v": (kv, dt)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device="cuda"):
    """Zero stacked (L, B, T, KV, hd) caches."""
    return {key: torch.zeros((cfg.n_layers,) + shape, dtype=dt, device=device)
            for key, (shape, dt) in
            _abstract_layer_cache(cfg, batch, seq_len).items()}


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
                  pos: int):
    h = rmsnorm(x, p["norm1"])
    a, nk, nv = attn.attention_decode(cfg, p["attn"], h, cache["k"],
                                      cache["v"], pos)
    x, _ = _ffn(cfg, p, x + a)
    return x, {"k": nk, "v": nv}


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int):
    """One serve step: tokens (B, 1) int, pos the current position.

    Returns (logits (B, vocab) fp32, cache). Each layer's new k and v are
    written into ``cache`` in place (see ``attention_decode``); the
    returned cache is the same dict."""
    _check_family(cfg)
    x = embed_tokens(params["embed"], tokens).to(DTYPES[cfg.act_dtype])
    for i in range(cfg.n_layers):
        x, _ = _block_decode(cfg, _layer(params["layers"], i), x,
                             _layer(cache, i), pos)
    x = rmsnorm(x, params["final_norm"])
    logits = unembed(_unembed_w(cfg, params), x[:, 0], cfg.vocab)
    return logits, cache


def _block_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor, positions):
    """block() that also emits the decode cache (no double compute)."""
    h = rmsnorm(x, p["norm1"])
    a, (k, v) = attn.attention(cfg, p["attn"], h, positions,
                               return_cache=True)
    x, _ = _ffn(cfg, p, x + a)
    return x, {"k": k, "v": v}


def prefill(cfg: ModelConfig, params: dict, batch: dict):
    """Full-sequence pass building the decode cache.

    Returns (last-position logits (B, vocab) fp32, stacked cache)."""
    _check_family(cfg)
    x = _embed(cfg, params, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    caches = []
    for i in range(cfg.n_layers):
        x, c = _block_prefill(cfg, _layer(params["layers"], i), x, positions)
        caches.append(c)
    cache = {key: torch.stack([c[key] for c in caches]) for key in ("k", "v")}
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
