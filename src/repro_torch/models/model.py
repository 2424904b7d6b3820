"""The LM: blocks, the stack of layers, the loss, prefill and decode
(``src/repro/models/model.py``).

On a mesh (:func:`repro_torch.distributed.sharding.use`) the params are
each rank's shards and the batch its rows: every layer's leaves are
gathered as the walk reaches the layer (:func:`_gathered`; the
reference's FSDP, "gathered per layer"), in the forward, prefill, decode
and remat's recompute, and the MoE runs expert- or tensor-parallel on
its own shards (``moe.moe_layer``). Dense compute is not split over the
``model`` axis (ROADMAP Queue 1 step 6b), so the results are those of
the unsharded model on the rank's rows.

Params and caches are nested dicts of tensors in the reference's layout:
layer params stacked on a leading (L,) axis; the cache as (L, B, T, KV,
hd) ``k`` and ``v`` for attention, and for the SSM mixer its conv
windows ``conv: {x, B, C}`` (L, B, W-1, ·) in the activation dtype and
its ``state`` (L, B, H, P, N) in float32. Every family is served: dense,
MoE, ``ssm`` (Mamba2) and ``hybrid`` (Hymba: attention and SSM heads in
parallel, averaged). The reference's ``lax.scan`` over layers is a
Python loop over the stacked leaves. :class:`LM` gives the functions an
``nn.Module`` face.

Training: :func:`loss_fn` runs ``forward(train=True)``, where each block
is rematerialised by ``cfg.remat`` (:func:`_remat`, the counterparts of
the reference's ``jax.checkpoint`` policies), and is differentiated by
autograd. The instructions on its path carry their gradients on the
kernel path too (``kernels/ops.py``: K4 forward and its reverse walk, K7
with the scatter of ``lax.top_k``'s VJP); one without a backward raises
rather than drop a gradient (``core/isa.check_grad``).
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.core import isa
from repro_torch.distributed import sharding

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import cross_entropy, embed_tokens, mlp, rmsnorm, unembed
from .params import DTYPES, init_params, tree_map


def _layer(tree: dict, i: int) -> dict:
    """Layer i's params (or cache) from the stacked (L, ...) leaves."""
    return tree_map(lambda a: a[i], tree)


def _layer_specs(specs: dict) -> dict:
    """One layer's specs: the stacked leaves' specs without their
    (unsharded) ``layers`` dim."""
    return tree_map(lambda spec: spec[1:], specs)


def _gathered(fn):
    """``fn(p, ...)`` with the layer's params ``p`` gathered from their
    shards when a mesh is active (:func:`sharding.use`); the MoE's
    experts stay shards (``moe.moe_layer`` reshards them itself). Under
    remat the gather runs inside the recompute, and its backward (the
    reduce-scatter) once, in the recompute's backward."""
    act = sharding.active()
    if act is None:
        return fn
    mesh, specs = act
    lspecs = _layer_specs(specs["layers"])

    def run(p, *args):
        return fn(sharding.gather_tree(p, lspecs, mesh, skip=("moe",)),
                  *args)
    return run


def _top(params: dict) -> dict:
    """The params with the embedding, final norm and unembedding gathered
    when a mesh is active (the layers stay shards)."""
    act = sharding.active()
    if act is None:
        return params
    mesh, specs = act
    return {k: v if k == "layers" else sharding.gather(v, specs[k], mesh)
            for k, v in params.items()}


def _layers(tree: dict, n: int) -> list[dict]:
    """Every layer's params as views of the stacked leaves, through one
    ``unbind`` a leaf: its backward stacks the layers' gradients once
    (indexing each layer would add a zero-filled stacked gradient per
    layer)."""
    split = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda parts: parts[i], split) for i in range(n)]


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
    x, aux = _ffn(cfg, p, x)
    return sharding.constrain(x, _residual_axes(cfg)), aux


def _residual_axes(cfg: ModelConfig) -> tuple:
    return ("batch", "seq_sp" if cfg.sp else None, "act_embed")


# the non-batched matmuls: what ``dots_with_no_batch_dims_saveable`` keeps
# (an einsum with batch dims runs as bmm, whose output is recomputed)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat``: ``none`` keeps every activation;
    ``full`` saves only the block's inputs and recomputes the block in
    the backward (``nothing_saveable``); ``dots`` also saves the outputs
    of the non-batched matmuls (``dots_with_no_batch_dims_saveable``).
    The recompute runs under the dispatch mode of the forward: autograd
    runs a CUDA backward on a thread of its own, where the registry's
    thread-local mode would be the default."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_dots)

    def rematerialised(*args):
        mode = isa.registry.mode

        def under_mode(*a):
            with isa.use(mode):
                return fn(*a)
        return _ckpt.checkpoint(under_mode, *args, use_reentrant=False, **kw)
    return rematerialised


def stack(cfg: ModelConfig, layer_params: dict, x: torch.Tensor, positions,
          train: bool = False):
    fn = _gathered(functools.partial(block, cfg))
    if train:
        fn = _remat(cfg, fn)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in _layers(layer_params, cfg.n_layers):
        x, a = fn(p, x, positions)
        aux = aux + a
    return x, aux / cfg.n_layers


def _embed(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    if "embeddings" in batch:            # stubbed VLM/audio frontend
        x = batch["embeddings"].to(DTYPES[cfg.act_dtype])
    else:
        x = embed_tokens(params["embed"],
                         batch["tokens"]).to(DTYPES[cfg.act_dtype])
    return sharding.constrain(x, ("batch", None, "act_embed"))


def forward(cfg: ModelConfig, params: dict, batch: dict, train: bool = False):
    """The stack's final hidden states (B, S, D) and the MoE aux loss;
    ``train`` rematerialises each block by ``cfg.remat``."""
    return _forward(cfg, _top(params), batch, train)


def _forward(cfg: ModelConfig, params: dict, batch: dict, train: bool):
    """:func:`forward` on params whose top leaves are gathered."""
    x = _embed(cfg, params, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, aux = stack(cfg, params["layers"], x, positions, train)
    return rmsnorm(x, params["final_norm"]), aux


def _unembed_w(cfg: ModelConfig, params: dict) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            aux_weight: float = 0.01):
    """Mean next-token cross-entropy (+ z-loss, + ``aux_weight`` × the
    MoE load-balance loss). Returns (loss, metrics {ce, z_loss, loss,
    moe_aux}). With ``cfg.ce_chunk`` dividing the sequence, the unembed
    and CE run chunk by chunk over the sequence (no (B, S, V) logits)."""
    params = _top(params)
    x, aux = _forward(cfg, params, batch, train=True)
    w = _unembed_w(cfg, params)
    s = x.shape[1]
    if cfg.ce_chunk and s % cfg.ce_chunk == 0:
        nc = s // cfg.ce_chunk
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(0, s, cfg.ce_chunk):
            logits = unembed(w, x[:, c:c + cfg.ce_chunk], cfg.vocab)
            l, _ = cross_entropy(logits, batch["targets"][:, c:c + cfg.ce_chunk])
            tot = tot + l
        loss = tot / nc
        metrics = {"ce": loss, "z_loss": torch.zeros_like(loss)}
    else:
        logits = unembed(w, x, cfg.vocab)
        loss, metrics = cross_entropy(logits, batch["targets"])
    loss = loss + aux_weight * aux
    metrics.update(loss=loss, moe_aux=aux)
    return loss, metrics


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


def abstract_cache(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """The stacked (L, ...) cache's leaves as (shape, dtype)."""
    return tree_map(lambda leaf: ((cfg.n_layers,) + leaf[0], leaf[1]),
                    _abstract_layer_cache(cfg, batch, seq_len))


def cache_logical_axes(cfg: ModelConfig) -> dict:
    """The cache's logical dim names (the reference's)."""
    axes = {}
    if cfg.has_attention:
        kvax = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
        axes["k"] = kvax
        axes["v"] = kvax
    if cfg.has_ssm:
        axes["conv"] = {
            "x": ("layers", "batch", None, "ssm_inner"),
            "B": ("layers", "batch", None, None),
            "C": ("layers", "batch", None, None),
        }
        axes["state"] = ("layers", "batch", "ssm_heads", None, None)
    return axes


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device="cuda"):
    """Zero stacked (L, ...) caches of :func:`abstract_cache`."""
    return tree_map(lambda leaf: torch.zeros(leaf[0], dtype=leaf[1],
                                             device=device),
                    abstract_cache(cfg, batch, seq_len))


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
    params = _top(params)
    x = embed_tokens(params["embed"], tokens).to(DTYPES[cfg.act_dtype])
    blk = _gathered(functools.partial(_block_decode, cfg))
    for i in range(cfg.n_layers):
        x = blk(_layer(params["layers"], i), x, _layer(cache, i), pos)
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
    return sharding.constrain(x, _residual_axes(cfg)), cache


def prefill(cfg: ModelConfig, params: dict, batch: dict):
    """Full-sequence pass building the decode cache.

    Returns (last-position logits (B, vocab) fp32, stacked cache)."""
    params = _top(params)
    x = _embed(cfg, params, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    caches = []
    blk = _gathered(functools.partial(_block_prefill, cfg))
    for i in range(cfg.n_layers):
        x, c = blk(_layer(params["layers"], i), x, positions)
        caches.append(c)
    cache = tree_map(lambda *leaves: torch.stack(leaves), *caches)
    x = rmsnorm(x, params["final_norm"])
    logits = unembed(_unembed_w(cfg, params), x[:, -1], cfg.vocab)
    return logits, cache


# ---------------------------------------------------------------------------
# the nn.Module face
# ---------------------------------------------------------------------------

class _Tree(nn.Module):
    """A nested dict of tensors as (frozen) parameters (leaves) and
    submodules (sub-dicts), under the dict's own keys."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(
                    v, requires_grad=False))

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

    def forward(self, batch: dict, train: bool = False):
        return forward(self.cfg, self.params, batch, train)

    def prefill(self, batch: dict):
        return prefill(self.cfg, self.params, batch)

    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int):
        return decode_step(self.cfg, self.params, cache, tokens, pos)
