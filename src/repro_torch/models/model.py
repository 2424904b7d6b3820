"""The LM: blocks, the stack of layers, the loss, prefill and decode
(``src/repro/models/model.py``).

On a mesh (:func:`repro_torch.distributed.sharding.use`) the params are
each rank's shards and the batch its rows. Every layer's leaves are
gathered over their FSDP axes as the walk reaches the layer
(:func:`_gathered`; the reference's "gathered per layer"), in the
forward, prefill, decode and remat's recompute; the dims the rules put
on ``model`` stay the rank's blocks, and the dense layers' compute is
split over ``model`` as the reference's partitioner splits it
(``sharding.ModelSplit``): attention on the rank's heads, the MLP on its
FFN columns, the SSM on its heads, the embedding, unembedding and loss
on its vocabulary block (``layers.embed_tokens``, ``vocab_logits``,
``cross_entropy_split``), each region entered and left through the
split's collectives. With ``cfg.sp`` and a sequence that divides
``model`` the residual between blocks is the rank's block of the
sequence (all-gather at each region's entry, reduce-scatter at its
exit); otherwise, and in decode (one position), it is whole on every
model peer and the exits all-reduce. A dim that does not divide
``model`` is whole and computed whole on every model peer. Prefill and
decode gather the last position's logits over ``model``. The MoE runs
expert- or tensor-parallel on its own shards (``moe.moe_layer``) and
leaves through the block's exit.

Params and caches are nested dicts of tensors in the reference's layout:
layer params stacked on a leading (L,) axis; the cache as (L, B, T, KV,
hd) ``k`` and ``v`` for attention, and for the SSM mixer its conv
windows ``conv: {x, B, C}`` (L, B, W-1, ·) in the activation dtype and
its ``state`` (L, B, H, P, N) in float32 (on a mesh, the rank's KV
heads, SSM heads and ``d_inner`` block). Every family is served: dense,
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
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding
from repro_torch.obs import trace as obs

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (cross_entropy, cross_entropy_split, embed_tokens, mlp,
                     rmsnorm, unembed, vocab_logits)
from .params import DTYPES, init_params, tree_map


def _layer(tree: dict, i: int) -> dict:
    """Layer i's params (or cache) from the stacked (L, ...) leaves."""
    return tree_map(lambda a: a[i], tree)


def _layer_specs(specs: dict) -> dict:
    """One layer's specs: the stacked leaves' specs without their
    (unsharded) ``layers`` dim."""
    return tree_map(lambda spec: spec[1:], specs)


def _keep(cfg: ModelConfig, lspecs: dict) -> dict:
    """One layer's leaves as the layer runs them on a mesh: each leaf's
    ``model`` part of its spec (``sharding.model_part``). The SSM splits
    by head, so when its heads stay whole its ``d_inner`` leaves are
    whole too."""
    keep = tree_map(sharding.model_part, lspecs)
    if "ssm" in keep and keep["ssm"]["A_log"] == (None,):
        keep["ssm"] = tree_map(lambda spec: (None,) * len(spec),
                               keep["ssm"])
    return keep


def _gathered(cfg: ModelConfig, fn):
    """``fn(p, ...)`` with the layer's params ``p`` gathered over their
    FSDP axes when a mesh is active (:func:`sharding.use`), each leaf
    keeping its ``model`` block (:func:`_keep`); the MoE's experts stay
    shards (``moe.moe_layer`` reshards them itself). Under remat the
    gather runs inside the recompute, and its backward (the
    reduce-scatter) once, in the recompute's backward."""
    act = sharding.active()
    if act is None:
        return fn
    mesh, specs = act
    lspecs = _layer_specs(specs["layers"])
    keep = _keep(cfg, lspecs)

    def run(p, *args):
        return fn(sharding.reshard_tree(p, lspecs, keep, mesh,
                                        skip=("moe",)), *args)
    return run


def _top(params: dict) -> dict:
    """The params with the embedding, final norm and unembedding gathered
    over their FSDP axes when a mesh is active (the layers stay shards):
    a vocabulary dim on ``model`` stays the rank's block."""
    act = sharding.active()
    if act is None:
        return params
    mesh, specs = act
    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = v
            continue
        vdim = {"embed": 0, "unembed": 1}.get(k)
        keep = tuple(e if d == vdim else None
                     for d, e in enumerate(sharding.model_part(specs[k])))
        out[k] = sharding.reshard(v, specs[k], keep, mesh)
    return out


def _vocab_start(cfg: ModelConfig, n: int, tp) -> int | None:
    """The first vocabulary row of the rank's block of ``n`` rows of the
    embedding (or columns of the unembedding), or None when the
    vocabulary is whole."""
    if tp is None or n == cfg.vocab_padded:
        return None
    return tp.index * n


def _layers(tree: dict, n: int) -> list[dict]:
    """Every layer's params as views of the stacked leaves, through one
    ``unbind`` a leaf: its backward stacks the layers' gradients once
    (indexing each layer would add a zero-filled stacked gradient per
    layer)."""
    split = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda parts: parts[i], split) for i in range(n)]


def _enter(tp, h: torch.Tensor) -> torch.Tensor:
    return h if tp is None else tp.enter(h)


def _exit(tp, y: torch.Tensor, partial: bool) -> torch.Tensor:
    return y if tp is None else tp.exit(y, partial)


def _ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, tp=None):
    """The block's second residual branch (dense MLP or MoE), if any,
    entered and left through ``tp`` (the pass's ``ModelSplit``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.d_ff or cfg.n_experts:
        h2 = _enter(tp, rmsnorm(x, p["norm2"]))
        if cfg.n_experts:
            y, aux = moe_mod.moe_layer(cfg, p["moe"], h2, tp)
        else:
            y = _exit(tp, mlp(p["mlp"], h2, cfg.mlp_gated),
                      p["mlp"]["w_in"].shape[-1] < cfg.d_ff)
        x = x + y
    return x, aux


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _mix_exit(tp, outs: list) -> torch.Tensor:
    """The mixer's (output, partial) pairs into the residual stream: one
    output through the exit; Hymba's two averaged, the partial ones
    reduced in one collective and the whole ones sliced."""
    if len(outs) == 1:
        return _exit(tp, *outs[0])
    (a, pa), (s, ps) = outs
    if pa == ps:
        return _exit(tp, (a + s) * 0.5, pa)
    return _exit(tp, a * 0.5, pa) + _exit(tp, s * 0.5, ps)


def _mixer(cfg: ModelConfig, p: dict, h: torch.Tensor, positions, tp,
           return_cache: bool = False):
    """The block's first residual branch on the entered ``h``: attention,
    SSM or both (Hymba), each as (output, partial over ``model``); with
    ``return_cache`` also the layer's decode cache."""
    outs, cache = [], {}
    if cfg.has_attention:
        split = p["attn"]["wq"].shape[1] < cfg.n_heads
        if return_cache:
            a, (cache["k"], cache["v"]) = attn.attention(
                cfg, p["attn"], h, positions, return_cache=True, tp=tp)
        else:
            a = attn.attention(cfg, p["attn"], h, positions, tp=tp)
        outs.append((a, split))
    if cfg.has_ssm:
        split = p["ssm"]["A_log"].shape[0] < cfg.ssm_heads
        if return_cache:
            s, (cache["state"], cache["conv"]) = ssm_mod.ssd_forward(
                cfg, p["ssm"], h, return_state=True, tp=tp)
        else:
            s = ssm_mod.ssd_forward(cfg, p["ssm"], h, tp=tp)
        outs.append((s, split))
    return outs, cache


def block(cfg: ModelConfig, p: dict, x: torch.Tensor, positions):
    """One transformer/ssm/hybrid block. Returns (x, aux). On a mesh with
    a ``model`` axis, ``x`` is the residual as the pass holds it (the
    rank's block of the sequence under SP) and ``positions`` the whole
    sequence's."""
    tp = sharding.model_split(positions.shape[-1], cfg.sp)
    h = _enter(tp, rmsnorm(x, p["norm1"]))
    outs, _ = _mixer(cfg, p, h, positions, tp)
    return _ffn(cfg, p, x + _mix_exit(tp, outs), tp)


# the non-batched matmuls: what ``dots_with_no_batch_dims_saveable`` keeps
# (an einsum with batch dims runs as bmm, whose output is recomputed)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn, layer: int = 0):
    """``fn`` under ``cfg.remat``: ``none`` keeps every activation;
    ``full`` saves only the block's inputs and recomputes the block in
    the backward (``nothing_saveable``); ``dots`` also saves the outputs
    of the non-batched matmuls (``dots_with_no_batch_dims_saveable``).
    The recompute runs under the dispatch mode of the forward: autograd
    runs a CUDA backward on a thread of its own, where the registry's
    thread-local mode would be the default. It is the span
    ``model.layer.recompute`` (attr ``layer``): the same wrapper runs
    the forward, outside any backward. Checkpoint stops a recompute by
    raising once the backward has its tensors back, so under a Tracer
    that span, and the ``ssm.ssd`` inside it, carry ``error:
    _StopRecomputationError``."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_dots)

    def rematerialised(*args):
        mode = isa.registry.mode

        def under_mode(*a):
            recompute = (obs.span("model.layer.recompute", layer=layer)
                         if torch._C._current_graph_task_id() != -1
                         else obs.NULL_SPAN)
            with isa.use(mode), recompute:
                return fn(*a)
        return _ckpt.checkpoint(under_mode, *args, use_reentrant=False, **kw)
    return rematerialised


def stack(cfg: ModelConfig, layer_params: dict, x: torch.Tensor, positions,
          train: bool = False):
    """The blocks in order, each the span ``model.layer`` (attr
    ``layer``); ``train`` rematerialises each by ``cfg.remat``."""
    fn = _gathered(cfg, functools.partial(block, cfg))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(_layers(layer_params, cfg.n_layers)):
        with obs.span("model.layer", layer=i):
            x, a = (_remat(cfg, fn, i) if train else fn)(p, x, positions)
        aux = aux + a
    return x, aux / cfg.n_layers


def _embed(cfg: ModelConfig, params: dict, batch: dict,
           tp=None) -> torch.Tensor:
    """The stack's input: the token embeddings (or the frontend's), as
    the pass's residual holds them (``tp``: the rank's rows of the
    sequence under SP; the vocabulary-split lookup's partial sums
    reduced)."""
    if "embeddings" in batch:            # stubbed VLM/audio frontend
        return _exit(tp, batch["embeddings"].to(DTYPES[cfg.act_dtype]),
                     False)
    v0 = _vocab_start(cfg, params["embed"].shape[0], tp)
    x = embed_tokens(params["embed"], batch["tokens"], v0)
    return _exit(tp, x.to(DTYPES[cfg.act_dtype]), v0 is not None)


def _split(cfg: ModelConfig, batch: dict):
    """The pass's ``ModelSplit`` for the batch's sequence, or None."""
    key = "embeddings" if "embeddings" in batch else "tokens"
    return sharding.model_split(batch[key].shape[1], cfg.sp)


def forward(cfg: ModelConfig, params: dict, batch: dict, train: bool = False):
    """The stack's final hidden states (B, S, D) and the MoE aux loss;
    ``train`` rematerialises each block by ``cfg.remat``."""
    tp = _split(cfg, batch)
    x, aux = _forward(cfg, _top(params), batch, train, tp)
    return _enter(tp, x), aux


def _forward(cfg: ModelConfig, params: dict, batch: dict, train: bool, tp):
    """:func:`forward` on params whose top leaves are gathered, its
    output as the residual holds it (``tp``)."""
    x, aux = _stacked(cfg, params, batch, train, tp)
    return rmsnorm(x, params["final_norm"]), aux


def _stacked(cfg: ModelConfig, params: dict, batch: dict, train: bool, tp):
    """The stack's output before the final norm, and the MoE aux loss."""
    x = _embed(cfg, params, batch, tp)
    s = batch["embeddings" if "embeddings" in batch else "tokens"].shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    return stack(cfg, params["layers"], x, positions, train)


def _unembed_w(cfg: ModelConfig, params: dict) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def _logits_ce(cfg: ModelConfig, w: torch.Tensor, x: torch.Tensor,
               targets: torch.Tensor, tp):
    """Unembed and cross-entropy of whole-sequence hidden states, on the
    rank's vocabulary block when it holds one."""
    v0 = _vocab_start(cfg, w.shape[1], tp)
    if v0 is None:
        return cross_entropy(unembed(w, x, cfg.vocab), targets)
    return cross_entropy_split(vocab_logits(w, x, cfg.vocab, v0), targets,
                               v0, tp.group)


def _last_logits(cfg: ModelConfig, params: dict, x: torch.Tensor,
                 tp) -> torch.Tensor:
    """(B, vocab) fp32 logits of the last position of ``x`` (the final
    hidden states as the residual holds them): under SP the last
    position is the last model rank's, gathered first; a vocabulary
    block's logits are gathered over ``model``."""
    if tp is not None and tp.sp:
        x = C.all_gather(x[:, -1:], tp.group, 1)
    w = _unembed_w(cfg, params)
    v0 = _vocab_start(cfg, w.shape[1], tp)
    if v0 is None:
        return unembed(w, x[:, -1], cfg.vocab)
    logits = vocab_logits(w, x[:, -1], cfg.vocab, v0)
    return C.all_gather(logits, tp.group, 1)[:, :cfg.vocab]


def _head_loss(cfg: ModelConfig, params: dict, x: torch.Tensor,
               targets: torch.Tensor, tp):
    """The CE (+ z-loss) of the final hidden states ``x``, whole or
    ``cfg.ce_chunk`` positions at a time: (loss, metrics {ce, z_loss})."""
    w = _unembed_w(cfg, params)
    s = x.shape[1]
    if not (cfg.ce_chunk and s % cfg.ce_chunk == 0):
        return _logits_ce(cfg, w, x, targets, tp)
    nc = s // cfg.ce_chunk
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, s, cfg.ce_chunk):
        l, _ = _logits_ce(cfg, w, x[:, c:c + cfg.ce_chunk],
                          targets[:, c:c + cfg.ce_chunk], tp)
        tot = tot + l
    loss = tot / nc
    return loss, {"ce": loss, "z_loss": torch.zeros_like(loss)}


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            aux_weight: float = 0.01):
    """Mean next-token cross-entropy (+ z-loss, + ``aux_weight`` × the
    MoE load-balance loss). Returns (loss, metrics {ce, z_loss, loss,
    moe_aux}). With ``cfg.ce_chunk`` dividing the sequence, the unembed
    and CE run chunk by chunk over the sequence (no (B, S, V) logits).
    On a mesh every model peer computes the loss of its rows, the
    hidden states gathered over the sequence under SP and the logits
    its vocabulary block's.

    The final norm, unembed and CE are the span ``model.head``; their
    backward, ``model.head.backward``."""
    params = _top(params)
    tp = _split(cfg, batch)
    x, aux = _stacked(cfg, params, batch, True, tp)
    back = obs.backward_span("model.head.backward")
    with obs.span("model.head"):
        if back is not None:
            x = back.enter(x)
        x = _enter(tp, rmsnorm(x, params["final_norm"]))
        loss, metrics = _head_loss(cfg, params, x, batch["targets"], tp)
        if back is not None:
            loss = back.leave(loss)
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


def port_cache_specs(cfg: ModelConfig, batch: int, seq_len: int,
                     mesh) -> dict:
    """The cache's specs on ``mesh`` as the port holds it at rest: a
    rank's rows (the batch dim's axes), its KV heads where they divide
    ``model`` and its SSM heads (``state``) and ``d_inner`` block (the
    ``conv`` window of ``x``) where the SSM splits (:func:`_keep`), whole
    along every other dim — what the split attention and SSM read and
    write. The reference puts ``cache_seq`` on ``model`` first; the port
    keeps the sequence whole (ROADMAP Queue 3: the same bytes a rank
    where the KV heads divide ``model``, the whole KV cache on every
    model peer where they do not)."""
    specs = sharding.tree_specs(cache_logical_axes(cfg),
                                abstract_cache(cfg, batch, seq_len), mesh,
                                {"cache_seq": [None]})
    if cfg.has_ssm and specs["state"][2] is None:   # the SSM runs whole
        specs["conv"]["x"] = specs["conv"]["B"]
    return specs


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
    the stacked leaves, which are updated in place. On a mesh the one
    position is whole on every model peer and each exit all-reduces."""
    tp = sharding.model_split(1, cfg.sp)
    h = rmsnorm(x, p["norm1"])
    outs = []
    if cfg.has_attention:
        a, _, _ = attn.attention_decode(cfg, p["attn"], h, cache["k"],
                                        cache["v"], pos, tp)
        outs.append((a, p["attn"]["wq"].shape[1] < cfg.n_heads))
    if cfg.has_ssm:
        s, conv, state = ssm_mod.ssd_decode(cfg, p["ssm"], h, cache["conv"],
                                            cache["state"], tp)
        for key, window in conv.items():
            cache["conv"][key].copy_(window)
        cache["state"].copy_(state)
        outs.append((s, p["ssm"]["A_log"].shape[0] < cfg.ssm_heads))
    x, _ = _ffn(cfg, p, x + _mix_exit(tp, outs), tp)
    return x


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int):
    """One serve step: tokens (B, 1) int, pos the current position.

    Returns (logits (B, vocab) fp32, cache). Each layer's new k and v,
    conv windows and SSM state are written into ``cache`` in place (the
    reference returns updated copies); the returned cache is the same
    dict."""
    params = _top(params)
    tp = sharding.model_split(1, cfg.sp)
    x = _embed(cfg, params, {"tokens": tokens}, tp)
    blk = _gathered(cfg, functools.partial(_block_decode, cfg))
    for i in range(cfg.n_layers):
        x = blk(_layer(params["layers"], i), x, _layer(cache, i), pos)
    x = rmsnorm(x, params["final_norm"])
    return _last_logits(cfg, params, x, tp), cache


def _block_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor, positions):
    """block() that also emits the decode cache (no double compute)."""
    tp = sharding.model_split(positions.shape[-1], cfg.sp)
    h = _enter(tp, rmsnorm(x, p["norm1"]))
    outs, cache = _mixer(cfg, p, h, positions, tp, return_cache=True)
    x, _ = _ffn(cfg, p, x + _mix_exit(tp, outs), tp)
    return x, cache


def prefill(cfg: ModelConfig, params: dict, batch: dict):
    """Full-sequence pass building the decode cache: the span
    ``model.prefill``, each block ``model.layer`` (attr ``layer``), the
    final norm and last logits ``model.head``.

    Returns (last-position logits (B, vocab) fp32, stacked cache)."""
    with obs.span("model.prefill"):
        return _prefill(cfg, params, batch)


def _prefill(cfg: ModelConfig, params: dict, batch: dict):
    params = _top(params)
    tp = _split(cfg, batch)
    x = _embed(cfg, params, batch, tp)
    s = batch["embeddings" if "embeddings" in batch else "tokens"].shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    caches = []
    blk = _gathered(cfg, functools.partial(_block_prefill, cfg))
    for i in range(cfg.n_layers):
        with obs.span("model.layer", layer=i):
            x, c = blk(_layer(params["layers"], i), x, positions)
        caches.append(c)
    cache = tree_map(lambda *leaves: torch.stack(leaves), *caches)
    with obs.span("model.head"):
        x = rmsnorm(x, params["final_norm"])
        return _last_logits(cfg, params, x, tp), cache


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
