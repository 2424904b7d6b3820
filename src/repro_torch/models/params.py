"""Parameter specs: one source of truth for shapes and init.

``param_specs(cfg)`` returns a nested dict of :class:`ParamSpec`, the
reference's tree (``src/repro/models/params.py``) with the same shapes;
per-layer specs get a leading (L,) axis. From it come the real params
(:func:`init_params`) and the check of carried weights
(:func:`params_from_numpy`). Params are nested dicts of tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (local_shape, local_shard,
                                              shard_rows, spec_axes)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    logical: tuple
    init: str = "normal"        # normal | zeros | ones | fanin
    dtype: Optional[str] = None


def _attn_specs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, h, hd), ("embed", "q_heads", "head_dim"), "fanin"),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"), "fanin"),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"), "fanin"),
        "wo": ParamSpec((h, hd, d), ("q_heads", "head_dim", "embed"), "fanin"),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
        s["k_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
    return s


def _mlp_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    s = {
        "w_in": ParamSpec((d, f), ("embed", "ffn"), "fanin"),
        "w_out": ParamSpec((f, d), ("ffn", "embed"), "fanin"),
    }
    if cfg.mlp_gated:
        s["w_gate"] = ParamSpec((d, f), ("embed", "ffn"), "fanin")
    return s


def _moe_specs(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    s = {
        "router": ParamSpec((d, e), ("embed", None), "fanin"),
        "w_in": ParamSpec((e, d, f), ("experts", "embed", "expert_ffn"), "fanin"),
        "w_out": ParamSpec((e, f, d), ("experts", "expert_ffn", "embed"), "fanin"),
    }
    if cfg.mlp_gated:
        s["w_gate"] = ParamSpec((e, d, f),
                                ("experts", "embed", "expert_ffn"), "fanin")
    return s


def _ssm_specs(cfg: ModelConfig) -> dict:
    d, din, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.conv_width
    return {
        "w_z": ParamSpec((d, din), ("embed", "ssm_inner"), "fanin"),
        "w_x": ParamSpec((d, din), ("embed", "ssm_inner"), "fanin"),
        "w_B": ParamSpec((d, n), ("embed", None), "fanin"),
        "w_C": ParamSpec((d, n), ("embed", None), "fanin"),
        "w_dt": ParamSpec((d, h), ("embed", "ssm_heads"), "fanin"),
        "conv_x": ParamSpec((w, din), (None, "ssm_inner"), "fanin"),
        "conv_B": ParamSpec((w, n), (None, None), "fanin"),
        "conv_C": ParamSpec((w, n), (None, None), "fanin"),
        "A_log": ParamSpec((h,), ("ssm_heads",), "ones"),
        "D": ParamSpec((h,), ("ssm_heads",), "ones"),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), "zeros"),
        "norm": ParamSpec((din,), ("ssm_inner",), "ones"),
        "out_proj": ParamSpec((din, d), ("ssm_inner", "embed"), "fanin"),
    }


def layer_specs(cfg: ModelConfig) -> dict:
    s: dict = {"norm1": ParamSpec((cfg.d_model,), ("embed_nofsdp",), "ones")}
    if cfg.has_attention:
        s["attn"] = _attn_specs(cfg)
    if cfg.has_ssm:
        s["ssm"] = _ssm_specs(cfg)
    if cfg.d_ff or cfg.n_experts:
        s["norm2"] = ParamSpec((cfg.d_model,), ("embed_nofsdp",), "ones")
    if cfg.d_ff:
        s["mlp"] = _mlp_specs(cfg)
    if cfg.n_experts:
        s["moe"] = _moe_specs(cfg)
    return s


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest``: trees of the same
    structure, passed alongside)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_items(tree, prefix: str = ""):
    """(path joined by '.', leaf) pairs in the tree's order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_items(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def param_specs(cfg: ModelConfig) -> dict:
    def stack(spec: ParamSpec) -> ParamSpec:
        return ParamSpec((cfg.n_layers,) + spec.shape,
                         ("layers",) + spec.logical, spec.init, spec.dtype)

    emb_ax = (("vocab_tbl", "embed_tbl") if cfg.embed_gather_local
              else ("vocab", "embed"))
    specs = {
        "embed": ParamSpec((cfg.vocab_padded, cfg.d_model),
                           emb_ax, "normal"),
        "layers": tree_map(stack, layer_specs(cfg)),
        "final_norm": ParamSpec((cfg.d_model,), ("embed_nofsdp",), "ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_padded),
                                     ("embed", "vocab"), "fanin")
    return specs


def _dtype(cfg: ModelConfig, spec: ParamSpec) -> torch.dtype:
    return DTYPES[spec.dtype or cfg.param_dtype]


def logical_axes(cfg: ModelConfig) -> dict:
    """The param tree's logical dim names (what the sharding rules read)."""
    return tree_map(lambda s: s.logical, param_specs(cfg))


def abstract_params(cfg: ModelConfig) -> dict:
    """The param tree's leaves as (shape, dtype)."""
    return tree_map(lambda s: (s.shape, _dtype(cfg, s)), param_specs(cfg))


#: elements a block of :func:`init_params` draws at most (a block is at
#: least one row of its leaf's first non-``layers`` axis)
INIT_BLOCK = 1 << 22


def _block_seed(seed: int, leaf: int, block: int) -> int:
    return int(np.random.SeedSequence([seed, leaf, block]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _draw(cfg: ModelConfig, spec: ParamSpec, index: int, seed: int,
          device, shard=None, mesh=None) -> torch.Tensor:
    """Leaf ``index`` of the param tree (or, with ``shard`` and ``mesh``,
    this rank's block of it). Each layer of a stacked leaf is drawn in
    fixed blocks of rows along its first non-``layers`` axis, each block
    from a generator of its own seeded from (seed, leaf, block), so a
    shard's values do not depend on the mesh."""
    dtype = _dtype(cfg, spec)
    shape = spec.shape
    shard = shard or (None,) * len(shape)
    local = shape if mesh is None else local_shape(shape, shard, mesh)
    out = torch.empty(local, dtype=dtype, device=device)
    if spec.init == "zeros":
        return out.zero_()
    if spec.init == "ones":
        return out.fill_(1)
    std = 0.02
    if spec.init == "fanin":
        std = (shape[-2] if len(shape) >= 2 else shape[-1]) ** -0.5
    stacked = spec.logical[0] == "layers"
    lead = 1 if stacked else 0                  # leading (layers) dims
    n_layers = shape[0] if stacked else 1
    if lead >= len(shape):                      # a (L,) leaf: a block a layer
        rows, row_shape, entry = 1, (), None
    else:
        rows, row_shape, entry = shape[lead], shape[lead + 1:], shard[lead]
    per = max(1, -(-INIT_BLOCK // max(1, math.prod(row_shape))))
    n_blocks = -(-rows // per)
    r0, rn = (0, rows) if mesh is None else shard_rows(rows, entry, mesh)
    rest = shard[lead + 1:]
    sliced = mesh is not None and any(spec_axes(e) for e in rest)
    gen = torch.Generator(device=device)
    for layer in range(n_layers):
        dst = out[layer] if stacked else out
        for b in range(n_blocks):
            lo, hi = b * per, min(rows, (b + 1) * per)
            a, z = max(lo, r0), min(hi, r0 + rn)
            if a >= z:
                continue
            gen.manual_seed(_block_seed(seed, index, layer * n_blocks + b))
            if lead >= len(shape):
                dst.normal_(0.0, std, generator=gen)
                continue
            if (a, z) == (lo, hi) and not sliced:   # in place, no temporary
                dst[a - r0:z - r0].normal_(0.0, std, generator=gen)
                continue
            blk = torch.empty((hi - lo,) + row_shape, dtype=dtype,
                              device=device).normal_(0.0, std, generator=gen)
            blk = blk[a - lo:z - lo]
            if sliced:
                blk = local_shard(blk, (None,) + tuple(rest), mesh)
            dst[a - r0:z - r0].copy_(blk)
    return out


def draw_leaf(cfg: ModelConfig, path: str, seed: int, device="cuda",
              shard=None, mesh=None) -> torch.Tensor:
    """Leaf ``path`` (dotted, e.g. ``"layers.moe.w_in"``) of the param
    tree as :func:`init_params` makes it from ``seed``; with ``shard``
    (its spec) and ``mesh``, this rank's shard of it."""
    specs = dict(tree_items(param_specs(cfg)))
    return _draw(cfg, specs[path], sorted(specs).index(path), seed, device,
                 shard, mesh)


def init_params(cfg: ModelConfig, generator: torch.Generator | None,
                device="cuda", mesh=None, specs: dict | None = None) -> dict:
    """Random params seeded by ``generator``'s seed (on ``device``), with
    the reference's laws: N(0, 0.02) for the embedding, N(0, fan_in^-1/2)
    for ``fanin`` leaves (fan_in = the second-to-last dim), ones and
    zeros. With a ``mesh`` and the param tree's ``specs`` each rank makes
    only its shard, and the values are the same as on a world of one:
    each leaf is drawn in blocks (:func:`_draw`), in its own dtype, so a
    full-width init holds no fp32 temporary of an expert tensor.
    :func:`draw_leaf` makes one leaf alone. (torch's generator does not
    give JAX's numbers; tests carry JAX's weights over with
    :func:`params_from_numpy`.)"""
    seed = (generator.initial_seed() if generator is not None
            else torch.initial_seed())

    def build(sub, shards, prefix=""):
        return {k: (build(v, shards and shards[k], f"{prefix}{k}.")
                    if isinstance(v, dict) else
                    draw_leaf(cfg, prefix + k, seed, device,
                              shards[k] if shards else None, mesh))
                for k, v in sub.items()}
    return build(param_specs(cfg), specs if mesh is not None else None)


def tensor_from_numpy(arr) -> torch.Tensor:
    arr = np.array(arr)             # a writable copy (JAX's are read-only)
    # bf16 leaves arrive as numpy arrays of JAX's bfloat16 extension
    # dtype, which torch cannot read: carry their bits
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    """The port's params from the JAX package's (nested dicts of numpy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``), bit for bit.
    Raises if the tree, a shape or a dtype differs from
    :func:`param_specs`."""
    specs = param_specs(cfg)
    want = sorted(path for path, _ in tree_items(specs))
    got = sorted(path for path, _ in tree_items(tree))
    if got != want:
        raise ValueError(f"param tree differs: got {got}, want {want}")

    def carry(spec: ParamSpec, arr) -> torch.Tensor:
        t = tensor_from_numpy(arr)
        if tuple(t.shape) != spec.shape or t.dtype != _dtype(cfg, spec):
            raise ValueError(f"leaf {tuple(t.shape)} {t.dtype} != spec "
                             f"{spec.shape} {_dtype(cfg, spec)}")
        return t.to(device)

    return tree_map(carry, specs, tree)


def shard_from_numpy(tree: dict, specs: dict, mesh, device="cuda") -> dict:
    """This rank's shards (per ``specs`` on ``mesh``) of a tree of numpy
    arrays (params, or a whole train state), bit for bit."""
    def one(arr, spec):
        return local_shard(tensor_from_numpy(arr), spec, mesh).contiguous() \
            .to(device)
    return tree_map(lambda spec, arr: one(arr, spec), specs, tree)
