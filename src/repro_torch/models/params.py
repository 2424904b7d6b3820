"""Parameter specs: one source of truth for shapes and init.

``param_specs(cfg)`` returns a nested dict of :class:`ParamSpec`, the
reference's tree (``src/repro/models/params.py``) with the same shapes;
per-layer specs get a leading (L,) axis. From it come the real params
(:func:`init_params`) and the check of carried weights
(:func:`params_from_numpy`). Params are nested dicts of tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

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


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random params from ``generator`` (on ``device``), with the
    reference's laws: N(0, 0.02) for the embedding, N(0, fan_in^-1/2) for
    ``fanin`` leaves (fan_in = the second-to-last dim), ones and zeros.
    Each leaf is drawn in place in its own dtype, so a full-width init
    holds no fp32 temporary of an expert tensor. (torch's generator does
    not give JAX's numbers; tests carry JAX's weights over with
    :func:`params_from_numpy`.)"""
    def mk(spec: ParamSpec) -> torch.Tensor:
        t = torch.empty(spec.shape, dtype=_dtype(cfg, spec), device=device)
        if spec.init == "zeros":
            return t.zero_()
        if spec.init == "ones":
            return t.fill_(1)
        if spec.init == "fanin":
            fan = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            return t.normal_(0.0, fan ** -0.5, generator=generator)
        return t.normal_(0.0, 0.02, generator=generator)

    return tree_map(mk, param_specs(cfg))


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
