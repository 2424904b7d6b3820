"""Mamba2 / SSD mixer — the paper's carried prefix scan inside a modern LM
(``src/repro/models/ssm.py``, on one device).

The chunked SSD algorithm (Dao & Gu, 2024) splits the sequence into
chunks: a quadratic intra-chunk term plus an inter-chunk *state
recurrence* ``running[c] = a_chunk[c] · running[c-1] + S_c``. That
recurrence is the c4_statescan instruction: K4's state-scan entry on CUDA
tensors (it reads the (B, C, H, P, N) states where they lie), the torch
oracle on CPU tensors, and K4's plain walk under ``interpret``.

Decode is O(1): a (B, H, P, N) state update per token.

Under a split over ``model`` (``sharding.ModelSplit``) the rank holds
its SSM heads: ``w_z``, ``w_x``, ``w_dt``, ``conv_x``, ``A_log``, ``D``,
``dt_bias``, ``norm`` and ``out_proj`` follow ``ssm_inner`` /
``ssm_heads``, and K4 scans the rank's heads; ``w_B``, ``w_C``,
``conv_B`` and ``conv_C`` are whole and run on every model peer. The
gated RMSNorm over ``d_inner`` sums its squares over the model peers
(:func:`_gated_norm`), and ``out_proj`` is row-parallel, so the output
is a partial sum over them. The reference's ``preferred_element_type=float32`` products on bf16
operands (``ssd_bf16``) become float32 products of the operands cast to
float32, which is exact. Without grad (serving) the chunk output (the
intra-chunk term, the inter-chunk term and the D skip) is one launch of
the SSD chunk-output kernel on CUDA tensors (``kernels/ssd_chunk.py``;
its plain version under ``interpret``), the (B, C, Q, Q, H) weights
kept in registers. Where the kernel's shape rule declines a call (counted
in ``SSD_CHUNK.declined``), under ``ssd_bf16`` and under ``ref``, the
eager chain builds those tensors in place, one at a time: at
Mamba2-1.3B's widths and 4 × 8192 tokens each is 2.15 GB in float32.
Under grad (training) the same eager ops run out of place, with the
same values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import isa
from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.obs import trace as obs

from .layers import rmsnorm


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 cache: torch.Tensor | None = None):
    """Depthwise causal conv along seq. x: (B,S,C); w: (W,C).

    With cache (B, W-1, C) (decode), returns (y, new_cache)."""
    width = w.shape[0]
    if cache is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
        xp = torch.cat([pad, x], dim=1)
        new_cache = xp[:, -(width - 1):, :] if width > 1 else None
    else:
        xp = torch.cat([cache, x], dim=1)
        new_cache = xp[:, -(width - 1):, :]
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(width))
    return F.silu(y.float()).to(x.dtype), new_cache


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _proj(cfg: ModelConfig, p: dict, u: torch.Tensor):
    """u: (B,S,D) → z,x,(B,S,din), Bc,Cc (B,S,N), dt (B,S,H)."""
    z = torch.einsum("bsd,de->bse", u, p["w_z"])
    x = torch.einsum("bsd,de->bse", u, p["w_x"])
    bc = torch.einsum("bsd,dn->bsn", u, p["w_B"])
    cc = torch.einsum("bsd,dn->bsn", u, p["w_C"])
    dt = torch.einsum("bsd,dh->bsh", u, p["w_dt"])
    dt = _softplus(dt.float() + p["dt_bias"].float())
    return z, x, bc, cc, dt


def _gated_norm(cfg: ModelConfig, p: dict, y: torch.Tensor,
                z: torch.Tensor, tp, eps: float = 1e-6) -> torch.Tensor:
    """rmsnorm(y · silu(z)) over ``d_inner``; with the rank holding a
    block of ``d_inner``, the sum of squares is all-reduced over the
    model peers (its backward sums their cotangents)."""
    g = y * F.silu(z.float()).to(y.dtype)
    if g.shape[-1] == cfg.d_inner:
        return rmsnorm(g, p["norm"], eps)
    xf = g.float()
    ss = C.all_reduce(torch.sum(xf * xf, dim=-1, keepdim=True), tp.group)
    out = xf * torch.rsqrt(ss / cfg.d_inner + eps)
    return (out * p["norm"].float()).to(g.dtype)


def _intra_eager(ccc, bcc, xc, dtc, cum, cdt, tracked: bool):
    """The eager chain's intra-chunk term (B, C, Q, H, P) in float32.

    The reference's double where: the upper triangle of seg is zeroed
    before exp, so exp never sees its large positive values, then the
    decay is zeroed there. Two forms of the same ops in the same order,
    so the same bits: in place without grad (one (B,C,Q,Q,H) tensor
    alive at a time), out of place under grad (``tracked``), where
    autograd keeps what exp and the products saved."""
    q = cum.shape[2]
    upper = ~torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=cum.device))[None, None, :, :, None]
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # i-j
    if tracked:
        decay = decay.masked_fill(upper, 0.0).exp().masked_fill(upper, 0.0)
    else:
        decay.masked_fill_(upper, 0.0).exp_().masked_fill_(upper, 0.0)
    decay = decay.to(cdt)                                  # (B,C,Q,Q,H)
    g = torch.einsum("bcin,bcjn->bcij", ccc.float(), bcc.float()).to(cdt)
    # w_intra = g·decay·dt_j, (B,C,Q,Q,H): the only large intermediate
    if tracked:
        w_intra = decay * g[..., None] * dtc[:, :, None]
    else:
        w_intra = decay.mul_(g[..., None]).mul_(dtc[:, :, None])
    del decay, g
    return torch.einsum("bcijh,bcjhp->bcihp", w_intra.float(), xc.float())


def _output_eager(y_intra, ccc, run, cum, xh, d, cdt, out_dtype):
    """The eager chain's chunk output (B, S, H, P) in ``out_dtype``: the
    inter-chunk term from the states before each chunk (``run`` shifted
    by one chunk), added to ``y_intra``, and the D skip."""
    b, s, h, pd = xh.shape
    prev = torch.cat([torch.zeros_like(run[:, :1]), run[:, :-1]],
                     dim=1)                                # state before c
    decay_in = torch.exp(cum).to(cdt)                      # (B,C,Q,H)
    cprev = torch.einsum("bcin,bchpn->bcihp", ccc.float(),
                         prev.to(cdt).float())
    del prev
    y_inter = cprev * decay_in[..., None]
    del cprev
    y = (y_intra + y_inter).reshape(b, s, h, pd)
    del y_inter
    y = y + xh.float() * d.float()[:, None]
    return y.to(out_dtype)


def ssd_forward(cfg: ModelConfig, p: dict, u: torch.Tensor,
                return_state: bool = False, tp=None):
    """Training / prefill SSD pass. u: (B, S, D) → (B, S, D), a partial
    sum over the model peers when the heads are split (``tp``: the
    pass's ``ModelSplit``) (+ (final_state, conv_cache) of the rank's
    heads when return_state, for decode).

    The whole pass is the span ``ssm.ssd``; ``ssm.intra`` is the eager
    intra-chunk chain, or g and the chunk-output kernel after K4; the
    backward is ``ssm.ssd.backward``: from the output's gradient to the
    input's whole gradient, so in a hybrid block the attention's
    backward on the same input lies inside."""
    back = obs.backward_span("ssm.ssd.backward")
    with obs.span("ssm.ssd"):
        if back is None:
            return _ssd(cfg, p, u, return_state, tp)
        out = _ssd(cfg, p, back.enter(u), return_state, tp)
        if return_state:
            return back.leave(out[0]), out[1]
        return back.leave(out)


def _ssd(cfg: ModelConfig, p: dict, u: torch.Tensor, return_state: bool,
         tp):
    b, s_in, _ = u.shape
    h, pd, n = p["A_log"].shape[0], cfg.ssm_headdim, cfg.ssm_state
    q = min(cfg.ssm_chunk, s_in)
    pad = (-s_in) % q
    if pad:
        if return_state:  # padded decay would corrupt the carried state
            raise ValueError(f"prefill seq {s_in} % ssm_chunk {q} != 0")
        u = torch.cat([u, u.new_zeros((b, pad, u.shape[-1]))], dim=1)
    s = s_in + pad
    nc = s // q

    z, x, bc, cc, dt = _proj(cfg, p, u)
    w = cfg.conv_width - 1
    # copies: a slice would keep the whole (B, S, ·) projection alive
    conv_cache = {"x": x[:, -w:].clone(), "B": bc[:, -w:].clone(),
                  "C": cc[:, -w:].clone()}
    x, _ = _causal_conv(x, p["conv_x"])
    bc, _ = _causal_conv(bc, p["conv_B"])
    cc, _ = _causal_conv(cc, p["conv_C"])

    a = -torch.exp(p["A_log"].float())                     # (H,) negative
    dta = dt * a                                           # (B,S,H) log-decay
    xh = x.reshape(b, s, h, pd)

    # chunk views
    cdt = torch.bfloat16 if cfg.ssd_bf16 else torch.float32
    dtac = dta.reshape(b, nc, q, h)
    dtc = dt.reshape(b, nc, q, h).to(cdt)
    xc = xh.reshape(b, nc, q, h, pd).to(cdt)
    bcc = bc.reshape(b, nc, q, n).to(cdt)
    ccc = cc.reshape(b, nc, q, n).to(cdt)

    cum = torch.cumsum(dtac, dim=2)                        # (B,C,Q,H)
    tracked = torch.is_grad_enabled() and any(
        t.requires_grad for t in (u, *p.values()))
    how = sc.route(isa.current_mode(), u.is_cuda, tracked, cfg.ssd_bf16,
                   sc.shape_error(q, pd, n, xh.dtype, cc.dtype) is None)
    if how == "declined":
        sc.SSD_CHUNK.declined += 1
    eager = how in ("eager", "declined")
    if eager:
        with obs.span("ssm.intra"):
            y_intra = _intra_eager(ccc, bcc, xc, dtc, cum, cdt, tracked)

    # chunk end-states  S_c = Σ_j exp(cum_Q - cum_j) dt_j B_j x_j
    decay_end = torch.exp(cum[:, :, -1:, :] - cum).to(cdt)  # (B,C,Q,H)
    xdt = xc * (decay_end * dtc)[..., None]                 # (B,C,Q,H,P)
    states = torch.einsum("bcjn,bcjhp->bchpn", bcc.float(),
                          xdt.float())                      # (B,C,H,P,N)
    del xdt

    # inter-chunk recurrence — the paper's carried scan (c4_statescan):
    # shared per-(B,C,H) decay, (P,N) state payload, scan along chunks.
    a_chunk = torch.exp(cum[:, :, -1, :])                  # (B,C,H)
    run = kops.chunk_scan_state(a_chunk, states, axis=1)   # (B,C,H,P,N)
    del states

    if eager:
        y = _output_eager(y_intra, ccc, run, cum, xh, p["D"], cdt, u.dtype)
        del y_intra
    else:
        # the chunk output in one pass: the SSD chunk-output kernel, or its
        # plain version under interpret
        chunks = sc.chunk_output_plain if how == "plain" else sc.SSD_CHUNK
        with obs.span("ssm.intra"):
            g = torch.einsum("bcin,bcjn->bcij", ccc.float(), bcc.float())
            y = chunks(xh, cc, g, cum, dt, run, p["D"].float(), q, u.dtype)
        del g
    y = y.reshape(b, s, h * pd)
    y = _gated_norm(cfg, p, y, z, tp)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])[:, :s_in]
    if return_state:
        return out, (run[:, -1].clone(), conv_cache)   # state after last chunk
    return out


def ssd_decode(cfg: ModelConfig, p: dict, u: torch.Tensor,
               conv_cache: dict, ssm_state: torch.Tensor, tp=None):
    """One-token step. u: (B,1,D); ssm_state: (B,H,P,N) (the rank's
    heads under a split, ``tp``).

    Returns (out (B,1,D), new_conv_cache, new_ssm_state)."""
    b = u.shape[0]
    h, pd = p["A_log"].shape[0], cfg.ssm_headdim

    z, x, bc, cc, dt = _proj(cfg, p, u)
    x, cx = _causal_conv(x, p["conv_x"], conv_cache["x"])
    bc, cb = _causal_conv(bc, p["conv_B"], conv_cache["B"])
    cc_, ccv = _causal_conv(cc, p["conv_C"], conv_cache["C"])

    a = -torch.exp(p["A_log"].float())
    dt1 = dt[:, 0]                                          # (B,H)
    decay = torch.exp(dt1 * a)                              # (B,H)
    xh = x[:, 0].reshape(b, h, pd).float()
    binc = torch.einsum("bn,bh,bhp->bhpn", bc[:, 0].float(), dt1, xh)
    new_state = decay[..., None, None] * ssm_state + binc
    y = torch.einsum("bn,bhpn->bhp", cc_[:, 0].float(), new_state)
    y = y + xh * p["D"].float()[:, None]
    y = y.reshape(b, 1, h * pd).to(u.dtype)
    y = _gated_norm(cfg, p, y, z, tp)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return out, {"x": cx, "B": cb, "C": ccv}, new_state
