"""Plain float32 Mamba2 (SSD, arXiv:2405.21060) for the benchmark's check.

Imports nothing of the program. The model as the configuration states
it: token embedding; per layer a pre-norm (RMSNorm) and the Mamba2
mixer added to the residual; a final RMSNorm and the logits against the
tied embedding. The mixer: in-projections to z, x, B, C (one group) and
dt (softplus with a per-head bias); a causal depthwise convolution with
SiLU over x, B and C; the selective state space recurrence

    S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t + D x_t

per head; a gated RMSNorm, RMSNorm(y * silu(z)); the out-projection.
The prompt's recurrence is computed chunk by chunk: the quadratic form
within a chunk, and a plain loop over the chunks that carries the
state; the served tokens after the prompt step the recurrence one token
at a time. Rows are independent, so the check runs a row at a time
(``WHOLE_BATCH``).

The family's weights (:func:`layer_layout`, ``LAWS``): a product's
weight by its fan-in, ones for the norms and the skip ``D``, and
Mamba2's initialisation for ``A_log`` (log of U(1, 16)) and ``dt_bias``
(inverse softplus of dt, log-uniform in [1e-3, 1e-1]), so that some
heads carry their state across chunks.
"""
from __future__ import annotations

import math

import torch

from .layers import logits as _logits
from .layers import mm, rmsnorm, silu, softplus


WHOLE_BATCH = False


def layer_layout(m: dict) -> dict:
    """One layer's leaves as (shape, law): a law is a fan-in (an int),
    ``ones`` or a name in ``LAWS``."""
    d, n, w = m["d_model"], m["ssm_state"], m["conv_width"]
    din = m["ssm_expand"] * d
    h = din // m["ssm_headdim"]
    return {"norm1": ((d,), "ones"),
            "ssm": {"w_z": ((d, din), d), "w_x": ((d, din), d),
                    "w_B": ((d, n), d), "w_C": ((d, n), d),
                    "w_dt": ((d, h), d),
                    "conv_x": ((w, din), w), "conv_B": ((w, n), w),
                    "conv_C": ((w, n), w),
                    "A_log": ((h,), "a_log"), "D": ((h,), "ones"),
                    "dt_bias": ((h,), "dt_bias"), "norm": ((din,), "ones"),
                    "out_proj": ((din, d), din)}}


def _a_log(t: torch.Tensor, gen: torch.Generator) -> None:
    u = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    t.copy_(u.uniform_(1.0, 16.0, generator=gen).log_())


def _dt_bias(t: torch.Tensor, gen: torch.Generator) -> None:
    u = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    dt = u.uniform_(math.log(1e-3), math.log(1e-1), generator=gen).exp_()
    t.copy_(dt + torch.log(-torch.expm1(-dt)))


LAWS = {"a_log": _a_log, "dt_bias": _dt_bias}


def _conv(x: torch.Tensor, w: torch.Tensor, window: torch.Tensor):
    """Causal depthwise conv of x (B, S, C) with taps w (W, C) after the
    ``window`` (B, W-1, C) of earlier inputs; SiLU of the result."""
    xp = torch.cat([window, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i].float() for i in range(w.shape[0]))
    return silu(y)


def _proj(p: dict, h: torch.Tensor, prec: str):
    z = mm(h, p["w_z"], prec)
    x = mm(h, p["w_x"], prec)
    b = mm(h, p["w_B"], prec)
    c = mm(h, p["w_C"], prec)
    dt = softplus(mm(h, p["w_dt"], prec) + p["dt_bias"].float())
    return z, x, b, c, dt


def _out(p: dict, y: torch.Tensor, z: torch.Tensor, prec: str):
    return mm(rmsnorm(y * silu(z), p["norm"]), p["out_proj"], prec)


def mixer_prompt(m: dict, p: dict, h: torch.Tensor, prec: str):
    """The mixer over a whole prompt h (B, S, D), S a multiple of the
    chunk. Returns (out (B, S, D), state (B, H, P, N), conv windows of
    the last W-1 inputs {x, B, C})."""
    bsz, s, _ = h.shape
    hp, n, q = m["ssm_headdim"], m["ssm_state"], m["ssm_chunk"]
    z, x, b, c, dt = _proj(p, h, prec)
    w1 = m["conv_width"] - 1
    windows = {"x": x[:, s - w1:], "B": b[:, s - w1:], "C": c[:, s - w1:]}
    zero = lambda t: t.new_zeros((bsz, w1, t.shape[-1]))  # noqa: E731
    x = _conv(x, p["conv_x"], zero(x))
    b = _conv(b, p["conv_B"], zero(b))
    c = _conv(c, p["conv_C"], zero(c))
    nh = dt.shape[-1]
    a = -torch.exp(p["A_log"].float())                         # (H,)
    nc = s // q
    xc = x.reshape(bsz, nc, q, nh, hp)
    bc = b.reshape(bsz, nc, q, n)
    cc = c.reshape(bsz, nc, q, n)
    dtc = dt.reshape(bsz, nc, q, nh)
    cum = torch.cumsum(dtc * a, dim=2)                         # (B,C,Q,H)
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool,
                                   device=h.device))[:, :, None]
    y = torch.empty_like(xc)
    state = x.new_zeros((bsz, nh, hp, n))
    for k in range(nc):                      # the carried recurrence
        seg = cum[:, k, :, None, :] - cum[:, k, None, :, :]    # (B,Q,Q,H)
        decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)),
                            0.0)
        g = torch.einsum("bin,bjn->bij", cc[:, k], bc[:, k])
        w = decay * g[..., None] * dtc[:, k, None, :, :]       # (B,i,j,H)
        y_in = torch.einsum("bijh,bjhp->bihp", w, xc[:, k])
        y_st = torch.einsum("bin,bhpn->bihp", cc[:, k], state) \
            * torch.exp(cum[:, k])[..., None]
        y[:, k] = y_in + y_st
        last = cum[:, k, -1]                                   # (B,H)
        to_end = torch.exp(last[:, None, :] - cum[:, k]) * dtc[:, k]
        state = (torch.exp(last)[..., None, None] * state
                 + torch.einsum("bjh,bjhp,bjn->bhpn", to_end, xc[:, k],
                                bc[:, k]))
    y = y + xc * p["D"].float()[:, None]
    y = y.reshape(bsz, s, nh * hp)
    return _out(p, y, z, prec), state, windows


def mixer_step(m: dict, p: dict, h: torch.Tensor, state: torch.Tensor,
               windows: dict, prec: str):
    """The mixer over tokens after a prefix, one at a time: h (B, T, D)
    with the prefix's state and conv windows. Returns out (B, T, D)."""
    bsz, t, _ = h.shape
    hp = m["ssm_headdim"]
    z, x, b, c, dt = _proj(p, h, prec)
    x = _conv(x, p["conv_x"], windows["x"])
    b = _conv(b, p["conv_B"], windows["B"])
    c = _conv(c, p["conv_C"], windows["C"])
    a = -torch.exp(p["A_log"].float())
    nh = dt.shape[-1]
    xs = x.reshape(bsz, t, nh, hp)
    ys = []
    for i in range(t):
        state = (torch.exp(dt[:, i] * a)[..., None, None] * state
                 + torch.einsum("bh,bhp,bn->bhpn", dt[:, i], xs[:, i],
                                b[:, i]))
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, i])
                  + xs[:, i] * p["D"].float()[:, None])
    y = torch.stack(ys, dim=1).reshape(bsz, t, nh * hp)
    return _out(p, y, z, prec)


def _layer(params: dict, i: int) -> dict:
    def pick(tree):
        return {k: pick(v) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return pick(params["layers"])


def forward(m: dict, params: dict, prompts: torch.Tensor,
            served: torch.Tensor, precision: str = "fp32") -> dict:
    """Logits at the served positions and the prompt's final states.

    prompts (B, P) and served (B, G) token ids: position P-1+i predicts
    ``served[:, i]``. Returns {"logits": (B, G, vocab) float32,
    "state": (L, B, H, P, N) float32, the state after the prompt}."""
    emb = params["embed"]
    xp = emb[prompts.long()].float()
    xs = emb[served[:, :-1].long()].float()
    states = []
    for i in range(m["n_layers"]):
        p = _layer(params, i)
        out, state, windows = mixer_prompt(m, p["ssm"],
                                           rmsnorm(xp, p["norm1"]), precision)
        states.append(state)
        if xs.shape[1]:
            xs = xs + mixer_step(m, p["ssm"], rmsnorm(xs, p["norm1"]),
                                 state, windows, precision)
        xp = xp + out
    h = torch.cat([xp[:, -1:], xs], dim=1)
    h = rmsnorm(h, params["final_norm"])
    w = params["embed"].T if m.get("tie_embeddings") else params["unembed"]
    return {"logits": _logits(h, w, m["vocab"], precision),
            "state": torch.stack(states)}


def _stacked(params: dict, i: int, grad: bool) -> dict:
    """Layer i's leaves from the stacked float32 ``params`` (dotted
    names), as a tree; with ``grad``, fresh leaves that collect their
    gradient."""
    tree: dict = {}
    for k, v in params.items():
        if not k.startswith("layers."):
            continue
        leaf = v[i].detach()
        if grad:
            leaf = leaf.clone().requires_grad_()
        node = tree
        *path, last = k.split(".")[1:]
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def _leaves(tree: dict, prefix: str = "layers."):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def loss_and_grads(m: dict, params: dict, tokens: torch.Tensor,
                   targets: torch.Tensor, precision: str = "fp32",
                   z_loss: float = 1e-4):
    """The mean next-token cross-entropy plus ``z_loss`` x the mean squared
    log-sum-exp, and its gradient with respect to every leaf of
    ``params`` (dotted names, float32, layers stacked). Each layer is run
    forward once keeping only its input, and again with autograd in the
    backward walk, layer by layer. Returns (loss, grads)."""
    layers, vocab = m["n_layers"], m["vocab"]
    emb = params["embed"]
    x = emb[tokens.long()]
    inputs = []
    with torch.no_grad():
        for i in range(layers):
            inputs.append(x)
            p = _stacked(params, i, False)
            out, _, _ = mixer_prompt(m, p["ssm"], rmsnorm(x, p["norm1"]),
                                     precision)
            x = x + out
    head = {"final_norm": params["final_norm"].detach().clone()
            .requires_grad_(),
            "embed": emb.detach().clone().requires_grad_()}
    xl = x.detach().requires_grad_()
    h = rmsnorm(xl, head["final_norm"])
    logit = _logits(h, head["embed"].T, vocab, precision)
    lse = torch.logsumexp(logit, dim=-1)
    picked = logit.gather(-1, targets.long()[..., None])[..., 0]
    loss = (lse - picked).mean() + z_loss * (lse * lse).mean()
    loss.backward()
    del logit, lse, picked, h
    grads = {k: v.grad for k, v in head.items()}
    for k, v in params.items():
        if k.startswith("layers."):
            grads[k] = torch.zeros_like(v)
    g = xl.grad
    for i in reversed(range(layers)):
        xi = inputs.pop().requires_grad_()
        p = _stacked(params, i, True)
        y = xi + mixer_prompt(m, p["ssm"], rmsnorm(xi, p["norm1"]),
                              precision)[0]
        y.backward(g)
        g = xi.grad
        for k, leaf in _leaves(p):
            grads[k][i] = leaf.grad
        del y, xi, p
    grads["embed"].index_add_(0, tokens.reshape(-1).long(),
                              g.reshape(-1, g.shape[-1]))
    return float(loss.detach()), grads
