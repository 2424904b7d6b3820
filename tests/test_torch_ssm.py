"""repro_torch's SSD mixer (models/ssm.py) against the JAX package's, on
the CPU.

Weights are the JAX package's ``init_params`` for the reduced
``mamba2_1p3b`` and ``hymba_1p5b``, carried over with
``params_from_numpy``; inputs are seeded numpy. Tolerance: within 1e-5
of each output's largest |value| (``LAYER_TOL``: the same fp32 products
and scans summed in other orders). The JAX side runs its oracle (``ref``)
or its Pallas kernels in ``interpret`` mode; the port's side its torch
oracles (``ref``) or K4's plain walk (``interpret``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the JAX ISA
import repro_torch.kernels  # noqa: F401 — registers the port's ISA
from repro import configs as jconfigs
from repro.core import isa as jisa
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.core import isa
from repro_torch.models import params as tparams
from repro_torch.models import ssm

LAYER_TOL = 1e-5
ARCHS = ("mamba2_1p3b", "hymba_1p5b")
MODES = ("ref", "interpret")


def cfgs(arch, **over):
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(), **over),
            dataclasses.replace(configs.get_config(arch).reduced(), **over))


def layer0(arch, **over):
    """(jax cfg, port cfg, layer 0's ssm params in each package)."""
    jcfg, cfg = cfgs(arch, **over)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tp = tparams.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return (jcfg, cfg, jax.tree.map(lambda a: a[0], jp["layers"])["ssm"],
            tparams.tree_map(lambda a: a[0], tp["layers"])["ssm"])


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(got, want, tol=LAYER_TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("width", [1, 4])
def test_causal_conv(width, cached):
    rng = np.random.default_rng(width)
    x, w = normal(rng, 2, 7, 12), normal(rng, width, 12)
    cache = normal(rng, 2, width - 1, 12) if cached else None
    got, gc = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                               None if cache is None
                               else torch.from_numpy(cache))
    want, wc = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 None if cache is None
                                 else jnp.asarray(cache))
    close(got, want)
    if wc is None:
        assert gc is None
    else:
        close(gc, wc)


@pytest.mark.parametrize("arch", ARCHS)
def test_proj(arch):
    jcfg, cfg, jp, tp = layer0(arch)
    u = normal(np.random.default_rng(2), 2, 9, cfg.d_model)
    for got, want in zip(ssm._proj(cfg, tp, torch.from_numpy(u)),
                         jssm._proj(jcfg, jp, jnp.asarray(u)), strict=True):
        close(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seq", [32, 48, 40])      # 40: padded, no state
@pytest.mark.parametrize("arch", ARCHS)
def test_ssd_forward(arch, seq, mode):
    jcfg, cfg, jp, tp = layer0(arch)
    u = normal(np.random.default_rng(seq), 2, seq, cfg.d_model)
    with jisa.use(mode), isa.use(mode):
        got = ssm.ssd_forward(cfg, tp, torch.from_numpy(u))
        want = jssm.ssd_forward(jcfg, jp, jnp.asarray(u))
        close(got, want)
        if seq % cfg.ssm_chunk:
            return
        got, (state, conv) = ssm.ssd_forward(cfg, tp, torch.from_numpy(u),
                                             return_state=True)
        want, (wstate, wconv) = jssm.ssd_forward(jcfg, jp, jnp.asarray(u),
                                                 return_state=True)
    close(got, want)
    assert state.dtype == torch.float32
    assert tuple(state.shape) == (2, cfg.ssm_heads, cfg.ssm_headdim,
                                  cfg.ssm_state)
    close(state, wstate)
    assert set(conv) == set(wconv) == {"x", "B", "C"}
    for key in conv:
        close(conv[key], wconv[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_ssd_forward_bf16_intra_chunk(arch):
    # ssd_bf16: the intra-chunk tensors in bf16, products accumulated in
    # fp32 (the reference's preferred_element_type; the port casts the
    # bf16 operands to fp32, which is exact)
    jcfg, cfg, jp, tp = layer0(arch, ssd_bf16=True)
    u = normal(np.random.default_rng(3), 2, 32, cfg.d_model)
    got = ssm.ssd_forward(cfg, tp, torch.from_numpy(u))
    want = jssm.ssd_forward(jcfg, jp, jnp.asarray(u))
    close(got, want)
    exact = ssm.ssd_forward(dataclasses.replace(cfg, ssd_bf16=False), tp,
                            torch.from_numpy(u))
    assert not torch.equal(got, exact)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssd_decode(arch):
    jcfg, cfg, jp, tp = layer0(arch)
    rng = np.random.default_rng(4)
    u = normal(rng, 2, 1, cfg.d_model)
    w = cfg.conv_width - 1
    conv = {"x": normal(rng, 2, w, cfg.d_inner),
            "B": normal(rng, 2, w, cfg.ssm_state),
            "C": normal(rng, 2, w, cfg.ssm_state)}
    state = normal(rng, 2, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    got, gconv, gstate = ssm.ssd_decode(
        cfg, tp, torch.from_numpy(u),
        {k: torch.from_numpy(v) for k, v in conv.items()},
        torch.from_numpy(state))
    want, wconv, wstate = jssm.ssd_decode(
        jcfg, jp, jnp.asarray(u), {k: jnp.asarray(v) for k, v in conv.items()},
        jnp.asarray(state))
    close(got, want)
    close(gstate, wstate)
    for key in ("x", "B", "C"):
        close(gconv[key], wconv[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_length_not_a_chunk_multiple_raises(arch):
    _, cfg, _, tp = layer0(arch)
    u = torch.zeros(1, 20, cfg.d_model)
    with pytest.raises(ValueError, match="ssm_chunk"):
        ssm.ssd_forward(cfg, tp, u, return_state=True)
    assert ssm.ssd_forward(cfg, tp, u).shape == u.shape


def test_state_scan_runs_through_c4_statescan(monkeypatch):
    # the inter-chunk recurrence is the registered instruction, once a call
    from repro_torch.kernels import ops
    calls = []
    scan = ops.chunk_scan_state

    def tapped(a, b, axis=1, mode=None):
        calls.append((tuple(a.shape), tuple(b.shape), axis))
        return scan(a, b, axis=axis, mode=mode)

    monkeypatch.setattr(ops, "chunk_scan_state", tapped)
    _, cfg, _, tp = layer0("mamba2_1p3b")
    ssm.ssd_forward(cfg, tp, torch.zeros(2, 48, cfg.d_model))
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    assert calls == [((2, 3, h), (2, 3, h, p, n), 1)]
