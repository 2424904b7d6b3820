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
from repro_torch.kernels import ssd_chunk
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


# -- the SSD chunk output: the kernel's plain version and the dispatch -----

def chunk_inputs(seed, b, nc, q, h, p, n, dtype=torch.float32):
    """The chunk output's operands at (b, nc·q) tokens: x and C holding
    bf16 values (in ``dtype``), g = C·Bᵀ, decays that carry across
    chunks, states of unit scale."""
    rng = np.random.default_rng(seed)
    s = nc * q

    def bf16(*shape):
        return torch.from_numpy(normal(rng, *shape)).to(torch.bfloat16)

    x, c, bm = bf16(b, s, h, p), bf16(b, s, n), bf16(b, s, n)
    g = torch.einsum("bcin,bcjn->bcij", c.float().reshape(b, nc, q, n),
                     bm.float().reshape(b, nc, q, n))
    dt = torch.nn.functional.softplus(torch.from_numpy(normal(rng, b, s, h)))
    a = -torch.from_numpy(rng.uniform(0.01, 0.2, h).astype(np.float32))
    cum = torch.cumsum((dt * a).reshape(b, nc, q, h), dim=2)
    run = torch.from_numpy(normal(rng, b, nc, h, p, n))
    d = torch.from_numpy(normal(rng, h))
    return x.to(dtype), c.to(dtype), g, cum, dt, run, d


def chunk_output_f64(x, c, g, cum, dt, run, d, q):
    """The formula in float64, from the operands as given."""
    b, s, h, p = x.shape
    nc = s // q
    x, c, g, cum, dt, run, d = (t.double() for t in
                                (x, c, g, cum, dt, run, d))
    xc, cc = x.reshape(b, nc, q, h, p), c.reshape(b, nc, q, -1)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool))[None, None, :,
                                                            :, None]
    w = torch.where(causal, seg.clamp(max=0).exp(), 0.0) * g[..., None] * \
        dt.reshape(b, nc, q, h)[:, :, None]
    y = torch.einsum("bcijh,bcjhp->bcihp", w, xc)
    prev = torch.cat([torch.zeros_like(run[:, :1]), run[:, :-1]], dim=1)
    y = y + torch.einsum("bcin,bchpn->bcihp", cc, prev) * cum.exp()[..., None]
    return (y.reshape(b, s, h, p) + x * d[:, None]).float()


# (b, nc, q, heads, headdim, state): the reduced mamba2 and hymba widths
# at their chunk of 16, and chunks of 64 at the published headdims
CHUNK_SHAPES = {"mamba2_reduced": (2, 3, 16, 8, 16, 16),
                "hymba_reduced": (2, 3, 16, 6, 16, 16),
                "mamba2_q64": (1, 3, 64, 2, 64, 128),
                "hymba_q64": (1, 3, 64, 2, 50, 16)}


@pytest.mark.parametrize("pieces", [3, 1])
@pytest.mark.parametrize("shape", CHUNK_SHAPES)
def test_chunk_output_plain_against_float64(shape, pieces):
    # three bf16 terms hold the layer tolerance; one term (the kernel's
    # negative control) misses it by orders of magnitude
    b, nc, q, h, p, n = CHUNK_SHAPES[shape]
    ops = chunk_inputs(sum(CHUNK_SHAPES[shape]), b, nc, q, h, p, n)
    want = chunk_output_f64(*ops, q)
    got = ssd_chunk.chunk_output_plain(*ops, q, torch.float32, pieces)
    err = float((got - want).abs().max() / want.abs().max())
    if pieces == 3:
        assert err <= LAYER_TOL, err
    else:
        assert err > 20 * LAYER_TOL, err


@pytest.mark.parametrize("shape", CHUNK_SHAPES)
def test_chunk_output_eager_chain_against_float64(shape):
    # the eager chain's two halves (models/ssm.py), called as _ssd calls
    # them (g from C and B inside), against the same formula: the
    # yardstick of the kernel's card test
    b, nc, q, h, p, n = CHUNK_SHAPES[shape]
    x, c, g, cum, dt, run, d = chunk_inputs(7, b, nc, q, h, p, n)
    bm = torch.from_numpy(normal(np.random.default_rng(8), b, nc * q, n)
                          ).to(torch.bfloat16).float()
    ccc, bcc = c.reshape(b, nc, q, n), bm.reshape(b, nc, q, n)
    with torch.no_grad():
        y_intra = ssm._intra_eager(ccc, bcc, x.reshape(b, nc, q, h, p),
                                   dt.reshape(b, nc, q, h), cum,
                                   torch.float32, False)
        got = ssm._output_eager(y_intra, ccc, run, cum, x, d, torch.float32,
                                torch.float32)
    g = torch.einsum("bcin,bcjn->bcij", ccc, bcc)
    close(got, chunk_output_f64(x, c, g, cum, dt, run, d, q).numpy())


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_chunk_output_plain_rounds_once_to_the_output_dtype(out_dtype):
    ops = chunk_inputs(3, *CHUNK_SHAPES["hymba_q64"])
    q = CHUNK_SHAPES["hymba_q64"][2]
    y32 = ssd_chunk.chunk_output_plain(*ops, q, torch.float32)
    got = ssd_chunk.chunk_output_plain(*ops, q, out_dtype)
    assert got.dtype == out_dtype
    assert torch.equal(got, y32.to(out_dtype))


@pytest.mark.parametrize("pieces", [1, 2, 3])
def test_split_terms_sum_back(pieces):
    # each bf16 term (8 significant bits, rounded to nearest) leaves at
    # most 2^-8 of what it splits; three hold a float32 exactly while
    # every term stays in bf16's normal range
    rng = np.random.default_rng(pieces)
    v = torch.from_numpy((normal(rng, 4096) * np.exp(
        rng.uniform(-30, 30, 4096))).astype(np.float32))
    terms = ssd_chunk.split(v, pieces)
    assert len(terms) == pieces
    assert all(t.dtype == torch.bfloat16 for t in terms)
    total = sum(t.double() for t in terms)
    rel = float(((total - v.double()).abs() / v.double().abs()).max())
    assert rel <= 2.0 ** (-8 * pieces), rel
    if pieces == 3:
        assert torch.equal(total, v.double())


ROUTES = [  # (mode, on CUDA, grad, ssd_bf16, shape taken) -> route
    ("auto", True, False, False, True, "kernel"),
    ("kernel", True, False, False, True, "kernel"),
    ("auto", True, False, False, False, "declined"),
    ("kernel", True, False, False, False, "declined"),
    ("auto", True, True, False, True, "eager"),
    ("auto", True, False, True, True, "eager"),
    ("ref", True, False, False, True, "eager"),
    ("auto", False, False, False, True, "eager"),
    ("kernel", False, False, False, True, "eager"),
    ("interpret", False, False, False, False, "plain"),
    ("interpret", True, False, False, True, "plain"),
    ("interpret", False, True, False, True, "eager"),
    ("interpret", False, False, True, True, "eager"),
]


@pytest.mark.parametrize("mode,cuda,grad,bf16,takes,want", ROUTES)
def test_chunk_output_route(mode, cuda, grad, bf16, takes, want):
    assert ssd_chunk.route(mode, cuda, grad, bf16, takes) == want


@pytest.mark.parametrize("q,p,n,xdt,ok", [
    (256, 64, 128, torch.bfloat16, True),     # mamba2-1.3b
    (256, 50, 16, torch.bfloat16, True),      # hymba-1.5b
    (32, 2, 16, torch.bfloat16, True),
    (16, 16, 16, torch.bfloat16, False),      # the reduced configs
    (512, 64, 128, torch.bfloat16, False),
    (256, 66, 128, torch.bfloat16, False),
    (256, 51, 16, torch.bfloat16, False),
    (256, 64, 136, torch.bfloat16, False),
    (256, 64, 120, torch.bfloat16, False),
    (256, 64, 128, torch.float32, False),
])
def test_chunk_output_shape_rule(q, p, n, xdt, ok):
    assert (ssd_chunk.shape_error(q, p, n, xdt, torch.bfloat16) is None) \
        == ok


def test_chunk_output_kernel_raises_on_cpu_tensors():
    ops = chunk_inputs(5, 1, 2, 32, 2, 8, 16, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA"):
        ssd_chunk.SSD_CHUNK(*ops, 32, torch.bfloat16)
    with pytest.raises(ValueError, match="chunk 16"):
        ssd_chunk.SSD_CHUNK(*ops, 16, torch.bfloat16)


@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_interpret_ssd_forward_is_the_eager_chain(arch, return_state):
    # without grad, interpret takes the kernel's plain version, ref the
    # eager chain: the same output and state within the layer tolerance
    _, cfg, _, tp = layer0(arch)
    u = torch.from_numpy(normal(np.random.default_rng(11), 2, 48,
                                cfg.d_model))
    with torch.no_grad():
        with isa.use("ref"):
            want = ssm.ssd_forward(cfg, tp, u, return_state=return_state)
        with isa.use("interpret"):
            got = ssm.ssd_forward(cfg, tp, u, return_state=return_state)
    if return_state:
        (want, (wstate, _)), (got, (state, _)) = want, got
        close(state, wstate.numpy())
    close(got, want.numpy())


def _plain_calls(monkeypatch):
    calls = []
    plain = ssd_chunk.chunk_output_plain

    def tapped(*args, **kw):
        calls.append(tuple(args[0].shape))
        return plain(*args, **kw)

    monkeypatch.setattr(ssd_chunk, "chunk_output_plain", tapped)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_interpret_no_grad_runs_the_plain_chunk_output(arch, monkeypatch):
    calls = _plain_calls(monkeypatch)
    _, cfg, _, tp = layer0(arch)
    u = torch.zeros(2, 32, cfg.d_model)
    with torch.no_grad(), isa.use("interpret"):
        ssm.ssd_forward(cfg, tp, u)
    assert calls == [(2, 32, cfg.ssm_heads, cfg.ssm_headdim)]
    with torch.no_grad(), isa.use("ref"):
        ssm.ssd_forward(cfg, tp, u)
    assert len(calls) == 1


@pytest.mark.parametrize("case", ["grad", "ssd_bf16"])
def test_grad_or_ssd_bf16_keeps_the_eager_chain(case, monkeypatch):
    calls = _plain_calls(monkeypatch)
    over = {"ssd_bf16": True} if case == "ssd_bf16" else {}
    _, cfg, _, tp = layer0("mamba2_1p3b", **over)
    u = torch.zeros(2, 32, cfg.d_model)
    if case == "grad":
        tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    declined = ssd_chunk.SSD_CHUNK.declined
    with isa.use("interpret"):
        out = ssm.ssd_forward(cfg, tp, u)
    assert calls == []
    assert out.requires_grad == (case == "grad")
    assert ssd_chunk.SSD_CHUNK.declined == declined   # CPU: never declined
