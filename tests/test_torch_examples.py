"""The example twins (``repro_torch.examples``) and the last API twins
(``KernelTemplate.reference``, ``StreamConfig.vlen_elems`` /
``block_shape_2d``, ``serve.grow_cache_fn``) against the JAX package, on
the CPU.

``quickstart`` and ``sort_prefix_apps`` are held against the JAX
package's ISA functions (``interpret`` / ``ref``) on the scripts' own
numpy inputs. The JAX driver scripts ``serve_decode`` and ``train_lm``
stop at a ``ShardingTypeError`` under jax 0.9 (ROADMAP, Reference
caveats), so their twins are held against the port's own drivers called
with the same argv. Each test runs under a time limit of its own.
"""
import contextlib
import dataclasses
import io
import math
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the JAX ISA
from repro.configs import get_config as jget_config
from repro.core import isa as jisa
from repro.core.stream import StreamConfig as JStreamConfig
from repro.core.template import KernelTemplate as JTemplate
from repro.graph import partition as jpartition
from repro.kernels import ops as jops
from repro.memhier import TPU_V5E
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.core import isa
from repro_torch.core.stream import StreamConfig
from repro_torch.examples import (quickstart, serve_decode, sort_prefix_apps,
                                  train_lm)
from repro_torch.launch import serve, train
from repro_torch.models.params import param_specs, tree_items


@contextlib.contextmanager
def time_limit(seconds: float):
    """Raise TimeoutError in the test if its body outlasts ``seconds``."""
    def expire(signum, frame):
        raise TimeoutError(f"over its {seconds} s limit")
    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for these toy sizes: beside the suite's other
    workers, a thread per core makes a tiny model's step tens of times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def quiet(fn, argv):
    """``fn(argv)`` with its printout captured: (printout, result)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(argv)
    return buf.getvalue(), ret


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def _jax_body(scalars, ins, outs, carry, step):     # examples/quickstart.py
    blk = ins[0][...]
    m = jnp.maximum(carry[...], jnp.max(jnp.abs(blk), axis=-1,
                                        keepdims=True))
    outs[0][...] = blk / jnp.maximum(m, 1e-9)
    carry[...] = m


def _jax_ref(x, block):                             # examples/quickstart.py
    rows, cols = x.shape
    xb = x.reshape(rows, cols // block, block)
    blockmax = jnp.max(jnp.abs(xb), axis=-1)
    run = jax.lax.associative_scan(jnp.maximum, blockmax, axis=-1)
    return (xb / jnp.maximum(run[..., None], 1e-9)).reshape(rows, cols)


JAX_TEMPLATE = JTemplate(name="c7_absmax_scale", body=_jax_body,
                         n_vec_in=1, n_vec_out=1, carry_cols=1,
                         carry_init=0.0)


def test_quickstart_matches_the_jax_isa():
    """c7 (the K1 emulator and the oracle) and both tenants' results bit
    for bit against the JAX package's interpret and ref runs on the
    script's inputs; the process-wide registry is left as it was."""
    before = dict(isa.registry._instrs)
    with time_limit(300):
        text, out = quiet(quickstart.main, ["--device", "cpu"])
    assert isa.registry._instrs == before
    # the reference script's own draws
    x = np.asarray(jnp.asarray(np.random.default_rng(0).standard_normal(
        (8, 1024)), jnp.float32))
    y = np.asarray(jnp.asarray(np.random.default_rng(1).standard_normal(
        4096), jnp.float32))
    b = np.asarray(jnp.asarray(np.random.default_rng(2).standard_normal(
        4096), jnp.float32))
    for got, want in ((out["x"], x), (out["y"], y), (out["b"], b)):
        np.testing.assert_array_equal(got.numpy(), want)
    jker = np.asarray(JAX_TEMPLATE(jnp.asarray(x), interpret=True))
    jref = np.asarray(_jax_ref(jnp.asarray(x), JAX_TEMPLATE.block_cols))
    np.testing.assert_array_equal(out["kernel"].numpy(), jker)
    np.testing.assert_array_equal(out["oracle"].numpy(), jref)
    assert math.isclose(out["program"], float(jnp.sum(jref)), rel_tol=1e-6)
    jfused = jisa.fuse("c0_scale", "c0_add")
    rep = out["report"]
    assert len(rep.placements) == 2
    assert all(p.coalesced for p in rep.placements)
    assert len({p.batch_seq for p in rep.placements}) == 1
    for seq, (u, v) in enumerate(((y, b), (b, y))):
        for mode in ("interpret", "ref"):
            want = np.asarray(jfused(2.0, jnp.asarray(u), jnp.asarray(v),
                                     mode=mode))
            np.testing.assert_array_equal(rep.results[seq].numpy(), want)
    assert "instruction registered: True" in text
    assert "kernel vs oracle max err: 0.0" in text
    assert text.count("coalesced=True") == 2


# ---------------------------------------------------------------------------
# sort_prefix_apps
# ---------------------------------------------------------------------------

def test_sort_prefix_apps_matches_the_jax_ops():
    """At 1 MiB (2¹⁸ keys): the sort bit-exact against the JAX app, the
    prefix sum within 1e-5 of max |cumsum| of the JAX K3 in interpret
    mode, the plan's outputs bit for bit against the JAX plan's (scalars
    2.0 and 0.5: every product exact)."""
    with time_limit(300):
        text, out = quiet(sort_prefix_apps.main,
                          ["--mib", "1", "--device", "cpu"])
        npow = 1 << 18
        rng = np.random.default_rng(0)     # the reference script's draws
        keys = np.asarray(jnp.asarray(rng.integers(-2**31, 2**31 - 1, npow),
                                      jnp.int32))
        x = np.asarray(jnp.asarray(rng.standard_normal(npow), jnp.float32))
        n = min(npow, 1 << 16)
        xa = np.asarray(jnp.asarray(rng.standard_normal(n), jnp.float32))
        ba = np.asarray(jnp.asarray(rng.standard_normal(n), jnp.float32))
        for got, want in ((out["keys"], keys), (out["x"], x),
                          (out["plan_inputs"][0], xa),
                          (out["plan_inputs"][1], ba)):
            np.testing.assert_array_equal(got.numpy(), want)
        jsorted = np.asarray(jops.sortnet_mergesort(
            jnp.asarray(keys)[None], max_kernel_width=4096)[0])
        np.testing.assert_array_equal(out["sorted"].numpy(), jsorted)
        jprefix = np.asarray(jops.prefix_sum(jnp.asarray(x)[None],
                                             mode="interpret")[0])
        scale = np.abs(jprefix).max()
        assert np.abs(out["prefix"].numpy() - jprefix).max() <= 1e-5 * scale
        jplan = jpartition(jops.c0_pipeline_graph("axpby_residual"),
                           model=TPU_V5E, n_elems=npow)
        for got, want in zip(out["plan_outputs"], jplan.ref(
                jnp.asarray(xa), jnp.asarray(ba), 2.0, 0.5)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert "verified identical" in text
    assert "plan matches its ref oracle" in text


# ---------------------------------------------------------------------------
# the driver twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--sched"]], ids=["plain", "sched"])
def test_serve_decode_is_the_server_at_its_argv(extra):
    """The twin's tokens equal ``serve.main``'s at the reference script's
    argv with the device added."""
    with time_limit(300):
        _, got = quiet(serve_decode.main, ["--device", "cpu", "--gen", "8",
                                           *extra])
        sched = (["--sched", "--sched-policy", "edf", "--slo-ms", "50.0"]
                 if extra else [])
        _, want = quiet(serve.main, [
            "--arch", "hymba-1.5b", "--reduced", "--batch", "4",
            "--prompt-len", "64", "--gen", "8", "--temperature", "0.8",
            "--device", "cpu", *sched])
    assert got.shape == (4, 8)
    np.testing.assert_array_equal(got, want)


def test_train_lm_tiny_is_the_train_driver_at_its_argv(tmp_path):
    """--tiny --steps 3: the twin's final loss equals ``train.main``'s at
    the same argv (each in a checkpoint directory of its own)."""
    with time_limit(300):
        text, got = quiet(train_lm.main, [
            "--tiny", "--steps", "3", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "twin")])
        _, want = quiet(train.main, [
            "--arch", "llama3-8b", "--reduced", "--steps", "3",
            "--batch", "8", "--seq", "128", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "driver")])
    assert math.isfinite(got) and got == want
    assert "llama3-8b-smoke, 2 layers" in text
    assert any((tmp_path / "twin").iterdir())


def test_train_lm_installs_the_40m_config(tmp_path, monkeypatch):
    """Without --tiny the driver sees the ~40M Llama-3 where it looks the
    arch up (the train module's own ``get_config``)."""
    seen = {}

    def fake_main(argv):
        seen["argv"] = argv
        seen["cfg"] = train.get_config("llama3-8b")
        return 0.0
    monkeypatch.setattr(train, "main", fake_main)
    train_lm.main(["--steps", "2", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path)])
    cfg = seen["cfg"]
    assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (8, 512, 8192)
    n = sum(math.prod(s.shape) for _, s in tree_items(param_specs(cfg)))
    assert 30e6 < n < 50e6, n
    assert "--reduced" not in seen["argv"]
    assert get_config("llama3-8b").n_layers == 32     # put back after


@pytest.mark.parametrize("example", [quickstart, sort_prefix_apps,
                                     serve_decode, train_lm],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_example_without_a_card_raises(example):
    """No quiet CPU fallback: the default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])


# ---------------------------------------------------------------------------
# the API twins
# ---------------------------------------------------------------------------

def test_template_reference_matches_the_jax_decorator():
    """Same name and doc, ``interpret`` swallowed, the oracle's values."""
    def absmax_oracle(x):
        """Blockwise absmax oracle."""
        return x / x.abs().max() if isinstance(x, torch.Tensor) else \
            x / jnp.max(jnp.abs(x))
    got = quickstart.TEMPLATE.reference(absmax_oracle)
    want = JAX_TEMPLATE.reference(absmax_oracle)
    assert got.__name__ == want.__name__ == "absmax_oracle"
    assert got.__doc__ == want.__doc__
    x = np.random.default_rng(3).standard_normal((8, 256)).astype(np.float32)
    for interpret in (False, True):
        np.testing.assert_array_equal(
            got(torch.from_numpy(x), interpret=interpret).numpy(),
            np.asarray(want(jnp.asarray(x), interpret=interpret)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int16"])
@pytest.mark.parametrize("bits", [(256 * 128, 16384 * 128),
                                  (1024 * 8, 1024 * 64), (1024 * 8,) * 2],
                         ids=["paper", "narrow", "one sub-block"])
def test_stream_geometry_matches_the_reference(dtype, bits):
    got = StreamConfig(vlen_bits=bits[0], block_bits=bits[1])
    want = JStreamConfig(vlen_bits=bits[0], block_bits=bits[1])
    assert got.vlen_elems(dtype) == want.vlen_elems(dtype)
    assert got.block_shape_2d(dtype) == want.block_shape_2d(dtype)
    assert got.vlen_elems(getattr(torch, dtype)) == want.vlen_elems(dtype)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("over", [{}, {"swa_window": 16}],
                         ids=["padded", "rolled"])
def test_grow_cache_fn_matches_the_reference(over):
    """A 2-layer reduced Llama-3's prefill cache from the JAX package,
    grown by the port's ``grow_cache_fn`` and by the reference's unsharded
    ``M.grow_cache``: leaves bit for bit."""
    jcfg = dataclasses.replace(jget_config("llama3-8b").reduced(), **over)
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), **over)
    assert cfg.n_layers == 2
    seq, cap = 24, 30
    with time_limit(300):
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (2, seq))
        _, jc = jax.jit(lambda p, b: JM.prefill(jcfg, p, b))(
            jp, {"tokens": jnp.asarray(tokens)})
        got = serve.grow_cache_fn(cfg, seq, cap)(_to_torch(jc))
        want = JM.grow_cache(jcfg, jc, seq, cap)
    flat_got = dict(tree_items(got))
    flat_want = dict(tree_items(_to_torch(want)))
    assert flat_got.keys() == flat_want.keys()
    for key, leaf in flat_got.items():
        np.testing.assert_array_equal(leaf.numpy(), flat_want[key].numpy())


# ---------------------------------------------------------------------------
# chip_smoke.py phase P's holds, on what the CPU can give them
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_examples",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_phase_p_holds(smoke, tmp_path):
    """The launch-count hold wants every named count and 0 elsewhere; the
    loss hold reads train.main's log and rejects a loss that does not
    fall by TRAIN_LM_FALL between the first and last five logged."""
    counts = {name: 0 for name in smoke.COUNTERS}
    assert smoke.launches_want(counts)
    assert not smoke.launches_want(dict(counts, K4=1))
    assert smoke.launches_want(dict(counts, **{"K4 reverse": 2}),
                               K4_reverse=2)
    assert not smoke.launches_want(dict(counts, K1=3), K1=2)
    with time_limit(300):
        text, final = quiet(train_lm.main, [
            "--tiny", "--steps", "10", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)])
    losses = smoke.logged_losses(text)
    assert len(losses) == 1 and losses[0] == pytest.approx(final, abs=1e-4)
    falling = [6.7 - 0.01 * i for i in range(20)]
    assert smoke.losses_fall(falling)
    assert not smoke.losses_fall([6.7] * 20)
    assert not smoke.losses_fall(falling[::-1])
    assert not smoke.losses_fall(falling[:9])          # too few logged
