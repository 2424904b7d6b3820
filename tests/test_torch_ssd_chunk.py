"""The SSD chunk-output kernel (``kernels/ssd_chunk.py``,
``csrc/ssd_chunk.cu``) on the card.

It is CUDA C++ with no CPU mode, so every test here is marked ``gpu``
and skips without a CUDA device (its plain version and the mixer's
dispatch are tested on the CPU in ``test_torch_ssm.py``). Run on an
H100 with ``pytest -m gpu tests/test_torch_ssd_chunk.py``.

Tolerance: within 1e-5 of the output's largest |value| (``LAYER_TOL``,
the SSD mixer's layer tolerance) against the eager chain of
``models/ssm.py`` (full float32 products, TF32 off) and against the
plain version, in float32 output; the single-term control (the weights
and states as one bf16 term each) must miss that bound. The bf16 output
is the float32 output rounded once.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

import repro_torch.kernels  # noqa: F401 — registers the ISA
from repro_torch.configs import get_config
from repro_torch.core import isa
from repro_torch.kernels import ssd_chunk
from repro_torch.kernels.ssd_chunk import SSD_CHUNK
from repro_torch.models import model as M
from repro_torch.models import ssm

pytestmark = pytest.mark.gpu

ROOT = Path(__file__).resolve().parents[1]
LAYER_TOL = 1e-5
# (batch, chunks, chunk, heads, headdim, state)
SHAPES = {
    "mamba2-1.3b.prefill-8k": (8, 32, 256, 64, 64, 128),
    "hymba-1.5b": (4, 8, 256, 64, 50, 16),
    "mamba2-1.3b heads split over 2": (8, 32, 256, 32, 64, 128),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SSD chunk-output kernel is "
                    "CUDA C++ with no CPU mode (its plain version is tested "
                    "in test_torch_ssm)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_ssd",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def eager(ops, bm, q):
    """The eager chain of ``models/ssm.py`` on the same operands (float32
    output)."""
    x, c, _, cum, dt, run, d = ops
    b, s, h, p = x.shape
    nc, n = s // q, c.shape[-1]
    ccc = c.reshape(b, nc, q, n).float()
    with torch.no_grad():
        y_intra = ssm._intra_eager(
            ccc, bm.reshape(b, nc, q, n).float(),
            x.reshape(b, nc, q, h, p).float(), dt.reshape(b, nc, q, h), cum,
            torch.float32, False)
        return ssm._output_eager(y_intra, ccc, run, cum, x, d, torch.float32,
                                 torch.float32)


def rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_against_the_eager_chain_and_plain(cuda, smoke, shape):
    # operands whose decays carry across chunks (chip_smoke's, as phase J
    # times the kernel on them)
    q = SHAPES[shape][2]
    ops, bm = smoke.ssd_chunk_inputs(sum(SHAPES[shape]), SHAPES[shape], cuda)
    launches = SSD_CHUNK.launches
    got = SSD_CHUNK(*ops, q, torch.float32)
    control = SSD_CHUNK(*ops, q, torch.float32, pieces=1)
    assert SSD_CHUNK.launches == launches + 2
    want = eager(ops, bm, q)
    assert rel(got, want) <= LAYER_TOL
    assert rel(control, want) > LAYER_TOL
    del want
    plain = ssd_chunk.chunk_output_plain(*ops, q, torch.float32)
    assert rel(got, plain) <= LAYER_TOL
    del plain
    assert torch.equal(SSD_CHUNK(*ops, q, torch.bfloat16),
                       got.to(torch.bfloat16))


def test_kernel_reads_operands_in_place_only(cuda, smoke):
    ops, _ = smoke.ssd_chunk_inputs(1, (1, 2, 64, 2, 64, 16), cuda)
    x, c, g, cum, dt, run, d = ops
    with pytest.raises(ValueError, match="contiguous"):
        SSD_CHUNK(x, c, g, cum, dt, run.transpose(3, 4).contiguous()
                  .transpose(3, 4), d, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="chunk 48"):
        SSD_CHUNK(x[:, :96], c[:, :96], g, cum, dt[:, :96], run, d, 48,
                  torch.bfloat16)


def prefill_counts(cfg, batch, seq, dev, mode="auto"):
    """(kernel launches, declined calls) of one prefill of ``cfg``."""
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(3),
                           dev)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(4))
    SSD_CHUNK.launches = SSD_CHUNK.declined = 0
    with isa.use(mode):
        M.prefill(cfg, params, {"tokens": tokens})
    torch.cuda.synchronize()
    return SSD_CHUNK.launches, SSD_CHUNK.declined


def test_prefill_batch_of_the_cell_goes_through_the_kernel(cuda):
    # perfbench's mamba2-1.3b prefill-8k: 8 prompts of 8192 tokens
    cfg = get_config("mamba2_1p3b")
    assert prefill_counts(cfg, 8, 8192, cuda) == (cfg.n_layers, 0)


def test_prefill_of_a_declined_shape_counts_each_layer(cuda):
    # the reduced config's chunk of 16 and float32 activations are not the
    # kernel's
    cfg = get_config("mamba2_1p3b").reduced()
    assert prefill_counts(cfg, 2, 64, cuda) == (0, cfg.n_layers)


def test_training_and_ssd_bf16_keep_the_eager_chain(cuda):
    cfg = dataclasses.replace(get_config("mamba2_1p3b").reduced(),
                              ssm_chunk=64, ssm_headdim=64,
                              param_dtype="bfloat16", act_dtype="bfloat16")
    assert prefill_counts(cfg, 2, 128, cuda) == (cfg.n_layers, 0)
    assert prefill_counts(dataclasses.replace(cfg, ssd_bf16=True), 2, 128,
                          cuda) == (0, 0)
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(3),
                           cuda)
    p = {k: v[0].clone().requires_grad_()
         for k, v in params["layers"]["ssm"].items()}
    u = torch.randn(2, 128, cfg.d_model, device=cuda, dtype=torch.bfloat16)
    SSD_CHUNK.launches = SSD_CHUNK.declined = 0
    ssm.ssd_forward(cfg, p, u).float().sum().backward()
    assert (SSD_CHUNK.launches, SSD_CHUNK.declined) == (0, 0)
