"""repro_torch's data pipeline against the JAX package's, on the CPU:
twins of ``tests/test_substrates.py``'s data tests, and both packages'
``host_batch(step)`` bit-identical (the same numpy draws)."""
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro_torch.data import SyntheticLMData, TokenFileData, to_device


def test_synthetic_batches_differ_by_step():
    d = SyntheticLMData(vocab=100, seq_len=8, global_batch=4)
    assert not np.array_equal(d.host_batch(0)["tokens"],
                              d.host_batch(1)["tokens"])


def test_token_file_data(tmp_path):
    path = str(tmp_path / "toks.bin")
    np.arange(10_000, dtype=np.int32).tofile(path)
    d = TokenFileData(path, seq_len=16, global_batch=4)
    b = d.host_batch(3)
    assert b["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (3, 17)])
def test_synthetic_batches_are_the_reference_batches(seed, step):
    args = dict(vocab=512, seq_len=64, global_batch=4, seed=seed)
    got = SyntheticLMData(**args).host_batch(step)
    want = jdata.SyntheticLMData(**args).host_batch(step)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("step", [0, 3, 11])
def test_token_file_batches_are_the_reference_batches(tmp_path, step):
    path = str(tmp_path / "toks.bin")
    np.random.default_rng(1).integers(0, 50_000, 20_000).astype(
        np.int32).tofile(path)
    got = TokenFileData(path, seq_len=32, global_batch=4, seed=2)
    want = jdata.TokenFileData(path, seq_len=32, global_batch=4, seed=2)
    for k, v in got.host_batch(step).items():
        np.testing.assert_array_equal(v, want.host_batch(step)[k])


def test_to_device_keeps_dtype_and_values():
    b = SyntheticLMData(vocab=100, seq_len=8, global_batch=2).host_batch(0)
    t = to_device(b, "cpu")
    assert t["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(t["targets"].numpy(), b["targets"])
