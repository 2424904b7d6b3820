"""repro_torch's checkpoints against the JAX package's, on the CPU.

Twins of ``tests/test_substrates.py``'s checkpoint tests, and the format
shared by both packages (one ``.npy`` per leaf plus ``manifest.json``,
leaves named and numbered in sorted-key order, bfloat16 as its uint16
bits): a reduced Mamba2 train state (bfloat16 params, float32 moments)
saved by the JAX package restores in the port, and the port's in the
JAX package, leaf names equal and values bit for bit.
"""
import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.launch import api as japi
from repro_torch import configs
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, restore,
                                    save_checkpoint)
from repro_torch.launch import api
from repro_torch.models import params as tparams


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    save_checkpoint(str(tmp_path), 7, tree, extra={"note": "x"})
    got, manifest = load_checkpoint(str(tmp_path), template=tree)
    assert manifest["step"] == 7 and manifest["extra"]["note"] == "x"
    assert torch.equal(got["a"], tree["a"])
    assert got["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["c"], tree["b"]["c"])


def test_checkpoint_gc_keeps_last(tmp_path):
    tree = {"x": torch.zeros(2)}
    for s in range(5):
        save_checkpoint(str(tmp_path), s, tree, keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]
    assert latest_step(str(tmp_path)) == 4


def test_async_manager(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    x = torch.arange(4)
    mgr.save_async(3, {"x": x})
    x.add_(1)                   # the snapshot was taken at the call
    mgr.wait()
    got, m = load_checkpoint(str(tmp_path))
    assert m["step"] == 3 and torch.equal(got[0], torch.arange(4))


def test_preemption_handler_saves(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    try:
        mgr = CheckpointManager(str(tmp_path))
        mgr.install_preemption_handler()
        mgr.observe(11, {"x": torch.arange(3)})
        os.kill(os.getpid(), signal.SIGTERM)
        assert latest_step(str(tmp_path)) == 11
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_removing_the_preemption_handler_restores_the_previous_one(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    seen = []
    try:
        signal.signal(signal.SIGTERM, lambda *a: seen.append("previous"))
        mgr = CheckpointManager(str(tmp_path))
        mgr.install_preemption_handler()
        mgr.observe(5, {"x": torch.arange(3)})
        mgr.remove_preemption_handler()
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == ["previous"] and latest_step(str(tmp_path)) is None
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_template_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="template"):
        load_checkpoint(str(tmp_path), template={"b": torch.zeros(2)})


def _state(arch="mamba2_1p3b"):
    over = dict(param_dtype="bfloat16")
    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(), **over)
    cfg = dataclasses.replace(configs.get_config(arch).reduced(), **over)
    jstate = japi.init_train_state(jcfg, jax.random.PRNGKey(0))
    # a state past its zeros, so the moments carry values
    jstate, _ = jax.jit(japi.make_train_step(jcfg))(jstate, {
        "tokens": jnp.zeros((2, 16), jnp.int32),
        "targets": jnp.ones((2, 16), jnp.int32)})
    return jcfg, cfg, jstate


def _same(torch_tree, numpy_tree):
    got = dict(tparams.tree_items(torch_tree))
    want = dict(tparams.tree_items(numpy_tree))
    assert got.keys() == want.keys()
    for path, t in got.items():
        w = np.asarray(want[path])
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            assert str(t.dtype).removeprefix("torch.") == str(w.dtype), path
            np.testing.assert_array_equal(t.numpy(), w)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jcfg, cfg, jstate = _state()
    jckpt.save_checkpoint(str(tmp_path), 1, jstate)
    state, manifest = restore(str(tmp_path),
                              api.make_train_state_abstract(cfg), "cpu")
    assert manifest["step"] == 1 and int(state["step"]) == 1
    assert state["params"]["embed"].dtype == torch.bfloat16
    assert state["opt"]["m"]["embed"].dtype == torch.float32
    _same(state, jax.tree.map(np.asarray, jstate))


def test_port_checkpoint_restores_in_jax(tmp_path):
    jcfg, cfg, jstate = _state()
    state = api.train_state_from_numpy(
        cfg, jax.tree.map(np.asarray, jstate), "cpu")
    save_checkpoint(str(tmp_path), 1, state)
    got, manifest = jckpt.load_checkpoint(
        str(tmp_path), template=japi.make_train_state_abstract(jcfg))
    _same(state, got)


def test_leaf_names_and_files_are_the_references(tmp_path):
    jcfg, cfg, jstate = _state("kimi_k2_1t")
    state = api.train_state_from_numpy(
        cfg, jax.tree.map(np.asarray, jstate), "cpu")
    jckpt.save_checkpoint(str(tmp_path / "jax"), 2, jstate)
    save_checkpoint(str(tmp_path / "port"), 2, state)

    def manifest(sub):
        with open(tmp_path / sub / "step_00000002" / "manifest.json") as f:
            return json.load(f)
    assert manifest("port") == manifest("jax")
    for e in manifest("jax")["leaves"]:
        a = np.load(tmp_path / "jax" / "step_00000002" / e["file"])
        b = np.load(tmp_path / "port" / "step_00000002" / e["file"])
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
