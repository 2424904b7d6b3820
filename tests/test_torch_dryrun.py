"""repro_torch's dry run (``launch/dryrun.py``, ``launch/api.lower_cell``,
``roofline.analysis.count_step``).

* the twin of tests/test_system.py's ``test_dryrun_cell_subprocess``:
  musicgen-medium at decode_32k on the 256-rank production mesh, one JSON;
* a dry run of one rank equals the same reduced cell run for real on 2
  gloo ranks on the CPU: its collective bytes by kind, as the transport
  recorded them, and its FLOPs (FlopCounterMode over the real step on
  each rank), exactly — on a (2, 1) mesh (FSDP) and on a (1, 2) mesh
  (the dense layers split over ``model``, SP's all-gathers and
  reduce-scatters);
* the reference's cost(L) = outside + L·body fit from the L = 2 and
  L = 4 probes equals the direct count exactly (the port's walk counts
  every layer);
* ``DryMesh`` and ``DryGroup``: the production mesh in one process with
  rank 0's coordinates, no world consulted.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

import torch_dist_cases as T
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding
from repro_torch.launch import api, dryrun
from repro_torch.launch.mesh import DryMesh, production_shape
from repro_torch.roofline.analysis import collective_bytes_of, count_step

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TRAIN = ShapeConfig("train_tiny", 32, 4, "train")
CELLS = [("mamba2", get_config("mamba2_1p3b").reduced(), TRAIN),
         ("kimi", get_config("kimi_k2_1t").reduced(), TRAIN)]


def test_dryrun_cell_subprocess(tmp_path):
    """One dry-run cell end to end in a fresh process."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "musicgen-medium", "--shape", "decode_32k", "--outdir",
         str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": SRC}, cwd=os.path.dirname(SRC))
    assert out.returncode == 0, out.stdout + out.stderr
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    rep = json.load(open(os.path.join(tmp_path, files[0])))
    assert rep["n_chips"] == 256
    assert rep["terms"]["dominant"] in ("compute_s", "memory_s",
                                        "collective_s")
    assert rep["flops_per_chip"] > 0
    assert rep["coll_breakdown"]["all-gather"] > 0   # per-layer gathers
    assert rep["memory"]["fits"] in (True, False)


def test_dry_run_equals_a_real_two_rank_run():
    real = T.spawn(T.real_cell_ranks, 2, CELLS)
    mesh = DryMesh((2, 1), ("data", "model"))
    for name, cfg, shape in CELLS:
        fn, args, _, _, _ = api.lower_cell(cfg, shape, mesh)
        dry = count_step(fn, args)
        coll = collective_bytes_of(dry["collectives"])
        assert coll["total"] > 0
        for r in real:
            assert r[name]["shapes_ok"], name
            assert r[name]["coll"] == coll, name
            assert r[name]["flops"] == dry["flops"], name


def test_dry_run_of_a_model_split_equals_a_real_two_rank_run():
    real = T.spawn(T.real_cell_ranks, 2, CELLS, (1, 2))
    mesh = DryMesh((1, 2), ("data", "model"))
    for name, cfg, shape in CELLS:
        fn, args, _, _, _ = api.lower_cell(cfg, shape, mesh)
        dry = count_step(fn, args)
        coll = collective_bytes_of(dry["collectives"])
        assert coll["counts"]["reduce-scatter"] > 0, name
        for r in real:
            assert r[name]["shapes_ok"], name
            assert r[name]["coll"] == coll, name
            assert r[name]["flops"] == dry["flops"], name


@pytest.mark.parametrize("name,cfg,shape", CELLS, ids=[c[0] for c in CELLS])
def test_extrapolated_costs_equal_the_direct_count(name, cfg, shape):
    mesh = DryMesh((2, 1), ("data", "model"))
    cfg = dataclasses.replace(cfg, n_layers=3)
    total, outside, body = dryrun.extrapolated_costs(cfg, shape, mesh, 0)
    fn, args, _, _, _ = api.lower_cell(cfg, shape, mesh)
    c = count_step(fn, args)
    direct = (c["flops"], c["hbm_bytes"],
              collective_bytes_of(c["collectives"])["total"])
    assert total == direct
    assert all(b > 0 for b in body[:2])


def test_dry_mesh_is_rank_zero_of_the_production_mesh():
    mesh = DryMesh(*production_shape())
    assert mesh.size == 256 and mesh.rank == 0
    assert mesh.coords == {"data": 0, "model": 0}
    g = mesh.group("model")
    assert isinstance(g, C.DryGroup) and C.size(g) == 16 and C.rank(g) == 0
    assert C.size(mesh.group(("data", "model"))) == 256
    pod = DryMesh(*production_shape(multi_pod=True), rank=511)
    assert pod.coords == {"pod": 1, "data": 15, "model": 15}
    assert C.rank(pod.group(("pod", "data"))) == 31
    assert DryMesh((1, 1), ("data", "model")).group("data") is None


def test_dry_group_collectives_are_logged_and_move_nothing():
    g = C.DryGroup(4, 1)
    x = torch.empty(8, 3, device="meta")
    with C.recording() as log:
        y = C.gather_dim(x, g, 0)
        C.all_reduce_(x, g)
        z = C.all_to_all_rows(x, g)
    assert y.shape == (32, 3) and y.is_meta and z.shape == x.shape
    assert log == [("all-gather", 32 * 3 * 4, 4), ("all-reduce", 96, 4),
                   ("all-to-all", 96, 4)]
    rep = collective_bytes_of(log)
    assert rep["all-gather"] == 384 * 3 / 4 and rep["all-reduce"] == 144
    assert rep["counts"] == {"all-gather": 1, "all-reduce": 1,
                             "all-to-all": 1}


def test_lower_cell_gives_each_rank_its_shards():
    cfg = get_config("llama3_8b")
    mesh = DryMesh(*production_shape())
    fn, args, in_sp, _, _ = api.lower_cell(
        cfg, ShapeConfig("decode_tiny", 1024, 32, "decode"), mesh)
    params, cache, batch = args
    emb = params["embed"]
    assert emb.is_meta
    assert tuple(emb.shape) == sharding.local_shape(
        api.build_cell(cfg, ShapeConfig("d", 1024, 32, "decode"),
                       mesh)[1][0]["embed"].shape, in_sp[0]["embed"], mesh)
    assert batch["tokens"].shape == (2, 1)          # 32 rows over data 16
    assert int(batch["pos"]) == 1023
    k = cache["k"]
    assert k.shape[1] == 2 and k.shape[2] == 1024   # rows only: whole seq
