"""How far rounding carries through depth at the reference's random init,
on the CPU: a Llama-3-shaped model 256 wide (8 heads, 2 KV heads, FFN
1024, vocabulary 4096), prefill of 2 × 64 tokens, at several depths.

For each depth it prints the last-position logits' distance, over
their max, of one process in float32 from the same weights in float64,
and of the model split over ``model`` on 2 gloo ranks ((data 1, model
2), SP) in float32 from one process in float32. Both grow by orders of
magnitude a few layers: a deep model at random init is chaotic, so a
split's full-depth logits can be held only loosely, and a tight hold
needs a shallow cut (chip_smoke N7b's float32 two-layer cut).

    PYTHONPATH=src python experiments/tp_depth.py [--depths 2,8,16,32]
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import pickle
import tempfile

import numpy as np
import torch


def config(n_layers: int):
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config("llama3_8b").reduced(), n_layers=n_layers, d_model=256,
        n_heads=8, n_kv_heads=2, head_dim=32, d_ff=1024, vocab=4096)


def tokens() -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, 4096, (2, 64)).astype(np.int32))


def _rank(rank: int, store: str, out: str, n_layers: int, params) -> None:
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.launch import api
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as M
    from repro_torch.models.params import shard_from_numpy
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    cfg = config(n_layers)
    mesh = Mesh((1, 2), ("data", "model"))
    specs = api.state_specs(cfg, mesh)["params"]
    p = shard_from_numpy(params, specs, mesh, "cpu")
    with torch.no_grad(), sharding.use(mesh, specs):
        logits, _ = M.prefill(cfg, p, {"tokens": tokens()})
    dist.destroy_process_group()
    with open(os.path.join(out, f"{rank}.pkl"), "wb") as f:
        pickle.dump(logits.numpy(), f)


def split_logits(n_layers: int, params: dict) -> np.ndarray:
    """Rank 0's logits of the model split over 2 gloo ranks."""
    import torch.multiprocessing as mp
    from repro_torch.models.params import tree_map
    arrays = tree_map(lambda t: t.numpy(), params)
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank, args=(os.path.join(d, "store"), d,
                                        n_layers, arrays),
                           nprocs=2, start_method="spawn")
        with open(os.path.join(d, "0.pkl"), "rb") as f:
            return pickle.load(f)


def main(argv=None) -> None:
    from repro_torch.models import model as M
    from repro_torch.models import params as P
    from repro_torch.models.params import tree_map
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", default="2,8,16,32")
    args = ap.parse_args(argv)
    P.DTYPES.setdefault("float64", torch.float64)
    for n in (int(v) for v in args.depths.split(",")):
        cfg = config(n)
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        with torch.no_grad():
            f32, _ = M.prefill(cfg, params, {"tokens": tokens()})
            c64 = dataclasses.replace(cfg, param_dtype="float64",
                                      act_dtype="float64")
            f64, _ = M.prefill(c64, tree_map(lambda t: t.double(), params),
                               {"tokens": tokens()})
        scale = float(f64.abs().max())
        split = split_logits(n, params)
        print(f"layers {n:3d}: float32 vs float64 "
              f"{float((f32.double() - f64).abs().max()) / scale:.3e}, "
              f"split (1, 2) float32 vs one process "
              f"{float(np.abs(split - f32.numpy()).max()) / scale:.3e}")


if __name__ == "__main__":
    main()
