"""End-to-end training entry point (``src/repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
        --reduced --device cpu --steps 20
    torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
        --arch kimi-k2-1t --reduced --model-parallel 2

Random params from ``--seed``, synthetic (``SyntheticLMData``) or
file-backed (``--data``, a flat int32 token file) batches, the
functional train step of :mod:`repro_torch.launch.api`, async
checkpointing with a preemption handler, and resume from the latest
checkpoint in ``--ckpt-dir`` on any mesh whose axes divide the dims. It
runs on the GPU (``--device cuda``, the default) or, at a small size, on
the CPU; nothing falls back from one to the other. On CUDA tensors the
model's instructions launch their kernels, forward and backward: K4 in
the SSM mixer (its reverse walk in the backward), K7 and K3 in the MoE
router. The reference's ``attn_impl="chunked"`` is kept, so attention
launches no K8.

The mesh is ``make_elastic_mesh(model_parallel=--model-parallel)`` over
the ranks of ``torch.distributed`` (one rank per process; a world of one
is the trivial mesh). When the environment names a world of more than
one rank (``torchrun``'s ``WORLD_SIZE``) and no process group is up,
it is started: NCCL for ``--device cuda`` (one card a rank, by
``LOCAL_RANK``), gloo for the CPU. The state is made sharded (each rank
draws only its shards, ``init_params(mesh=)``), batches are each rank's
rows (``make_global_batch``), the dense layers' compute is split over
``model`` (``sharding.ModelSplit``), and checkpoints are gathered leaf by
leaf to their logical arrays, which rank 0 alone copies to the host and
writes. On a mesh a SIGTERM is noted by the rank that receives it, and
every rank saves together at the end of the step (the ranks agree on it
after each step), since a save is a collective. ``--pod-sync-every N``
averages the params over the mesh's ``pod`` axis with the int8 ring
every N steps (``make_pod_sync``); the elastic mesh has no ``pod`` axis,
so it syncs nothing there, as in the reference.

Prints ``mesh <shape> axes <names> (<n> devices)`` first, then ``step N
loss L gnorm G T tok/s`` every ``--log-every`` steps (rank 0),
``resumed from step N on mesh <shape>`` on a resume and ``done: final
loss L`` at the end, as the reference does.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_sharded)
from repro_torch.configs import SHAPES, get_config
from repro_torch.data import SyntheticLMData, TokenFileData, make_global_batch
from repro_torch.distributed.collectives import compressed_ring_allreduce
from repro_torch.launch import api
from repro_torch.launch.mesh import make_elastic_mesh, mesh_name, world
from repro_torch.models.params import init_params, tree_map


def make_pod_sync(mesh):
    """Compressed cross-pod parameter averaging (the outer sync step):
    each param shard through :func:`compressed_ring_allreduce` over the
    ``pod`` ranks, divided by their number. None without a ``pod``
    axis."""
    if "pod" not in mesh.axis_names:
        return None
    n_pods = mesh.shape["pod"]
    group = mesh.group("pod")

    def sync(params):
        def one(x):
            s = compressed_ring_allreduce(x.float(), group)
            return (s / n_pods).to(x.dtype)
        return tree_map(one, params)
    return sync


def init_world(device: str) -> None:
    """Start ``torch.distributed`` from the environment when it names a
    world of more than one rank and no process group is up."""
    import torch.distributed as dist
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")


def _say(*args, **kw):
    if world()[1] == 0:
        print(*args, **kw)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="llama3-8b")
    p.add_argument("--reduced", action="store_true",
                   help="tiny same-family config (CPU-runnable)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--data", default=None,
                   help="token .bin file (else synthetic)")
    p.add_argument("--pod-sync-every", type=int, default=0,
                   help=">0: DiLoCo-style compressed cross-pod parameter "
                        "averaging every N steps (needs a 'pod' mesh axis)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, attn_impl="chunked")
    init_world(args.device)
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_elastic_mesh(model_parallel=args.model_parallel)
    print(f"mesh {mesh_name(mesh)} axes {mesh.axis_names} "
          f"({mesh.size} devices)")
    print(f"device {device} ({cfg.name}, {cfg.n_layers} layers)")

    shape = dataclasses.replace(
        SHAPES["train_4k"], seq_len=args.seq, global_batch=args.batch)
    specs = api.state_specs(cfg, mesh)
    step_fn = api.make_train_step(cfg, grad_accum=args.grad_accum,
                                  mesh=mesh, specs=specs)

    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, manifest = restore_sharded(
            args.ckpt_dir, api.make_train_state_abstract(cfg), specs, mesh,
            device)
        start = manifest["step"]
        print(f"resumed from step {start} on mesh {mesh_name(mesh)}")
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        state = api.make_train_state(
            cfg, init_params(cfg, gen, device, mesh, specs["params"]))

    if args.data:
        data = TokenFileData(args.data, shape.seq_len, shape.global_batch,
                             args.seed, mesh=mesh)
    else:
        data = SyntheticLMData(cfg.vocab, shape.seq_len, shape.global_batch,
                               args.seed, mesh=mesh)

    mgr = (CheckpointManager(args.ckpt_dir, specs=specs, mesh=mesh)
           if args.ckpt_dir else None)
    if mgr:
        mgr.install_preemption_handler()
    pod_sync = make_pod_sync(mesh) if args.pod_sync_every > 0 else None
    t0 = time.time()
    metrics = None
    try:
        for step in range(start, args.steps):
            batch = make_global_batch(data.host_batch(step),
                                      shape.global_batch, mesh, device)
            state, metrics = step_fn(state, batch)
            if mgr:
                mgr.observe(step + 1, state)
                mgr.save_if_preempted()     # on a mesh: every rank at once
            if (step + 1) % args.log_every == 0:
                loss = float(metrics["loss"])
                dt = time.time() - t0
                tps = shape.tokens * args.log_every / dt
                _say(f"step {step+1:6d} loss {loss:8.4f} "
                     f"gnorm {float(metrics['grad_norm']):7.3f} "
                     f"{tps:9.0f} tok/s")
                t0 = time.time()
            if pod_sync and (step + 1) % args.pod_sync_every == 0:
                state["params"] = pod_sync(state["params"])
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save_async(step + 1, state)
        if mgr:
            mgr.save_async(args.steps, state)
            mgr.wait()
    finally:
        if mgr:     # the handler and the state it holds end with the run
            mgr.remove_preemption_handler()
    if metrics is None:
        raise ValueError(f"no step to run: the run is at step {start} of "
                         f"{args.steps}")
    final = float(metrics["loss"])
    print(f"done: final loss {final:.4f}")
    return final


if __name__ == "__main__":
    main()
