"""End-to-end training entry point (``src/repro/launch/train.py``, on one
device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
        --reduced --device cpu --steps 20

Random params from ``--seed``, synthetic (``SyntheticLMData``) or
file-backed (``--data``, a flat int32 token file) batches, the
functional train step of :mod:`repro_torch.launch.api`, async
checkpointing with a preemption handler, and resume from the latest
checkpoint in ``--ckpt-dir``. It runs on the GPU (``--device cuda``, the
default) or, at a small size, on the CPU; nothing falls back from one to
the other. On CUDA tensors the model's instructions launch their
kernels, forward and backward: K4 in the SSM mixer (its reverse walk in
the backward), K7 and K3 in the MoE router. The reference's
``attn_impl="chunked"`` is kept, so attention launches no K8.

Prints ``step N loss L gnorm G T tok/s`` every ``--log-every`` steps,
``resumed from step N`` on a resume and ``done: final loss L`` at the
end, as the reference does.

Not accepted yet: ``--model-parallel`` > 1 and ``--pod-sync-every`` > 0,
which need the device mesh and the collectives of ``distributed/``
(ROADMAP Queue 1 step 6).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.configs import SHAPES, get_config
from repro_torch.data import SyntheticLMData, TokenFileData, to_device
from repro_torch.launch import api


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
                   help=">0: compressed cross-pod parameter averaging "
                        "(needs the device mesh; not ported yet)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.model_parallel > 1 or args.pod_sync_every > 0:
        raise NotImplementedError(
            "--model-parallel > 1 and --pod-sync-every need the device "
            "mesh of distributed/ (ROADMAP Queue 1 step 6)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, attn_impl="chunked")
    device = torch.device(args.device)
    print(f"device {device} ({cfg.name}, {cfg.n_layers} layers)")

    shape = dataclasses.replace(
        SHAPES["train_4k"], seq_len=args.seq, global_batch=args.batch)
    step_fn = api.make_train_step(cfg, grad_accum=args.grad_accum)

    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, manifest = restore(args.ckpt_dir,
                                  api.make_train_state_abstract(cfg), device)
        start = manifest["step"]
        print(f"resumed from step {start}")
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        state = api.init_train_state(cfg, gen, device)

    if args.data:
        data = TokenFileData(args.data, shape.seq_len, shape.global_batch,
                             args.seed)
    else:
        data = SyntheticLMData(cfg.vocab, shape.seq_len, shape.global_batch,
                               args.seed)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr:
        mgr.install_preemption_handler()
    t0 = time.time()
    metrics = None
    try:
        for step in range(start, args.steps):
            batch = to_device(data.host_batch(step), device)
            state, metrics = step_fn(state, batch)
            if mgr:
                mgr.observe(step + 1, state)
            if (step + 1) % args.log_every == 0:
                loss = float(metrics["loss"])
                dt = time.time() - t0
                tps = shape.tokens * args.log_every / dt
                print(f"step {step+1:6d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f} "
                      f"{tps:9.0f} tok/s")
                t0 = time.time()
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
