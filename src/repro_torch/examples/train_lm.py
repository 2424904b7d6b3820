"""End-to-end driver: train a ~40M-param llama-family model on synthetic
data for a few hundred steps, with checkpointing.

    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        [--steps 300] [--tiny] [--device cpu]

The port of ``examples/train_lm.py``: the argv of
:func:`repro_torch.launch.train.main`, with the device added. ``--tiny``
trains the 2-layer reduced Llama-3; without it a ~40M-param Llama-3 (8
layers of 512) is installed in place of the arch's config, where the
train driver looks it up. Attention keeps the driver's chunked path, so
this dense model's step launches none of the ISA's kernels.
Checkpoints go to ``--ckpt-dir`` (default ``repro_torch_train_lm`` in
the temporary directory); a directory holding one resumes from it.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from unittest import mock

from repro_torch.configs import llama3_8b
from repro_torch.examples import pick_device
from repro_torch.launch import train


def config_40m():
    """Llama-3 cut to ~40M params, in float32."""
    return dataclasses.replace(
        llama3_8b.config(), n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab=8192,
        param_dtype="float32", act_dtype="float32", attn_chunk=128)


def main(argv=None) -> float:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--tiny", action="store_true",
                   help="2-layer smoke config instead of ~40M")
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    pick_device(args.device)

    if args.tiny:
        return train.main(["--arch", "llama3-8b", "--reduced",
                           "--steps", str(args.steps), "--batch", "8",
                           "--seq", "128", "--ckpt-dir", args.ckpt_dir,
                           "--device", args.device])
    # ~40M params: exercised through the same full-model code path
    cfg = config_40m()
    with mock.patch.object(train, "get_config", lambda name: cfg):
        return train.main(["--arch", "llama3-8b",
                           "--steps", str(args.steps), "--batch", "4",
                           "--seq", "256", "--ckpt-dir", args.ckpt_dir,
                           "--log-every", "10", "--device", args.device])


if __name__ == "__main__":
    main()
