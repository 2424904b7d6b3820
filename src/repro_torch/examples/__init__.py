"""The user-facing entry points of ``examples/``, on the card.

Each module is the port of one script of the repository's ``examples/``
directory, with the same steps and printouts, and runs as
``python -m repro_torch.examples.<name>``: ``quickstart`` (define,
register, fuse and serve a custom instruction), ``sort_prefix_apps``
(the paper's two applications and the graph partitioner),
``serve_decode`` and ``train_lm`` (the serve and train drivers). Each
takes ``--device`` (default ``cuda``); with no card and no ``--device
cpu`` it raises. On the CPU the kernel steps run their kernels' plain
PyTorch versions (``interpret``).
"""
from __future__ import annotations

import torch


def pick_device(name: str) -> torch.device:
    """The device an example runs on. ``cuda`` needs a visible card and
    raises without one: nothing falls back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is visible; "
                           f"pass --device cpu to run on the CPU")
    return device


def kernel_mode(device: torch.device) -> str:
    """The dispatch mode of an example's kernel steps: the kernels on the
    card, their plain PyTorch versions on the CPU."""
    return "kernel" if device.type == "cuda" else "interpret"
