"""Serve a small model with batched requests: prefill + decode loop.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        --arch hymba-1.5b [--device cpu]

The port of ``examples/serve_decode.py``: the argv of
:func:`repro_torch.launch.serve.main` at the reduced config, with the
device added. On the card the SSM families' prefill launches K4 once a
layer and the MoE router K7 and K3.

With ``--sched`` the decode steps run through the repro_torch.sched
predictive scheduling runtime (deadline accounting against --slo-ms,
EWMA-corrected step predictions, optional replayable --sched-trace
JSONL).
"""
from __future__ import annotations

import argparse

from repro_torch.examples import pick_device
from repro_torch.launch import serve


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="hymba-1.5b")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--sched", action="store_true")
    p.add_argument("--sched-policy", default="edf")
    p.add_argument("--sched-trace", default=None)
    p.add_argument("--slo-ms", type=float, default=50.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    pick_device(args.device)
    argv = ["--arch", args.arch, "--reduced",
            "--batch", str(args.batch), "--prompt-len", "64",
            "--gen", str(args.gen), "--temperature", "0.8",
            "--device", args.device]
    if args.sched:
        argv += ["--sched", "--sched-policy", args.sched_policy,
                 "--slo-ms", str(args.slo_ms)]
        if args.sched_trace:
            argv += ["--sched-trace", args.sched_trace]
    return serve.main(argv)


if __name__ == "__main__":
    main()
