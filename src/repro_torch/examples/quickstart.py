"""Quickstart: define a custom SIMD instruction in ~20 lines (paper Alg. 1).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port of ``examples/quickstart.py``. The paper's usability claim: drop
a few lines into the provided template and get a pipelined, streaming
custom instruction. Here we define ``c7_absmax_scale`` — normalise each
vector block by the running absmax of the stream so far (a *stateful*
streaming op, the kind fixed SIMD ISAs can't express in one instruction)
— register it, validate its kernel (K1, the generated Triton kernel, on
the card; its plain PyTorch version on the CPU) against its oracle, and
call it from a program. Then two tenants submit the fused
``c0_scale``+``c0_add`` region to the scheduler, which coalesces them
into one ``k1_batch_kernel`` launch.

The instruction is registered in a registry of the example's own that
holds the process's ISA besides, so the process-wide one is left as it
was.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch.kernels  # noqa: F401 — registers the c0–c6 ISA
from repro_torch.core import isa
from repro_torch.core.isa import Instruction, OperandSpec
from repro_torch.core.template import KernelTemplate
from repro_torch.examples import kernel_mode, pick_device
from repro_torch.memhier import H100
from repro_torch.sched import CostModel, RequestQueue, Scheduler

# ---- 1. the user code: one block body (the yellow lines in Alg. 1) --------
# The emulator's body works on torch blocks; the card's on Triton tiles.

def body(scalars, ins, carry, step):
    blk = ins[0]
    m = torch.maximum(carry, blk.abs().amax(dim=-1, keepdim=True))
    return (blk / torch.clamp_min(m, 1e-9),), m   # running absmax carries


TRITON_BODY = """
def absmax_scale(x0, carry, step):
    m = tl.maximum(carry, tl.max(tl.abs(x0), axis=1)[:, None])
    return x0 / tl.maximum(m, 1e-9), m
"""

TEMPLATE = KernelTemplate(name="c7_absmax_scale", body=body,
                          n_vec_in=1, n_vec_out=1,
                          carry_cols=1, carry_init=0.0,
                          triton_body=TRITON_BODY)

# ---- 2. the oracle ("the base core runs it in software") -------------------

def ref_block_absmax(x: torch.Tensor, block: int) -> torch.Tensor:
    rows, cols = x.shape
    xb = x.reshape(rows, cols // block, block)
    run = torch.cummax(xb.abs().amax(dim=-1), dim=-1).values
    return (xb / torch.clamp_min(run[..., None], 1e-9)).reshape(rows, cols)


def instruction() -> Instruction:
    return Instruction(
        name="c7_absmax_scale",
        spec=OperandSpec(itype="I'", vector_in=1, vector_out=1),
        ref=lambda x: ref_block_absmax(x, TEMPLATE.block_cols),
        kernel=lambda x, interpret=False: TEMPLATE(x, interpret=interpret),
        pipeline_depth=TEMPLATE.pipeline_depth(),
        doc="streaming blockwise absmax normalisation (stateful demo)")


def registry() -> isa.Registry:
    """A registry holding the process's ISA and this example's
    ``c7_absmax_scale`` (in place of any the process registered)."""
    reg = isa.Registry()
    for name in isa.names():
        reg.register(isa.get(name))
    reg.register(instruction(), overwrite=True)
    return reg


def normal(seed: int, shape, device) -> torch.Tensor:
    """float32 from seeded numpy, drawn in float64 as the reference's."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(device)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = pick_device(args.device)
    mode = kernel_mode(device)

    # ---- 3. register + use --------------------------------------------------
    reg = registry()
    x = normal(0, (8, 1024), device)
    ker = reg.call("c7_absmax_scale", x, mode=mode)
    oracle = reg.call("c7_absmax_scale", x, mode="ref")
    err = float((ker - oracle).abs().max())
    print("instruction registered:", "c7_absmax_scale" in reg)
    print("kernel vs oracle max err:", err)
    if not err < 1e-6:
        raise AssertionError(f"c7_absmax_scale: kernel vs oracle {err}")

    # the ISA inside a program: the port has no jit, so it is a plain call
    # (auto mode: the kernel on the card, the oracle on the CPU)
    def program(v):
        return reg.call("c7_absmax_scale", v).sum()

    total = float(program(x))
    print("program:", total)
    print("registered ISA:", ", ".join(reg.names()))

    # ---- 4. serve concurrent programs through the scheduling runtime ------
    # Two tenants submit fused programs concurrently; the runtime coalesces
    # same-structure requests into one warm launch, predicts each with the
    # memhier cost model (HBM contention included), and reports placements.
    # The H100 preset stands where the reference names its TPU's.
    fused = reg.fuse("c0_scale", "c0_add")      # one reconfigurable region
    y = normal(1, 4096, device)
    b = normal(2, 4096, device)

    queue = RequestQueue()
    queue.submit(fused, (2.0, y, b), tenant="A")  # same structure + scalars
    queue.submit(fused, (2.0, b, y), tenant="B")  # → coalesce into ONE launch
    report = Scheduler(queue, cost=CostModel(hierarchy=H100), policy="wfq",
                       n_lanes=2, mode=mode).drain()
    for pl in report.placements:
        print(f"request {pl.seq}: lane {pl.lane}, coalesced={pl.coalesced}, "
              f"predicted {pl.predicted_s * 1e6:.1f} us")
    want = fused(2.0, y, b, mode="ref")
    if not np.allclose(report.results[0].cpu().numpy(), want.cpu().numpy(),
                       atol=1e-6):
        raise AssertionError("tenant A's result differs from the oracle")
    return {"x": x, "kernel": ker, "oracle": oracle, "program": total,
            "y": y, "b": b, "report": report, "registry": reg}


if __name__ == "__main__":
    main()
