"""repro_torch — the PyTorch + CUDA/Triton port of ``repro`` for the H100.

Mirrors the JAX package's layout (``repro/core/program.py`` ↔
``repro_torch/core/program.py``) and imports nothing of it. Every kernel
the JAX package wrote in Pallas becomes a kernel written by hand for
Hopper; each keeps a plain PyTorch version beside it. Triton is imported
only when a kernel is built, so the package imports without it.

Ported so far: ``core`` (ISA, templates, fused programs with the
generated Triton kernel K1, geometry negotiation, plan cache),
``kernels`` (every instruction, K1 and K3–K8), ``memhier``, ``graph``,
``regions``, ``sched``, ``obs`` (spans, metrics, drift, blame, tail
sampling, SLOs), ``configs``, ``models`` (every family) and
``launch`` (the server, the trainer, the cells' specs and the mesh),
training (``optim``, ``data``, ``checkpoint``) and ``distributed``
(sharding rules, collectives with the int8 ring, GPipe). Not yet: the
roofline and dry-run tools (``ROADMAP.md`` Queue 1).
"""
