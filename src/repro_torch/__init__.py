"""repro_torch — the PyTorch + CUDA/Triton port of ``repro`` for the H100.

Mirrors the JAX package's layout (``repro/core/program.py`` ↔
``repro_torch/core/program.py``) and imports nothing of it. Every kernel
the JAX package wrote in Pallas becomes a kernel written by hand for
Hopper; each keeps a plain PyTorch version beside it. Triton is imported
only when a kernel is built, so the package imports without it.

Every module of the JAX package has its port: ``core`` (ISA with its
``define``/``bind_kernel`` API, templates, fused programs with the
generated Triton kernel K1 — shape-changing solo stages included —,
geometry negotiation, plan cache), ``kernels`` (every instruction, K1
and K3–K8), ``memhier``, ``graph``, ``regions``, ``sched``, ``obs``
(spans, metrics, drift, blame, tail sampling, SLOs), ``configs``,
``models`` (every family), ``launch`` (the server, the trainer, the
cells' specs, the mesh and the dry run), ``roofline``, training
(``optim``, ``data``, ``checkpoint``) and ``distributed`` (sharding
rules, collectives with the int8 ring, GPipe). Not yet: dense compute
split over the ``model`` axis (``ROADMAP.md`` Queue 1): each dense layer
is gathered whole on every rank.
"""
