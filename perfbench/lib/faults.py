"""Faults planted in the program underneath the timed path, to show that
the check catches each fault a cell can have (the CPU tests of
``perfbench/tests/test_perfbench_faults.py`` at a reduced size, and
``perfbench/control.py --fault`` at a cell's own size on the card).

- ``token_altered``: a served token altered where it is produced
  (``serve.sample`` picks the next id after the greedy one);
- ``scan_unchanged``: the SSD's carried state scan (K4) returns its
  states unchanged;
- ``da_dropped``: K4's reverse walk returns a zero gradient for the
  chunks' decays (da), so the state carried across chunks adds nothing
  to the gradients of ``A_log``, ``dt_bias`` and ``w_dt`` (read on the
  card only: the CPU runs the SSD's plain path, without K4, and at a
  reduced size the carried state's share of those gradients is small);
- ``state_unchanged``: a training step returns its state unchanged;
- ``half_batch``: half of the batch left out of the loss, the mean taken
  over the rest.
"""
from __future__ import annotations

import contextlib


def _alter_token(patch):
    from repro_torch.launch import serve
    sample = serve.sample
    patch(serve, "sample", lambda logits, generator, temperature: (
        sample(logits, generator, temperature) + 1) % logits.shape[-1])


def _scan_unchanged(patch):
    from repro_torch.kernels import ops
    patch(ops, "chunk_scan_state", lambda a, b, axis=1, mode=None: b.clone())


def _da_dropped(patch):
    import torch
    from repro_torch.kernels import prefix_scan
    grad = prefix_scan.state_scan_grad

    def dropped(*a, **k):
        da, lam = grad(*a, **k)
        return torch.zeros_like(da), lam
    patch(prefix_scan, "state_scan_grad", dropped)


def _state_unchanged(patch):
    from repro_torch.launch import api
    make = api.make_train_step

    def unchanged(*a, **k):
        step = make(*a, **k)
        return lambda state, batch: (state, step(state, batch)[1])
    patch(api, "make_train_step", unchanged)


def _half_batch(patch):
    from repro_torch.models import model
    loss_fn = model.loss_fn

    def half(cfg, params, batch, *a, **k):
        rows = batch["tokens"].shape[0] // 2
        return loss_fn(cfg, params, {n: v[:rows] for n, v in batch.items()},
                       *a, **k)
    patch(model, "loss_fn", half)


FAULTS = {"token_altered": _alter_token, "scan_unchanged": _scan_unchanged,
          "da_dropped": _da_dropped, "state_unchanged": _state_unchanged,
          "half_batch": _half_batch}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault ``name`` in it, put back on exit."""
    undo = []

    def patch(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)
    FAULTS[name](patch)
    try:
        yield
    finally:
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)
