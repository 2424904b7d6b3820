"""Deterministic, resumable, host-sharded data pipeline
(``src/repro/data/pipeline.py``).

  * stateless addressing — batch(step) is a pure function of (seed,
    step), so a restart from a checkpoint resumes the stream exactly (the
    cursor is the step; no iterator state to snapshot);
  * host sharding — each process makes only its slice of the global
    batch. On a mesh (the ``mesh`` field) the slice follows the rank's
    (pod, data) coordinate, the "batch" axis of the sharding rules, so
    ranks that differ only in ``model`` get the same rows; without one,
    the rank and world size of ``torch.distributed`` when it is
    initialised, else (0, 1);
  * no cross-host coordination in the data path.

The numpy is the reference's, so both packages give the same batches bit
for bit. :class:`SyntheticLMData` makes a Zipf-ish Markov token stream
with enough structure for loss-goes-down smoke training;
:class:`TokenFileData` memory-maps a flat int32 token file (the
real-corpus path). :func:`to_device` puts a host batch on the device, and
:func:`make_global_batch` puts a rank's rows there after checking that
they are its share of the global batch (torch has no global array to
assemble: a rank's tensors are its rows).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


BATCH_AXES = ("pod", "data")


def batch_axes(mesh) -> tuple[str, ...]:
    """The mesh axes that split the batch's rows."""
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names)


def _process(mesh=None) -> tuple[int, int]:
    """(number of row slices, this process's slice): the (pod, data)
    coordinate on a mesh, else the world's rank."""
    if mesh is not None:
        axes = batch_axes(mesh)
        return mesh.axis_size(axes), (mesh.axis_index(axes) if mesh.size > 1
                                      else 0)
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclasses.dataclass
class SyntheticLMData:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mesh: object = dataclasses.field(default=None, repr=False, compare=False)

    def _host_slice(self) -> tuple[int, int]:
        n, i = _process(self.mesh)
        per = self.global_batch // n
        return i * per, per

    def host_batch(self, step: int) -> dict[str, np.ndarray]:
        """This host's rows of the global batch for `step` (numpy)."""
        start, rows = self._host_slice()
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, start]))
        # Zipf marginals + a short-range repeat structure (learnable)
        z = rng.zipf(1.3, size=(rows, self.seq_len + 1)) % self.vocab
        rep = rng.integers(0, self.vocab, (rows, 1))
        mask = rng.random((rows, self.seq_len + 1)) < 0.15
        toks = np.where(mask, rep, z).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@dataclasses.dataclass
class TokenFileData:
    """Flat binary int32 token file, deterministic strided addressing."""
    path: str
    seq_len: int
    global_batch: int
    seed: int = 0
    mesh: object = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self):
        self._tokens = np.memmap(self.path, dtype=np.int32, mode="r")
        self._n_windows = (len(self._tokens) - 1) // self.seq_len

    def host_batch(self, step: int) -> dict[str, np.ndarray]:
        n, i = _process(self.mesh)
        per = self.global_batch // n
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        idx = rng.integers(0, self._n_windows, (self.global_batch,))
        idx = idx[i * per:(i + 1) * per]
        rows = np.stack([
            self._tokens[j * self.seq_len:(j + 1) * self.seq_len + 1]
            for j in idx])
        return {"tokens": rows[:, :-1].astype(np.int32),
                "targets": rows[:, 1:].astype(np.int32)}


def to_device(batch: dict, device) -> dict:
    """A host batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def make_global_batch(host_batch: dict, global_batch: int, mesh,
                      device) -> dict:
    """A rank's rows of the global batch as tensors on ``device``; raises
    unless they are its share (global_batch over the batch axes)."""
    n = _process(mesh)[0]
    for k, v in host_batch.items():
        if global_batch % n or v.shape[0] != global_batch // n:
            raise ValueError(f"{k}: {v.shape[0]} rows are not 1/{n} of the "
                             f"global batch of {global_batch}")
    return to_device(host_batch, device)
