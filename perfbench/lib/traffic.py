"""The one generator of traffic: a mix's parameters in, seeded batches out.

A mix is a data file ``perfbench/traffic/<name>.json``:

- ``kind``: the driver that runs it (``serve``: prefill and greedy
  decode through the port's server, :mod:`.serve`; ``train``: steps of
  the port's trainer, :mod:`.train`);
- ``loop``: ``closed`` (one client; the next batch is sent when the last
  one has finished);
- ``batch``, ``prompt_len``, ``gen``: rows a batch, prompt tokens a row,
  tokens served a row (the first one by prefill); for ``train``,
  ``batch`` and ``seq_len``: rows a step and tokens a row;
- ``ids``: ``uniform`` (prompt ids uniform over the vocabulary);
- ``check``: ``batches`` and ``rows`` of finished requests that the
  check compares with the plain reference, drawn from the seed; for
  ``train``, the first ``steps`` that the reference follows.

Every seed gets the same sizes and the same number of batches' worth of
work; the seed changes only the ids and the weights.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

from .weights import stream_seed

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("serve", "train")
LOOPS = ("closed",)
ID_LAWS = ("uniform",)


def load(name: str) -> dict:
    mix = json.loads((ROOT / "traffic" / f"{name}.json").read_text())
    if mix["kind"] not in KINDS or mix["loop"] not in LOOPS \
            or mix["ids"] not in ID_LAWS:
        raise ValueError(f"traffic {name}: unknown kind, loop or ids law")
    return mix


def prompts(mix: dict, vocab: int, seed: int, index: int, device,
            stream: str = "prompts") -> torch.Tensor:
    """Batch ``index`` of the mix's prompts, (batch, prompt_len) int64,
    made on ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream, index))
    return torch.randint(0, vocab, (mix["batch"], mix["prompt_len"]),
                         generator=gen, device=device)


def check_rows(mix: dict, seed: int, index: int) -> list[int]:
    """The rows of batch ``index`` that the check may compare."""
    b, want = mix["batch"], mix["check"]["rows"]
    if want >= b:
        return list(range(b))
    g = torch.Generator().manual_seed(stream_seed(seed, "check rows", index))
    return sorted(torch.randperm(b, generator=g)[:want].tolist())


class CheckSample:
    """The finished batches that the check compares: ``check.batches`` of
    them, drawn from the seed, uniform over every batch the window
    finishes (a reservoir). Each batch is offered as it starts, so a run
    keeps what the check needs of at most that many batches at any time,
    however many the window finishes."""

    def __init__(self, mix: dict, seed: int):
        self.size = mix["check"]["batches"]
        self.kept: list[int] = []
        self.gen = torch.Generator().manual_seed(
            stream_seed(seed, "check batches"))

    def offer(self, index: int) -> tuple[bool, int | None]:
        """Batch ``index`` (offered in order from 0): (whether it is kept,
        the kept batch it displaces or None)."""
        if len(self.kept) < self.size:
            self.kept.append(index)
            return True, None
        j = int(torch.randint(index + 1, (1,), generator=self.gen))
        if j >= self.size:
            return False, None
        out, self.kept[j] = self.kept[j], index
        return True, out
