"""The ``serve`` driver: a closed loop of batches through the port's server.

Each request batch goes the way ``repro_torch.launch.serve.generate``
takes it: ``serve.prefill`` (prefill, the cache grown to prompt + gen
positions, the first token greedy, ending in a synchronize), then
``models.model.decode_step`` and ``serve.sample`` for each further token.
A CUDA event is recorded as each token is sampled, with no synchronize
between steps, so the gap between two events is the time between two
output tokens on the device's clock.

Set-up makes the weights from the seed (:mod:`.weights`) and runs one
batch of warm-up prompts (another stream of the seed) through the same
calls, with two decode steps where the mix decodes: every step of the
window has the same shapes. The window sends batch after batch until
``seconds`` have passed; a batch started in the window is finished.
Where the program's cache holds a state after the prompt, the rows that
the check may compare keep a copy of it, only in the batches that the
seeded sample (:class:`.traffic.CheckSample`) holds at the time, so the
harness holds the same memory however fast the window runs.

The check (:meth:`Serve.check`) runs the family's plain reference
(``perfbench/reference/<family>.py``) over the sampled requests, after
the window, with the program's caches freed.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from . import traffic, weights
from .trace import span


@dataclasses.dataclass
class Batch:
    index: int
    rows: int
    prompt_len: int
    gen: int
    tokens: torch.Tensor                 # (rows, gen) int32 served
    step_s: list                         # seconds between output tokens
    states: dict                         # row → (L, H, P, N) state kept
    kept: bool = False                   # in the check's sample


def _stamp(device):
    if device.type == "cuda":
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    return time.perf_counter()


def _gaps(stamps, device) -> list:
    if device.type == "cuda":
        return [a.elapsed_time(b) * 1e-3 for a, b in zip(stamps, stamps[1:])]
    return [b - a for a, b in zip(stamps, stamps[1:])]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Serve:
    """One cell's program, traffic and check."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed = config, mix, seed
        self.model = config["model"]
        self.device = torch.device(device)
        self.ref = weights.family(self.model)
        self.sample = traffic.CheckSample(mix, seed)

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.configs.base import ModelConfig
        from repro_torch.launch import serve
        from repro_torch.models import model as M
        from repro_torch.models.params import abstract_params
        self.serve, self.M = serve, M
        self.cfg = ModelConfig(**self.model)
        self.params = weights.make(self.model, self.seed, self.device)
        weights.check(self.params, abstract_params(self.cfg))
        warm = traffic.prompts(self.mix, self.model["vocab"], self.seed, 0,
                               self.device, stream="warm")
        self.request(warm, gen_steps=min(self.mix["gen"], 3))
        _sync(self.device)

    # -- one request batch ----------------------------------------------------
    def request(self, prompts: torch.Tensor, gen_steps: int | None = None,
                keep_rows=()):
        """Serve one batch: (tokens (B, gen) int32, seconds between output
        tokens, {row: state after the prompt})."""
        serve, M = self.serve, self.M
        gen = self.mix["gen"]
        steps = gen if gen_steps is None else gen_steps
        plen = prompts.shape[1]
        with span("serve.prefill"):
            tok, cache, _ = serve.prefill(self.cfg, self.params, prompts, gen)
        stamps = [_stamp(self.device)]
        states = {r: cache["state"][:, r].clone() for r in keep_rows} \
            if "state" in cache else {}
        out = [tok]
        for i in range(steps - 1):
            with span("decode_step"):
                logits, cache = M.decode_step(self.cfg, self.params, cache,
                                              tok, plen + i)
            with span("serve.sample"):
                tok = serve.sample(logits, None, 0.0)
            out.append(tok)
            stamps.append(_stamp(self.device))
        del cache
        _sync(self.device)
        return torch.cat(out, dim=1), _gaps(stamps, self.device), states

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float, min_batches: int = 1
               ) -> tuple[list, float]:
        """Batches until ``seconds`` have passed and at least
        ``min_batches`` are done: (batches, window s)."""
        batches = []
        t0 = time.perf_counter()
        i = 0
        while True:
            p = traffic.prompts(self.mix, self.model["vocab"], self.seed, i,
                                self.device)
            kept, out = self.sample.offer(i)
            if out is not None:
                batches[out].states.clear()
                batches[out].kept = False
            rows = traffic.check_rows(self.mix, self.seed, i) if kept else ()
            with span("request"):
                toks, gaps, states = self.request(p, keep_rows=rows)
            done = time.perf_counter() - t0
            batches.append(Batch(i, p.shape[0], p.shape[1], self.mix["gen"],
                                 toks, gaps, states, kept))
            i += 1
            if done >= seconds and i >= min_batches:
                return batches, done

    # -- the check ------------------------------------------------------------
    def free(self) -> None:
        """Drop what the program holds beyond the weights."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, batches: list, against: str | None = None) -> dict:
        """The numbers that decide ``correct``, over the batches that the
        seeded sample holds (the family's ``WHOLE_BATCH`` runs their
        sampled rows as one call, else a row at a time): ``token_gap``,
        the widest gap by which a served token's reference logit lies
        below the reference's best, ``token_gap_mean``, the mean of those
        gaps over every served token compared, and, where the reference
        returns a state after the prompt, ``state_err``, the largest
        relative distance (the (P, N) state of one head, layer and row)
        between the program's state and the reference's.

        With ``against`` (a lower precision), the control instead: the
        reference computed in that precision takes the program's place,
        at the same prompts and served tokens; its token at a position is
        the one it puts first."""
        ref = self.ref
        from perfbench.reference.layers import no_tf32
        no_tf32()
        gaps, errs = [], []
        for b in batches:
            if not b.kept:
                continue
            p = traffic.prompts(self.mix, self.model["vocab"], self.seed,
                                b.index, self.device)
            rows = traffic.check_rows(self.mix, self.seed, b.index)
            groups = [rows] if ref.WHOLE_BATCH else [[r] for r in rows]
            for g in groups:
                with torch.no_grad():
                    want = ref.forward(self.model, self.params, p[g],
                                       b.tokens[g], "fp32")
                    got = (ref.forward(self.model, self.params, p[g],
                                       b.tokens[g], against)
                           if against else None)
                lg = want["logits"]
                if got is None:
                    served = b.tokens[g].long()
                else:
                    served = got["logits"].argmax(-1)
                picked = lg.gather(-1, served[..., None])[..., 0]
                gaps.append((lg.amax(-1) - picked).flatten())
                if "state" in want:
                    errs.append(_state_err(
                        got["state"] if got is not None else
                        torch.stack([b.states[r] for r in g], 1),
                        want["state"]))
                del want, got
        gaps = torch.cat(gaps)
        out = {"token_gap": float(gaps.max()),
               "token_gap_mean": float(gaps.mean())}
        if errs:
            out["state_err"] = max(errs)
        return out


def _state_err(mine: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest relative distance of one (P, N) state (a head, layer
    and row) from the reference's."""
    d = (mine.float() - ref).flatten(3).norm(dim=-1)
    n = ref.flatten(3).norm(dim=-1).clamp_min(1e-30)
    return float((d / n).max())
