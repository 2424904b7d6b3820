"""Batched serving: prefill a prompt batch, then decode tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch kimi-k2-1t \\
        --reduced --device cpu --batch 4 --prompt-len 64 --gen 32

The port of ``src/repro/launch/serve.py`` on one device: random params
from ``--seed``, random prompts from the same seed, a prefill that
builds the decode cache, the cache grown to prompt + gen positions, then
a decode loop (greedy at ``--temperature 0``). It runs on the GPU
(``--device cuda``, the default) or, at a small size, on the CPU. Every
family is served: dense, MoE, ``ssm`` (``--arch mamba2-1.3b``) and
``hybrid`` (``--arch hymba-1.5b``). On CUDA tensors the model's
instructions launch their kernels: K7 top-k and K3 prefix sum in the MoE
router, K4 in the SSM mixer's inter-chunk state scan (one launch a layer
in prefill), and K8 attention where ``attn_impl`` is ``"kernel"`` (this
entry point keeps the reference's ``attn_impl="chunked"``).

With ``--sched`` the decode steps are driven through the
:mod:`repro_torch.sched` scheduling runtime: each step is submitted to
the request queue with a per-token latency deadline (``--slo-ms``), run
by the scheduler on the wall clock (the step ends in a synchronize, so
its time is the token's latency), and its observed time fed back to the
EWMA cost model; ``--sched-trace`` records the run as a replayable JSONL
trace.

Observability: ``--metrics PORT`` serves the metrics registry over HTTP
(Prometheus text at ``/metrics``, a JSON snapshot at ``/metrics.json``)
for the run, and ``--metrics-hold`` keeps it up afterwards;
``--obs-trace PATH`` activates the span tracer and writes the run's
Chrome-trace JSON to PATH, and a modeled-vs-observed drift report is
printed after a ``--sched`` run. ``--obs-tail PATH`` keeps every
SLO-breaching, erroring or p99 request tree at a 1% baseline rate and
writes them to PATH; ``--slo-shed`` feeds completions into per-tenant
burn-rate windows and sheds a burning tenant's new arrivals at
admission; with a tracer active a per-tenant blame report is printed
after a ``--sched`` run. The endpoint, the tracer and the plan cache
(``--plan-cache``) are the process's for the run and are put back after
it.

``--model-parallel M`` serves on ``make_elastic_mesh(model_parallel=M)``
over the ranks of ``torch.distributed`` (started from the environment
as the train driver does; a world of one is the trivial mesh) and prints
``mesh <shape>`` as the reference does. Each rank draws only its shards
of the params (``init_params(mesh=)``), which every layer gathers over
its FSDP axes as the walk reaches it, keeping its ``model`` blocks: the
dense layers' compute is split over ``model`` (each rank its heads, FFN
columns and vocabulary block; the logits gathered before sampling). It
serves its (pod, data) rows of the prompts, and the tokens are gathered
on every rank (rank 0 prints them). ``--sched`` and
``--slo-shed`` are kept: each rank's wall clock would shed other steps
and the ranks' collectives would no longer meet, so with more than one
rank the admission is rank 0's (:class:`RankZeroAdmission`): its SLO
monitor decides each step and the verdict is broadcast over the world
before the step runs.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import batch_axes
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_elastic_mesh, mesh_name
from repro_torch.models import model as M
from repro_torch.models.params import (abstract_params, init_params,
                                       logical_axes)


def grow_cache_fn(cfg, prefill_len, capacity):
    """Close over the static sizes: a function of the cache that grows
    it from ``prefill_len`` to ``capacity`` positions."""
    def f(cache):
        return M.grow_cache(cfg, cache, prefill_len, capacity)
    return f


def sample(logits: torch.Tensor, generator: torch.Generator | None,
           temperature: float) -> torch.Tensor:
    """(B, vocab) logits → (B, 1) int32 tokens: argmax at temperature 0,
    else a draw from softmax(logits / T) with ``generator``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill(cfg, params: dict, prompts: torch.Tensor, gen: int,
            temperature: float = 0.0,
            generator: torch.Generator | None = None):
    """Prefill ``prompts`` (B, P) int and grow the cache to P + ``gen``
    positions. Returns (first token (B, 1) int32, cache, host wall
    seconds ending in a synchronize on CUDA)."""
    prompt_len = prompts.shape[1]
    t0 = time.perf_counter()
    logits, cache = M.prefill(cfg, params, {"tokens": prompts})
    cache = grow_cache_fn(cfg, prompt_len, prompt_len + gen)(cache)
    tok = sample(logits, generator, temperature)
    _sync(prompts.device)
    return tok, cache, time.perf_counter() - t0


def generate(cfg, params: dict, prompts: torch.Tensor, gen: int,
             temperature: float = 0.0,
             generator: torch.Generator | None = None):
    """Prefill ``prompts`` (B, P) int, then decode to ``gen`` new tokens
    per row. Returns (tokens (B, gen) int32, prefill seconds, decode
    seconds): host wall time, each ending in a synchronize on CUDA."""
    prompt_len = prompts.shape[1]
    tok, cache, t_prefill = prefill(cfg, params, prompts, gen, temperature,
                                    generator)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = M.decode_step(cfg, params, cache, tok, prompt_len + i)
        tok = sample(logits, generator, temperature)
        out.append(tok)
    _sync(prompts.device)
    return torch.cat(out, dim=1), t_prefill, time.perf_counter() - t0


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="llama3-8b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--sched", action="store_true",
                   help="drive decode steps through the repro_torch.sched "
                        "runtime (queue + cost model + scheduler)")
    p.add_argument("--sched-policy", default="edf",
                   help="scheduling policy with --sched (edf|wfq|fifo)")
    p.add_argument("--sched-trace", default=None, metavar="PATH",
                   help="record the scheduling run as replayable JSONL")
    p.add_argument("--sched-lanes", type=int, default=1, metavar="N",
                   help="with --sched: scheduler lane count (decode steps "
                        "are sequential, so >1 only widens rounds for "
                        "concurrent tenants)")
    p.add_argument("--sched-channels", type=int, default=None, metavar="N",
                   help="with --sched: model N HBM channels — lanes map "
                        "round-robin onto channels and a round's DRAM "
                        "demand serialises per channel instead of on one "
                        "shared interface")
    p.add_argument("--slo-ms", type=float, default=50.0,
                   help="per-token latency deadline with --sched")
    p.add_argument("--plan-cache", default=None, metavar="DIR",
                   help="persistent compiled-plan artifact dir: negotiated "
                        "geometries and partitioned plans are loaded from "
                        "/ published to DIR, so a restarted or replicated "
                        "server skips the cold compile work; equivalent to "
                        "REPRO_PLAN_CACHE in the environment")
    p.add_argument("--metrics", type=int, default=None, metavar="PORT",
                   help="serve the metrics registry over HTTP on PORT "
                        "(0: a free port): Prometheus text at /metrics, "
                        "JSON snapshot at /metrics.json")
    p.add_argument("--metrics-hold", type=float, default=0.0, metavar="SEC",
                   help="with --metrics: keep the process (and endpoint) "
                        "alive SEC seconds after the run so scrapers can "
                        "fetch the final state")
    p.add_argument("--obs-trace", default=None, metavar="PATH",
                   help="activate the span tracer and write the run's "
                        "Chrome-trace JSON to PATH (open in Perfetto / "
                        "chrome://tracing)")
    p.add_argument("--obs-tail", default=None, metavar="PATH",
                   help="tail-based trace sampling: record every request "
                        "tree provisionally, keep the ones that breach the "
                        "--slo-ms target, error, or land in the rolling p99 "
                        "(plus a 1%% head baseline), and write the kept "
                        "trees' JSONL to PATH; implies the span tracer")
    p.add_argument("--slo-shed", action="store_true",
                   help="with --sched: feed completions into a per-tenant "
                        "SLO burn-rate monitor (--slo-ms target) and shed "
                        "new arrivals of any tenant burning its error "
                        "budget on both the fast and slow windows; off by "
                        "default")
    p.add_argument("--region-slots", type=int, default=None, metavar="N",
                   help="with --sched: bound each lane to N configured-"
                        "region slots (repro_torch.regions); non-resident "
                        "placements charge a measured reconfiguration "
                        "penalty. 0 tracks residency without bounding; "
                        "omit to disable regions")
    p.add_argument("--region-policy", default="lru",
                   choices=("lru", "reuse"),
                   help="residency eviction policy with --region-slots: "
                        "lru baseline or EWMA predicted-reuse")
    args = p.parse_args(argv)

    with contextlib.ExitStack() as stack:
        if args.plan_cache:
            from repro_torch.core.artifact import using_plan_cache
            stack.enter_context(using_plan_cache(args.plan_cache))
        httpd = None
        if args.metrics is not None:
            from repro_torch.obs import metrics as obs_metrics
            httpd = obs_metrics.start_http_server(args.metrics)
            stack.callback(httpd.server_close)
            stack.callback(httpd.shutdown)
            host, port = httpd.server_address[:2]
            print(f"metrics http://{host}:{port}/metrics "
                  f"(+ /metrics.json)")
        tracer = None
        sampler = None
        if args.obs_trace or args.obs_tail:
            from repro_torch.obs import trace as obs_trace
            tracer = obs_trace.Tracer()
            stack.enter_context(obs_trace.using_tracer(tracer))
            if args.obs_tail:
                from repro_torch.obs.tail import TailSampler
                sampler = TailSampler(tracer, sample_rate=0.01,
                                      slo_s=args.slo_ms * 1e-3)
        return _serve(args, tracer, sampler, httpd)


def _serve(args, tracer, sampler, httpd):
    from repro_torch.launch.train import init_world
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, attn_impl="chunked")
    init_world(args.device)
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_elastic_mesh(model_parallel=args.model_parallel)
    print(f"mesh {mesh_name(mesh)}")
    specs = sharding.tree_specs(logical_axes(cfg), abstract_params(cfg),
                                 mesh)
    g = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, g, device, mesh, specs)
    prompts = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (args.batch, args.prompt_len)))
    rows = batch_axes(mesh)
    prompts = sharding.local_shard(prompts, (rows or None, None),
                                   mesh).to(device)

    with sharding.use(mesh, specs):
        if args.sched:
            tok, cache, t_prefill = prefill(cfg, params, prompts, args.gen,
                                            args.temperature, g)
        else:
            gen, t_prefill, dt = generate(cfg, params, prompts, args.gen,
                                          args.temperature, g)
        print(f"prefill {args.batch}×{args.prompt_len} in "
              f"{t_prefill*1e3:.1f} ms "
              f"({args.batch*args.prompt_len/t_prefill:.0f} tok/s)")
        if args.sched:
            gen, dt = _decode_scheduled(args, cfg, params, cache, tok, g,
                                        mesh)
    print(f"decoded {args.gen} tokens × batch {args.batch} in "
          f"{dt*1e3:.1f} ms ({args.batch*(args.gen-1)/max(dt,1e-9):.0f} tok/s)")
    if mesh.size > 1:
        gen = C.gather_dim(gen.contiguous(), mesh.group(rows), 0)
    gen = gen.cpu().numpy()
    print("sample row:", gen[0][:16], "...")
    if tracer is not None and args.obs_trace:
        with open(args.obs_trace, "w") as f:
            f.write(tracer.export_chrome())
        print(f"obs trace ({len(tracer.spans)} spans) -> {args.obs_trace}")
    if sampler is not None:
        with open(args.obs_tail, "w") as f:
            f.write(sampler.export_jsonl())
        st = sampler.stats()
        print(f"obs tail: kept {st['kept']}/{st['seen']} trees "
              f"({st['by_reason']}) -> {args.obs_tail}")
    if tracer is not None and args.sched:
        from repro_torch.obs import critical
        blames = critical.attribute(tracer)
        if blames:
            print(critical.format_report(blames))
    if httpd is not None and args.metrics_hold > 0:
        print(f"holding metrics endpoint {args.metrics_hold:.0f}s",
              flush=True)
        time.sleep(args.metrics_hold)
    return gen


class RankZeroAdmission:
    """The admission hook of every rank of a mesh: rank 0's ``inner``
    hook decides (its wall clock, its SLO monitor) and its verdict is
    broadcast over the world, so every rank admits and sheds the same
    steps and their collectives keep meeting. The other ranks' ``inner``
    hooks are not consulted."""

    VERDICTS = ("accept", "shed", "deprioritise")

    def __init__(self, inner, mesh):
        self.inner = inner
        self.mesh = mesh
        self.weight_factor = getattr(inner, "weight_factor", 0.25)

    def admit(self, tenant: str, now: float) -> str:
        code = torch.zeros(1, dtype=torch.int32)
        if self.mesh.rank == 0:
            code[0] = self.VERDICTS.index(self.inner.admit(tenant=tenant,
                                                           now=now))
        C.broadcast_(code, self.mesh.group(self.mesh.axis_names))
        return self.VERDICTS[int(code[0])]


def _decode_scheduled(args, cfg, params, cache, tok, generator, mesh):
    """The decode loop as scheduling-runtime clients.

    Decode steps are sequentially dependent (the cache, the sampled
    token), so each is submitted as it becomes ready and drained at once
    — what the runtime adds is admission, deadline accounting against
    the ``--slo-ms`` per-token budget, EWMA-corrected per-step
    predictions and the replayable trace. Returns (tokens (B, n) int32,
    decode seconds); a step shed at admission adds no token. On a mesh
    of more than one rank, admission is rank 0's
    (:class:`RankZeroAdmission`).
    """
    from repro_torch.sched import (CostModel, RequestQueue, Scheduler,
                                   TraceRecorder)

    slo = args.slo_ms * 1e-3
    monitor = None
    if args.slo_shed:
        # completions feed per-tenant burn-rate windows; a tenant burning
        # both windows has its NEW arrivals shed at admission. Windows
        # scale with the per-token target so the fast window holds ~20
        # steps of signal.
        from repro_torch.obs.slo import SloMonitor, SloShedder
        monitor = SloMonitor(threshold=2.0)
        monitor.add("decode", target_s=slo, objective=0.9,
                    fast_s=20 * slo, slow_s=200 * slo)
        admission = SloShedder(monitor)
        if mesh.size > 1:
            admission = RankZeroAdmission(admission, mesh)
        queue = RequestQueue(admission=admission)
    else:
        queue = RequestQueue()
    cost = CostModel()
    recorder = TraceRecorder() if args.sched_trace else None
    sched = Scheduler(queue, cost=cost, policy=args.sched_policy,
                      n_lanes=args.sched_lanes, clock="wall",
                      recorder=recorder,
                      region_slots=args.region_slots,
                      region_policy=args.region_policy,
                      n_channels=args.sched_channels,
                      slo=monitor)

    state = {"cache": cache, "tok": tok}
    device = tok.device

    def step(i):
        logits, state["cache"] = M.decode_step(cfg, params, state["cache"],
                                               state["tok"],
                                               args.prompt_len + i)
        state["tok"] = sample(logits, generator, args.temperature)
        _sync(device)
        return state["tok"]

    out_tokens = [tok]
    t0 = time.perf_counter()
    shed_steps = []
    for i in range(args.gen - 1):
        now = sched.now()
        it = queue.submit(step, (i,), deadline=now + slo, tenant="decode",
                          arrival=now, cost_key=("decode_step", args.arch))
        if it.shed:
            # admission dropped the step: no token this position — the
            # decode chain resumes at the next admitted step
            shed_steps.append(i)
            continue
        sched.drain()
        out_tokens.append(state["tok"])
    dt = time.perf_counter() - t0

    rep = sched.report()
    if rep.placements:
        obs = sorted(p.observed_s for p in rep.placements)
        tail = rep.placements[len(rep.placements) // 2:]
        err = sorted(abs(p.predicted_s - p.observed_s)
                     / max(p.observed_s, 1e-9) for p in tail)
        print(f"sched[{args.sched_policy}]: {len(rep.placements)} steps, "
              f"{len(rep.missed)} past the {args.slo_ms:.0f} ms SLO, "
              f"median step {obs[len(obs)//2]*1e3:.1f} ms, "
              f"EWMA prediction error (2nd half) "
              f"{err[len(err)//2]*100:.0f}%")
    if sched.regions is not None:
        r = sched.regions.report()
        lane0 = r["lanes"][0]
        print(f"regions[{r['policy']}]: {r['slots'] or 'unbounded'} "
              f"slots/lane, lane0 hit ratio {lane0['hit_ratio']:.2f} "
              f"({lane0['hits']} hits / {lane0['loads']} loads / "
              f"{lane0['evictions']} evictions), "
              f"{r['swap_seconds']*1e3:.2f} ms charged to reconfig")
    if monitor is not None:
        print(monitor.report(now=sched.now()))
        if shed_steps:
            print(f"slo-shed: {len(shed_steps)} decode steps shed at "
                  f"admission: {shed_steps}")
    if recorder is not None:
        recorder.dump(args.sched_trace)
        print(f"sched trace ({len(recorder.events)} events) -> "
              f"{args.sched_trace}")
    if cost.drift_report(min_samples=1):
        print(cost.drift.format_report(top=5, min_samples=1))
    return torch.cat(out_tokens, dim=1), dt


if __name__ == "__main__":
    main()
