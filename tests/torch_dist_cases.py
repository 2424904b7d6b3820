"""Rank bodies of the port's multi-rank tests, and the spawner.

Each test spawns ranks with ``torch.multiprocessing`` (start method
``spawn``) on the CPU; they meet in a gloo process group over a
``file://`` store, run one function with the same arguments, and each
pickles its result to a file the parent reads. A rank that raises fails
the spawn (the others are terminated), so a collective error surfaces
as the test's failure. This module imports torch and the port only, so
the children start quickly.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile

import numpy as np
import torch


def _entry(rank: int, world: int, store: str, out_dir: str, fn, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=180))
    try:
        res = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


#: seconds a spawn may take before its ranks are killed and it fails
#: (a collective paired with the wrong one can hang past gloo's timeout)
SPAWN_TIMEOUT = 300


def spawn(fn, world: int, *args) -> list:
    """``fn(rank, *args)`` on ``world`` gloo ranks; their results in rank
    order."""
    import time
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(_entry, args=(world, os.path.join(
            d, "store"), d, fn, args), nprocs=world, start_method="spawn",
            join=False)
        deadline = time.monotonic() + SPAWN_TIMEOUT
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"{fn.__name__} on {world} ranks took "
                                   f"over {SPAWN_TIMEOUT} s")
        out = []
        for r in range(world):
            with open(os.path.join(d, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def np_tree(tree):
    """Tensors → numpy (bf16 as float32) for pickling."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu().numpy()
    return tree


class CoordMesh:
    """A mesh's shape that says which rank it is, with no process groups:
    what a shard's arithmetic reads, for tests without ranks."""

    def __init__(self, shape, names, rank):
        from repro_torch.launch.mesh import AbstractMesh, Mesh
        self._abs = AbstractMesh(shape, names)
        self.axis_names, self.devices_shape = names, tuple(shape)
        self.shape, self.size = self._abs.shape, self._abs.size
        self.coords = dict(zip(names, (int(c) for c in np.unravel_index(
            rank, shape))))
        self._index = Mesh.axis_index

    def axis_size(self, axes):
        return self._abs.axis_size(axes)

    def axis_index(self, axes):
        return self._index(self, axes)


# ---------------------------------------------------------------------------
# collectives, pipeline, pod sync, data and checkpoints (4 ranks)
# ---------------------------------------------------------------------------

def ring_inputs(n: int = 4, size: int = 16384) -> np.ndarray:
    """3·N(0, 1) from the reference ring test's generator seed."""
    return (3 * np.random.default_rng(0).standard_normal((n, size))).astype(
        np.float32)


def gpipe_inputs():
    s, m, d = 4, 6, 16
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((s, d, d)) / np.sqrt(d)).astype(np.float32)
    mbs = rng.standard_normal((m, 2, d)).astype(np.float32)
    return w, mbs


def four_ranks(rank: int, ckpt_dir: str) -> dict:
    from repro_torch.checkpoint import CheckpointManager, restore_sharded
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding
    from repro_torch.distributed.pipeline import gpipe_forward
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import make_pod_sync
    out = {}
    line = Mesh((4,), ("d",))
    # the ring
    x = torch.from_numpy(ring_inputs()[rank])
    out["ring"] = C.compressed_ring_allreduce(x, line.group("d")).numpy()
    # GPipe
    w, mbs = gpipe_inputs()
    stages = Mesh((4,), ("stage",))
    ticks = []

    def stage(wl, xx):
        ticks.append(1)
        return torch.tanh(xx @ wl)
    got = gpipe_forward(stage, torch.from_numpy(w[rank]),
                        torch.from_numpy(mbs), stages.group("stage"), 4)
    out["gpipe"], out["gpipe_ticks"] = got.numpy(), len(ticks)
    # pod sync on (pod 2, data 1, model 2): divergent pods average
    pods = Mesh((2, 1, 2), ("pod", "data", "model"))
    sync = make_pod_sync(pods)
    p = {"w": torch.ones((4, 256)) * (1 + pods.coords["pod"]),
         "b": torch.full((3,), 2.0)}
    out["pod_sync"] = {k: v.numpy() for k, v in sync(p).items()}
    out["no_pod"] = make_pod_sync(Mesh((2, 2), ("data", "model"))) is None
    # batch rows follow the (pod, data) coordinate
    dm = Mesh((2, 2), ("data", "model"))
    data = SyntheticLMData(512, 16, 8, seed=3, mesh=dm)
    out["batch"] = data.host_batch(5)["tokens"]
    out["coords"] = dict(dm.coords)
    # elastic checkpoints: save on (4,), restore on (2, 2)
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.arange(8, dtype=torch.bfloat16)}
    s4 = {"w": ("data", None), "b": ("data",)}
    m4 = Mesh((4,), ("data",))
    shards = {k: sharding.local_shard(v, s4[k], m4).clone()
              for k, v in tree.items()}
    mgr = CheckpointManager(ckpt_dir, specs=s4, mesh=m4)
    mgr.save_async(5, shards)
    mgr.wait()
    import torch.distributed as dist
    dist.barrier()
    s22 = {"w": ("data", "model"), "b": ("data",)}
    tmpl = {"w": ((8, 8), torch.float32), "b": ((8,), torch.bfloat16)}
    got, man = restore_sharded(ckpt_dir, tmpl, s22, dm, "cpu")
    out["restored"] = {k: v.float().numpy() for k, v in got.items()}
    out["restored_step"] = man["step"]
    # DTensor placements over the DeviceMesh give the logical array back
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    spec = s22["w"]
    dmesh = init_device_mesh("cpu", dm.devices_shape,
                             mesh_dim_names=dm.axis_names)
    dt = DTensor.from_local(got["w"], dmesh, sharding.placements(spec, dm))
    out["dtensor_full"] = dt.full_tensor().numpy()
    # the sharded init equals the world of one's, shard for shard
    cfg = get_config("kimi_k2_1t").reduced()
    from repro_torch.models.params import (abstract_params, init_params,
                                           logical_axes)
    specs = sharding.tree_specs(logical_axes(cfg), abstract_params(cfg), dm)
    mine = init_params(cfg, torch.Generator().manual_seed(11), "cpu", dm,
                       specs)
    out["init"] = np_tree(mine)
    out["init_specs"] = specs
    return out


# ---------------------------------------------------------------------------
# MoE expert and tensor parallel (8 ranks, (data 4, model 2))
# ---------------------------------------------------------------------------

def moe_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("kimi_k2_1t").reduced(),
                               n_experts=8, top_k=2, capacity_factor=8.0)


def moe_specs(cfg, mesh) -> dict:
    from repro_torch.distributed import sharding
    from repro_torch.models.params import abstract_params, logical_axes
    ax = logical_axes(cfg)["layers"]["moe"]
    ab = abstract_params(cfg)["layers"]["moe"]
    return {k: sharding.logical_spec(ax[k][1:], ab[k][0][1:], mesh)
            for k in ax}


def moe_ranks(rank: int, p: dict, x: np.ndarray) -> dict:
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe
    from repro_torch.models.params import tensor_from_numpy
    cfg = moe_cfg()
    mesh = Mesh((4, 2), ("data", "model"))
    specs = moe_specs(cfg, mesh)
    shards = {k: sharding.local_shard(tensor_from_numpy(v), specs[k],
                                      mesh).contiguous()
              for k, v in p.items()}
    xl = sharding.local_shard(torch.from_numpy(x), ("data", None, None), mesh)
    out = {"coords": dict(mesh.coords)}
    for name, ep in (("ep", True), ("tp", False)):
        xg = xl.clone().requires_grad_()
        y, aux = moe._moe_sharded(cfg, shards, xg, mesh, ep, specs)
        (dx,) = torch.autograd.grad(y.square().sum(), xg)
        out[name] = y.detach().numpy()
        out[name + "_dx"] = dx.numpy()
    return out


# ---------------------------------------------------------------------------
# the sharded train step (4 ranks, (data 2, model 2))
# ---------------------------------------------------------------------------

def train_step_ranks(rank: int, cases: list) -> dict:
    from repro_torch.distributed import sharding
    from repro_torch.launch import api
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.params import shard_from_numpy
    mesh = Mesh((2, 2), ("data", "model"))
    out = {}
    for name, cfg, params, batch in cases:
        specs = api.state_specs(cfg, mesh)
        state = api.make_train_state(
            cfg, shard_from_numpy(params, specs["params"], mesh, "cpu"))
        rows = {k: sharding.local_shard(torch.from_numpy(v),
                                        ("data", None), mesh)
                for k, v in batch.items()}
        grads_of = api.make_grad_fn(cfg)
        with sharding.use(mesh, specs["params"]):
            grads, _ = grads_of(state["params"], rows)
        grads = api.reduce_grads(grads, specs["params"], mesh)
        with torch.no_grad():
            full = {}
            for (path, g), (_, sp) in zip(_items(grads),
                                          _items(specs["params"])):
                full[path] = sharding.gather(g, sp, mesh).numpy()
        step = api.make_train_step(cfg, mesh=mesh, specs=specs)
        new, metrics = step(state, rows)
        out[name] = {"grads": full, "loss": float(metrics["loss"]),
                     "gnorm": float(metrics["grad_norm"]),
                     "step": int(new["step"])}
    return out


def sharded_update_ranks(rank: int, cases: list) -> dict:
    """Each case's ``optimizer`` update on a (data 2, model 2) mesh, every
    rank on its shards of the same numpy params, gradients and optimizer
    state (``api._sharded_update``); the new params and state gathered
    to their logical arrays."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import api
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.params import shard_from_numpy, tree_map
    mesh = Mesh((2, 2), ("data", "model"))
    out = {}
    for name, cfg, optimizer, state, grads, step in cases:
        specs = api.state_specs(cfg, mesh)
        params = shard_from_numpy(state["params"], specs["params"], mesh,
                                  "cpu")
        opt = shard_from_numpy(state["opt"], specs["opt"], mesh, "cpu")
        g = shard_from_numpy(grads, specs["params"], mesh, "cpu")
        with torch.no_grad():
            new_p, new_o = api._sharded_update(
                optimizer, g, opt, params,
                torch.tensor(step, dtype=torch.int32), specs, mesh)
            full = {k: tree_map(lambda spec, x: sharding.gather(
                        x, spec, mesh), specs[k], t)
                    for k, t in (("params", new_p), ("opt", new_o))}
        out[name] = np_tree(full)
    return out


def _items(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _items(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def _main(fn, argv) -> str:
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def train_main_ranks(rank: int, runs: list) -> list:
    from repro_torch.launch import train
    return [_main(train.main, argv) for argv in runs]


def preempted_train_ranks(rank: int, runs: list, signal_rank: int,
                          signal_call: int) -> list:
    """``train.main``'s runs on this rank; in the last one, rank
    ``signal_rank`` sends itself SIGTERM in the middle of a step (its
    ``signal_call``-th gradient reduction, whose collectives the other
    ranks are entering)."""
    import signal
    from repro_torch.launch import api, train
    out = [_main(train.main, argv) for argv in runs[:-1]]
    reduce_grads, calls = api.reduce_grads, [0]

    def signalled(*args, **kw):
        calls[0] += 1
        if rank == signal_rank and calls[0] == signal_call:
            os.kill(os.getpid(), signal.SIGTERM)
        return reduce_grads(*args, **kw)
    api.reduce_grads = signalled
    try:
        out.append(_main(train.main, runs[-1]))
    finally:
        api.reduce_grads = reduce_grads
    return out


def serve_main_ranks(rank: int, runs: list) -> list:
    from repro_torch.launch import serve
    out = []
    for argv in runs:
        import contextlib
        import io
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            gen = serve.main(argv)
        out.append((buf.getvalue(), gen))
    return out


# ---------------------------------------------------------------------------
# sharded scheduler lanes (2 ranks, ("parts",))
# ---------------------------------------------------------------------------

def sched_requests(n: int = 5, size: int = 4096):
    rng = np.random.default_rng(4)
    return [(rng.standard_normal(size).astype(np.float32),
             rng.standard_normal(size).astype(np.float32)) for _ in range(n)]


def _fuse(budget, *names):
    """The chain fused with the JAX package's budget (as the scheduler's
    parity tests do), so both packages negotiate from one candidate set."""
    from repro_torch.core import isa
    instrs = tuple(isa.get(n) for n in names)
    prog, spec = isa.fuse_chain(instrs, smem_budget=budget)
    return isa.FusedProgram(name=prog.name, spec=spec, instrs=instrs,
                            program=prog, registry=isa.registry)


def sched_queue(mod, fuse, arr):
    """Two tenants: five coalescible adds, then two scale→adds (one
    package's queue; ``fuse(*names)`` and ``arr`` are that package's)."""
    q = mod.RequestQueue()
    add, sa = fuse("c0_add"), fuse("c0_scale", "c0_add")
    for i, (x, b) in enumerate(sched_requests()):
        q.submit(add, (arr(x), arr(b)), tenant="A", arrival=i * 1e-6)
    for i, (x, b) in enumerate(sched_requests(2, 8192)):
        q.submit(sa, (2.5, arr(x), arr(b)), tenant="B", arrival=2e-6)
    return q


def sched_ranks(rank: int, hier, budget: int) -> dict:
    import repro_torch.kernels  # noqa: F401 — registers the ISA
    from repro_torch import sched as ts
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((2,), ("parts",))
    fuse = lambda *names: _fuse(budget, *names)  # noqa: E731
    add, sa = fuse("c0_add"), fuse("c0_scale", "c0_add")
    reqs = [tuple(torch.from_numpy(a) for a in r) for r in sched_requests()]
    out = {"call": [o.numpy() for o in ts.sharded_program_call(
        add, reqs, mesh)]}
    out["call_sa"] = [o.numpy() for o in ts.sharded_program_call(
        sa, [(2.5,) + r for r in reqs], mesh)]
    # virtual clock: the recorded trace
    rec = ts.TraceRecorder()
    ts.Scheduler(sched_queue(ts, fuse, torch.from_numpy),
                 cost=ts.CostModel(hierarchy=hier), clock="virtual",
                 mesh=mesh, mesh_axis="parts", recorder=rec).drain()
    out["trace"] = rec.dumps()
    # wall clock, interpret mode: one call_batch chunk a rank
    q = ts.RequestQueue()
    items = [q.submit(sa, (2.5,) + r) for r in reqs]
    sched = ts.Scheduler(q, clock="wall", mode="interpret", mesh=mesh,
                         mesh_axis="parts")
    rep = sched.drain()
    out["wall"] = [rep.results[it.seq].numpy() for it in items]
    out["solo"] = [sa(2.5, *r, mode="interpret").numpy() for r in reqs]
    out["placements"] = [(p.seq, p.lane, p.round, p.batch_seq, p.coalesced,
                          p.channel) for p in rep.placements]
    out["n_lanes"] = sched.n_lanes
    return out


def mesh_of_three(rank: int) -> None:
    from repro_torch.launch.mesh import Mesh
    Mesh((3,), ("data",))


def failing_rank(rank: int) -> None:
    """Rank 1 raises before the collective the others wait in."""
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((2,), ("d",))
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    C.all_reduce_(torch.ones(3), mesh.group("d"))


# ---------------------------------------------------------------------------
# the dry run against a real run (2 ranks, (data 2, model 1) or (1, 2))
# ---------------------------------------------------------------------------

def real_cell_ranks(rank: int, cases: list, mesh_shape=(2, 1)) -> dict:
    """Each (name, cfg, shape) train cell run for real as this rank of a
    ``mesh_shape`` (data, model) mesh, on its shards from
    ``init_params(mesh=)`` and its rows,
    under ``roofline.analysis.count_step``: its FLOPs and its transport's
    collective traffic by kind, and whether every argument has the shape
    of ``api.lower_cell``'s meta argument."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import api
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.params import init_params, tree_items
    from repro_torch.roofline.analysis import collective_bytes_of, count_step
    mesh = Mesh(mesh_shape, ("data", "model"))
    out = {}
    for name, cfg, shape in cases:
        fn, meta, in_sp, _, _ = api.lower_cell(cfg, shape, mesh)
        g = torch.Generator().manual_seed(0)
        state = api.make_train_state(cfg, init_params(
            cfg, g, "cpu", mesh, in_sp[0]["params"]))
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (shape.global_batch, shape.seq_len + 1),
            dtype=np.int32))
        batch = {k: sharding.local_shard(v, in_sp[1][k], mesh).contiguous()
                 for k, v in (("tokens", tokens[:, :-1]),
                              ("targets", tokens[:, 1:]))}
        def layout(*trees):
            return {(i, path): (tuple(t.shape), t.dtype)
                    for i, tree in enumerate(trees)
                    for path, t in tree_items(tree)}
        shapes_ok = layout(state, batch) == layout(*meta)
        c = count_step(fn, (state, batch))
        out[name] = {"flops": c["flops"], "shapes_ok": shapes_ok,
                     "coll": collective_bytes_of(c["collectives"])}
    return out


# ---------------------------------------------------------------------------
# the dense layers split over ``model`` (tensor and sequence parallelism)
# ---------------------------------------------------------------------------

#: the functions whose params a rank's layer walk hands over: the
#: model's module attribute, the function, the argument holding the
#: params, and the param whose shape says which block it is (None: the
#: argument is the param)
TP_SEEN = (("attn", "attention", 1, "wq"),
           ("ssm_mod", "ssd_forward", 1, "A_log"),
           ("", "mlp", 0, "w_in"), ("", "vocab_logits", 0, None))


def _seen_shapes(log: dict):
    """Patches the model's calls of TP_SEEN to log the shape of the param
    they see (the unembedding's for ``vocab_logits``); returns the undo."""
    from repro_torch.models import model as M
    undo = []
    for mod, name, arg, leaf in TP_SEEN:
        owner = getattr(M, mod) if mod else M
        orig = getattr(owner, name)

        def seen(*a, _orig=orig, _name=name, _arg=arg, _leaf=leaf, **kw):
            shape = (tuple(a[_arg].shape) if _leaf is None
                     else tuple(a[_arg][_leaf].shape))
            log.setdefault(_name, set()).add(shape)
            return _orig(*a, **kw)
        setattr(owner, name, seen)
        undo.append((owner, name, orig))

    def restore():
        for owner, name, orig in undo:
            setattr(owner, name, orig)
    return restore


def tp_ranks(rank: int, shape, cases: list, extras: bool) -> dict:
    """Each (name, cfg, numpy params, numpy batch) case on this rank of a
    (data, model) mesh of ``shape``: its shards from the numpy params and
    its rows of the batch. Returns per case the loss, every gradient leaf
    (reduced, then gathered to the logical array), prefill's logits and
    two decode steps' (after ``grow_cache``, fed the targets' first two
    tokens) of the rank's rows, the
    param shapes the attention, SSM, MLP and unembedding saw, the
    collectives of the train step by kind, and the K4 calls' head
    counts. With ``extras``, the unit cases of the split's pieces."""
    from repro_torch.core import isa
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import api
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as M
    from repro_torch.models.params import shard_from_numpy
    mesh = Mesh(shape, ("data", "model"))
    out = {"coords": dict(mesh.coords)}
    for name, cfg, params, batch in cases:
        specs = api.state_specs(cfg, mesh)["params"]
        p = shard_from_numpy(params, specs, mesh, "cpu")
        rows = {k: sharding.local_shard(torch.from_numpy(v), ("data", None),
                                        mesh).contiguous()
                for k, v in batch.items()}
        seen: dict = {}
        restore = _seen_shapes(seen)
        k4_heads = []
        scan = ops.chunk_scan_state

        def counted(a, states, axis, _scan=scan):
            k4_heads.append(states.shape[2])
            return _scan(a, states, axis)
        ops.chunk_scan_state = counted
        try:
            with C.recording() as log:
                with sharding.use(mesh, specs):
                    grads, metrics = api.make_grad_fn(cfg)(p, rows)
            grads = api.reduce_grads(grads, specs, mesh)
            res = {"loss": float(metrics["loss"]),
                   "coll": sorted({k for k, _, _ in log})}
            with torch.no_grad():
                res["grads"] = {path: sharding.gather(g, sp, mesh).numpy()
                                for (path, g), (_, sp) in zip(
                                    _items(grads), _items(specs))}
                with sharding.use(mesh, specs):
                    prompt = rows["tokens"]
                    logits, cache = M.prefill(cfg, p, {"tokens": prompt})
                    res["prefill"] = logits.numpy()
                    res["cache_shapes"] = {k: tuple(v.shape) for k, v in
                                           _items(cache)}
                    cache = M.grow_cache(cfg, cache, prompt.shape[1],
                                         prompt.shape[1] + 2)
                    dec = []
                    for i in range(2):      # the targets' tokens, forced
                        logits, cache = M.decode_step(
                            cfg, p, cache, rows["targets"][:, i:i + 1],
                            prompt.shape[1] + i)
                        dec.append(logits.numpy())
                    res["decode"] = dec
                    if cfg.has_ssm and extras:
                        with isa.use("interpret"):
                            res["prefill_interpret"] = M.prefill(
                                cfg, p, {"tokens": prompt})[0].numpy()
        finally:
            restore()
            ops.chunk_scan_state = scan
        res["seen"] = seen
        res["k4_heads"] = sorted(set(k4_heads))
        out[name] = res
    if extras:
        out["units"] = tp_units(mesh)
    return out


def tp_units(mesh) -> dict:
    """The split's pieces on this rank against their whole versions (the
    rank holds the whole inputs, made from one seed): the SSM's gated
    norm over a ``d_inner`` split and the vocabulary-split cross-entropy
    (padded vocabulary, values and gradients)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding
    from repro_torch.models import layers, ssm
    cfg = get_config("mamba2_1p3b").reduced()
    g = torch.Generator().manual_seed(7)
    m, i = mesh.axis_size("model"), mesh.axis_index("model")
    tp = sharding.ModelSplit(mesh, 8, True)
    out = {}
    y = torch.randn(2, 8, cfg.d_inner, generator=g)
    z = torch.randn(2, 8, cfg.d_inner, generator=g)
    w = torch.randn(cfg.d_inner, generator=g)
    n = cfg.d_inner // m
    blk = slice(i * n, (i + 1) * n)
    whole = ssm._gated_norm(cfg, {"norm": w}, y, z, None)
    yl = y[..., blk].clone().requires_grad_()
    got = ssm._gated_norm(cfg, {"norm": w[blk]}, yl, z[..., blk], tp)
    # each rank's loss is its block's: the world's sum is the whole loss
    (dy,) = torch.autograd.grad(got.square().sum(), yl)
    yw = y.clone().requires_grad_()
    (dyw,) = torch.autograd.grad(ssm._gated_norm(
        cfg, {"norm": w}, yw, z, None).square().sum(), yw)
    out["gated_norm"] = (float((got - whole[..., blk]).abs().max()),
                         float((dy - dyw[..., blk]).abs().max()),
                         float(whole.abs().max()), float(dyw.abs().max()))
    vocab, padded = 500, 512
    x = torch.randn(2, 6, 16, generator=g)
    wu = torch.randn(16, padded, generator=g)
    t = torch.randint(0, vocab, (2, 6), generator=g)
    nv = padded // m
    xw = x.clone().requires_grad_()
    lw, _ = layers.cross_entropy(layers.unembed(wu, xw, vocab), t)
    (dxw,) = torch.autograd.grad(lw, xw)
    xl = x.clone().requires_grad_()
    ll, _ = layers.cross_entropy_split(
        layers.vocab_logits(wu[:, i * nv:(i + 1) * nv], xl, vocab, i * nv),
        t, i * nv, mesh.group("model"))
    (dxl,) = torch.autograd.grad(ll, xl)
    # every model peer's loss is the whole one: the world's sum counts it
    # m times, and a rank's gradient of its copy of x is its block's part
    dx = C.all_reduce_(dxl.clone(), mesh.group("model")) / m
    out["ce"] = (float(ll), float(lw), float((dx - dxw).abs().max()),
                 float(dxw.abs().max()))
    return out
