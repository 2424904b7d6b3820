"""Checkpointing in the reference's format (``src/repro/checkpoint/ckpt.py``).

A checkpoint stores logical (unsharded) arrays — one ``.npy`` per leaf
plus ``manifest.json`` — under ``step_XXXXXXXX``. Leaves are named by
their key paths joined by '/' and numbered in the reference's
``tree_flatten_with_path`` order (dict keys sorted at every level), and
bfloat16 leaves are saved as their uint16 bits with ``"dtype":
"bfloat16"`` in the manifest, so a checkpoint written by either package
restores in the other. Writes are atomic (a temporary directory, then a
rename), happen on rank 0 only (``torch.distributed``'s rank when it is
initialised), and can run in a background thread; a preemption signal
handler forces a synchronous save.

Loaded leaves are CPU tensors (numpy has no bfloat16);
:func:`restore` places them on a device, and :func:`restore_sharded`
keeps each rank's shard of them on a mesh (any mesh whose axes divide
the dims: the elastic restart). A sharded tree is saved whole: the
``CheckpointManager`` of a mesh gathers each leaf to its logical array
before rank 0 writes, so the format does not change and a checkpoint of
a sharded run restores in the reference, and the other way round.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import tempfile
import threading
from typing import Optional

import numpy as np
import torch

_NUMPY = {torch.bfloat16: np.uint16}       # saved as their bits


def _rank() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _flatten_with_names(tree, prefix=()):
    """[(name, leaf)] in the reference's order: dict keys sorted at every
    level, names the key paths joined by '/'."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten_with_names(tree[k], prefix + (str(k),))]
    return [("/".join(prefix), tree)]


def _unflatten(template, leaves):
    """``leaves`` (in :func:`_flatten_with_names` order) in the
    template's structure."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(template)


def _host(leaf) -> tuple[np.ndarray, str]:
    """(a numpy array to save, the leaf's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype in _NUMPY:
            return t.view(torch.int16).numpy().view(_NUMPY[t.dtype]), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[dict] = None, keep: int = 3) -> str:
    """Write step checkpoint; returns final path. Call on every process —
    only rank 0 writes."""
    final = os.path.join(directory, f"step_{step:08d}")
    if _rank() != 0:
        return final
    items = [(name, *_host(leaf)) for name, leaf in _flatten_with_names(tree)]
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_")
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (name, arr, dtype) in enumerate(items):
        fn = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append(
            {"name": name, "file": fn, "shape": list(arr.shape),
             "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def _load_leaf(path: str, entry: dict) -> torch.Tensor:
    a = np.load(os.path.join(path, entry["file"]))
    want = entry["dtype"]
    if want == "bfloat16":                 # bit-preserved leaf
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if str(a.dtype) != want:
        raise ValueError(f"leaf {entry['name']}: saved {a.dtype}, "
                         f"manifest {want}")
    return torch.from_numpy(a)


def load_checkpoint(directory: str, step: Optional[int] = None,
                    template=None):
    """Load the leaves as CPU tensors; if `template` (nested dicts) is
    given, in its structure (leaves in the sorted-key order). Returns
    (leaves or tree, manifest)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = [_load_leaf(path, e) for e in manifest["leaves"]]
    if template is not None:
        names = [name for name, _ in _flatten_with_names(template)]
        got = [e["name"] for e in manifest["leaves"]]
        if got != names:
            raise ValueError(f"checkpoint leaves {got} != template {names}")
        leaves = _unflatten(template, leaves)
    return leaves, manifest


def _check_place(x: torch.Tensor, t, device) -> torch.Tensor:
    if (tuple(x.shape), x.dtype) != (tuple(t[0]), t[1]):
        raise ValueError(f"leaf {tuple(x.shape)} {x.dtype} != template "
                         f"{tuple(t[0])} {t[1]}")
    return x.to(device)


def restore_sharded(directory: str, template, specs, mesh, device="cuda",
                    step=None):
    """Elastic restore: load into ``template``'s structure (nested dicts
    of (shape, dtype)) and keep this rank's shard of each logical leaf
    (``specs`` on ``mesh``) on ``device``. Returns (tree, manifest)."""
    from repro_torch.distributed.sharding import local_shard
    tree, manifest = load_checkpoint(directory, step, template)

    def place(x, t, spec):
        if isinstance(x, dict):
            return {k: place(x[k], t[k], spec[k]) for k in x}
        _check_place(x, t, "cpu")
        return local_shard(x, spec, mesh).contiguous().to(device)
    return place(tree, template, specs), manifest


def restore(directory: str, template, device, step=None):
    """Load into the structure of ``template`` (nested dicts of (shape,
    dtype) pairs, as ``launch.api.make_train_state_abstract`` gives) and
    place every leaf on ``device``; raises if a leaf's shape or dtype
    differs. Returns (tree, manifest)."""
    tree, manifest = load_checkpoint(directory, step, template)

    def place(x, t):
        if isinstance(x, dict):
            return {k: place(x[k], t[k]) for k in x}
        return _check_place(x, t, device)
    return place(tree, template), manifest


class CheckpointManager:
    """Async writer + preemption hook.

    save_async() snapshots to host then writes in a background thread;
    install_preemption_handler() registers SIGTERM → synchronous save of
    the most recent state handed to observe();
    remove_preemption_handler() puts the replaced handlers back and lets
    go of that state.

    With ``specs`` and a ``mesh`` of more than one rank the trees handed
    to it are shards, and a save is a collective: it walks the leaves in
    order, gathers each to its logical array, and only rank 0 copies it
    to the host and writes. Every rank must save at the same steps, so
    the preemption handler only notes the signal; :meth:`save_if_preempted`,
    which the training loop calls on every rank after each step, agrees
    on it over the mesh (an all-reduce of the flag) and then every rank
    saves together at that step boundary.
    """

    def __init__(self, directory: str, keep: int = 3, specs=None, mesh=None):
        self.directory = directory
        self.keep = keep
        self.specs, self.mesh = specs, mesh
        self._sharded = mesh is not None and mesh.size > 1
        self._thread: Optional[threading.Thread] = None
        self._last: Optional[tuple] = None
        self._lock = threading.Lock()
        self._replaced: dict = {}
        self._preempted = False

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree, extra: Optional[dict] = None):
        # snapshot synchronously (a copy to the host), write in background
        host_tree = self._host_tree(tree)
        self.wait()

        def _write():
            save_checkpoint(self.directory, step, host_tree, extra,
                            self.keep)

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def _host_tree(self, tree):
        """The logical tree on the host: on a mesh, each leaf gathered in
        turn (one logical leaf on the device at a time) and kept only on
        rank 0, the others keeping None (they write nothing)."""
        if not self._sharded:
            return _host_copy(tree)
        from repro_torch.distributed.sharding import gather
        keep = _rank() == 0

        def full(x, spec):
            if isinstance(x, dict):
                return {k: full(x[k], spec[k]) for k in sorted(x)}
            with torch.no_grad():
                g = gather(x, spec, self.mesh)
            return g.detach().to("cpu", copy=True) if keep else None
        return full(tree, self.specs)

    def observe(self, step: int, tree, extra: Optional[dict] = None):
        with self._lock:
            self._last = (step, tree, extra)

    def _save_last(self):
        with self._lock:
            last = self._last
        if last is not None:
            step, tree, extra = last
            self.wait()
            save_checkpoint(self.directory, step, self._host_tree(tree),
                            extra, self.keep)

    def install_preemption_handler(self, signals=(signal.SIGTERM,)):
        def handler(signum, frame):
            if self._sharded:    # the save is a collective: at the step's end
                self._preempted = True
            else:
                self._save_last()
        for s in signals:
            self._replaced.setdefault(s, signal.signal(s, handler))

    def save_if_preempted(self) -> bool:
        """On a mesh, whether any rank was signalled since the last call
        (every rank calls it at the same step boundary; the flag's
        all-reduce is a collective); if one was, every rank saves the
        state handed to :meth:`observe`, synchronously. False, with no
        collective, off a mesh, where the handler saves at once."""
        if not self._sharded:
            return False
        from repro_torch.distributed import collectives as C
        with self._lock:
            last = self._last
        dev = (_flatten_with_names(last[1])[0][1].device if last is not None
               else "cpu")
        flag = torch.tensor([float(self._preempted)], device=dev)
        C.all_reduce_max_(flag, self.mesh.group(self.mesh.axis_names))
        self._preempted = False
        if not float(flag[0]):
            return False
        self._save_last()
        return True

    def remove_preemption_handler(self):
        for s, previous in self._replaced.items():
            signal.signal(s, previous)
        self._replaced = {}
        with self._lock:
            self._last = None


def _host_copy(tree):
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree)
