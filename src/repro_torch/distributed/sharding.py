"""Logical-axis sharding rules with divisibility-aware fallback
(``src/repro/distributed/sharding.py``), the per-rank shards they give,
and the ``model`` axis's split of the dense layers' compute.

Every tensor dimension is named by a *logical axis* ("batch", "ffn",
"q_heads", ...). A rules table maps each logical axis to a priority list
of mesh-axis tuples; :func:`shard_fit` picks the first candidate whose
mesh axes (a) exist in the mesh, (b) are not already used by another
dimension of the same tensor, and (c) divide the dimension evenly. The
table and the fit are the reference's, verbatim: :func:`logical_spec`
returns, per dim, the entries of the reference's ``PartitionSpec`` (None,
an axis name, or a tuple of names) as a tuple, and :func:`placements`
turns a spec into DTensor ``Shard``/``Replicate`` placements over a
``DeviceMesh`` with the mesh's dims.

Parameters at rest are each rank's shard of the logical array
(:func:`local_shard`): a dim whose entry names axes is split in equal
blocks over those ranks, row-major. :func:`gather` all-gathers a shard
to the logical array in forward and reduce-scatters in backward
(``collectives.all_gather``); :func:`reshard` gathers some axes and
slices others.

While :func:`use` holds a mesh of more than one rank, the model's layer
walk gathers each layer's leaves over their FSDP axes only (``data``,
``pod``: the reference's "embed: FSDP dim (gathered per layer)") and
keeps each dim that the rules put on ``model`` as the rank's block
(:func:`model_part`). The reference lets XLA's partitioner split the
dense layers' compute over ``model`` from those layouts and its
``with_sharding_constraint`` hints; here :class:`ModelSplit` does it
with explicit collectives at the same places: each block's mixer and
MLP run on the rank's heads, FFN columns and SSM heads, entered and
left through :meth:`ModelSplit.enter` and :meth:`ModelSplit.exit`
(with ``cfg.sp`` and a sequence that divides ``model``, the residual
between blocks is the rank's block of the sequence, Megatron-SP: an
all-gather at entry and a reduce-scatter at exit; otherwise the
residual is whole on every model peer and the exit all-reduces). A dim
the rules leave whole (heads that do not divide ``model``) is computed
whole on every model peer.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch

from . import collectives as C

Candidate = Optional[tuple]
Rules = dict[str, Sequence[Candidate]]

DEFAULT_RULES: Rules = {
    # -- activations ---------------------------------------------------------
    "batch":      [("pod", "data"), ("data",), None],
    "seq":        [None],                       # replicated by default
    "seq_sp":     [("model",), None],           # SP: residual seq over model
    "seq_shard":  [("model",), None],           # CP: sequence over model
    "act_embed":  [None],                       # residual stays replicated
    # -- attention -----------------------------------------------------------
    "q_heads":    [("model",), None],
    "kv_heads":   [("model",), None],
    "head_dim":   [None],
    "cache_seq":  [("model",), None],           # decode KV cache: seq over TP
    # -- params --------------------------------------------------------------
    "embed":      [("data",), None],            # FSDP dim (gathered per layer)
    "embed_nofsdp": [None],
    "ffn":        [("model",), None],
    "vocab":      [("model",), None],
    "vocab_tbl":  [None],                       # embed-gather-local table
    "embed_tbl":  [("model",), None],
    "experts":    [("data",), None],            # EP
    "expert_ffn": [("model",), None],
    "layers":     [None],                       # stacked layer axis
    # -- ssm ------------------------------------------------------------------
    "ssm_heads":  [("model",), None],
    "ssm_inner":  [("model",), None],
    "ssm_state":  [None],
    "conv_dim":   [("model",), None],
}


def _mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices_shape))


def shard_fit(dim_size: int, candidates: Sequence[Candidate], mesh,
              used: set[str]) -> Optional[tuple]:
    """First candidate that exists in the mesh, is unused, and divides."""
    sizes = _mesh_axis_sizes(mesh)
    for cand in candidates:
        if cand is None:
            return None
        if not all(a in sizes for a in cand):
            continue
        if any(a in used for a in cand):
            continue
        prod = math.prod(sizes[a] for a in cand)
        if dim_size % prod == 0:
            return tuple(cand)
    return None


def logical_spec(logical_dims: Sequence[Optional[str]], shape: Sequence[int],
                 mesh, rules: Optional[Rules] = None) -> tuple:
    """The spec of a tensor whose dims carry logical names: per dim None,
    one mesh-axis name, or a tuple of names."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    if len(logical_dims) != len(shape):
        raise ValueError(f"logical dims {logical_dims} rank != shape {shape}")
    used: set[str] = set()
    out = []
    for name, size in zip(logical_dims, shape):
        if name is None:
            out.append(None)
            continue
        if name not in rules:
            raise KeyError(f"no sharding rule for logical axis {name!r}")
        axes = shard_fit(size, rules[name], mesh, used)
        if axes is None:
            out.append(None)
        else:
            used.update(axes)
            out.append(axes if len(axes) > 1 else axes[0])
    return tuple(out)


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _shape_of(leaf) -> tuple:
    """A leaf's shape: a tensor's, or the first item of a (shape, dtype)
    pair."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return tuple(leaf[0])


def tree_specs(tree_logical, tree_shapes, mesh, rules: Optional[Rules] = None):
    """Matching trees of logical-dim tuples and shapes (tensors, meta
    tensors or (shape, dtype) pairs) → a tree of specs."""
    if _is_logical(tree_logical):
        return logical_spec(tree_logical, _shape_of(tree_shapes), mesh, rules)
    return {k: tree_specs(v, tree_shapes[k], mesh, rules)
            for k, v in tree_logical.items()}


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sharded_axes(spec) -> tuple[str, ...]:
    return tuple(a for e in spec for a in spec_axes(e))


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` over a ``DeviceMesh`` of ``mesh``'s
    shape and dim names: ``Shard(d)`` on each mesh dim that shards tensor
    dim d, else ``Replicate()``. A tensor dim over several mesh dims gets one
    ``Shard(d)`` on each, in the entry's order."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.axis_names)
    for d, entry in enumerate(spec):
        for a in spec_axes(entry):
            out[mesh.axis_names.index(a)] = Shard(d)
    return out


def local_shape(shape, spec, mesh) -> tuple:
    return tuple(s // mesh.axis_size(spec_axes(e)) for s, e in
                 zip(shape, spec))


def local_shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the logical ``x`` (a view)."""
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            n = x.shape[d] // mesh.axis_size(axes)
            x = x.narrow(d, mesh.axis_index(axes) * n, n)
    return x


def shard_rows(n_rows: int, entry, mesh) -> tuple[int, int]:
    """(start, count) of this rank's rows of a dim of ``n_rows`` whose
    spec entry is ``entry``."""
    axes = spec_axes(entry)
    if not axes:
        return 0, n_rows
    n = n_rows // mesh.axis_size(axes)
    return mesh.axis_index(axes) * n, n


def gather(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The logical array of the shards ``x`` (autograd: the backward
    reduce-scatters the cotangent back to the shards)."""
    for d, entry in enumerate(spec):
        if spec_axes(entry):
            x = C.all_gather(x, mesh.group(spec_axes(entry)), d)
    return x


def reshard(x: torch.Tensor, spec_from, spec_to, mesh) -> torch.Tensor:
    """From the shard of ``spec_from`` to the shard of ``spec_to``: each
    dim gathers the axes it loses and slices the axes it gains (both
    differentiable). A dim may only lose axes or gain them."""
    for d, (a, b) in enumerate(zip(spec_from, spec_to)):
        a, b = spec_axes(a), spec_axes(b)
        if a == b:
            continue
        if a and b:
            raise ValueError(f"dim {d}: {a} → {b} is neither a gather nor "
                             f"a slice")
        if a:
            x = C.all_gather(x, mesh.group(a), d)
        else:
            n, rem = divmod(x.shape[d], mesh.axis_size(b))
            if rem:
                raise ValueError(f"dim {d} of {x.shape[d]} does not split "
                                 f"over {b}")
            x = x.narrow(d, mesh.axis_index(b) * n, n)
    return x


def replica_axes(spec, mesh) -> tuple[str, ...]:
    """The mesh axes along which ranks hold the same shard."""
    used = set(sharded_axes(spec))
    return tuple(a for a in mesh.axis_names if a not in used)


def model_part(spec) -> tuple:
    """``spec`` with only its ``model`` axes: the shard a layer's leaf
    keeps once its FSDP axes are gathered."""
    out = []
    for entry in spec:
        axes = spec_axes(entry)
        if "model" in axes and len(axes) > 1:
            raise ValueError(f"entry {entry} splits a dim over model and "
                             f"other axes")
        out.append("model" if "model" in axes else None)
    return tuple(out)


class ModelSplit:
    """The ``model`` axis of the active mesh for one pass of the model
    over a sequence of ``seq`` positions: its group, size and this
    rank's index along it, and whether the residual stream between
    blocks is this rank's block of the sequence (``sp``: Megatron-SP,
    when asked for and ``seq`` divides the axis).

    Between :meth:`enter` and :meth:`exit` a region (attention, SSM,
    MLP, MoE, the embedding's lookup) runs on the rank's share of its
    heads or columns, so its output is either a *partial* sum over the
    model peers (its last product contracted a split dim) or *whole*
    (nothing of it was split). Every collective's backward is its
    adjoint (``collectives``), so remat's recompute and the backward
    issue the same collectives on every rank."""

    def __init__(self, mesh, seq: int, sp: bool):
        self.group = mesh.group("model")
        self.size = mesh.axis_size("model")
        self.index = mesh.axis_index("model")
        self.sp = bool(sp) and seq % self.size == 0

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        """The region's input: under SP the sequence (dim 1) gathered
        from the model peers' blocks, else ``h`` as it is."""
        return C.all_gather(h, self.group, 1) if self.sp else h

    def rows(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's block of the sequence (dim 1) under SP."""
        if not self.sp:
            return y
        n = y.shape[1] // self.size
        return y.narrow(1, self.index * n, n)

    def exit(self, y: torch.Tensor, partial: bool) -> torch.Tensor:
        """The region's output into the residual stream: a partial sum
        reduce-scattered over the sequence under SP, all-reduced
        otherwise; a whole output sliced to the rank's rows."""
        if not partial:
            return self.rows(y)
        if self.sp:
            return C.reduce_scatter(y, self.group, 1)
        return C.all_reduce(y, self.group)


# ---------------------------------------------------------------------------
# the active mesh of the model's layer walk
# ---------------------------------------------------------------------------

_ACTIVE: Optional[tuple] = None


@contextlib.contextmanager
def use(mesh, specs):
    """Run the model on ``mesh`` with its params at rest as the shards of
    ``specs`` (the param tree's specs). A mesh of one rank is no mesh.
    Process-wide (autograd's device thread runs remat's recompute under
    it too); nested uses restore the outer one."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = (mesh, specs) if mesh is not None and mesh.size > 1 else None
    try:
        yield
    finally:
        _ACTIVE = prev


def active() -> Optional[tuple]:
    """(mesh, param specs) while :func:`use` holds a mesh of more than
    one rank, else None."""
    return _ACTIVE


def model_split(seq: int, sp: bool) -> Optional[ModelSplit]:
    """The active mesh's :class:`ModelSplit` for a pass over ``seq``
    positions, or None when no mesh is active or its ``model`` axis is
    one rank."""
    if _ACTIVE is None:
        return None
    mesh = _ACTIVE[0]
    if "model" not in mesh.axis_names or mesh.shape["model"] == 1:
        return None
    return ModelSplit(mesh, seq, sp)


def gather_tree(tree: dict, specs: dict, mesh) -> dict:
    """Every leaf of ``tree`` gathered by its spec."""
    return {k: (gather_tree(v, specs[k], mesh) if isinstance(v, dict)
                else gather(v, specs[k], mesh))
            for k, v in tree.items()}


def reshard_tree(tree: dict, specs: dict, targets: dict, mesh,
                 skip=()) -> dict:
    """Every leaf of ``tree`` resharded from its spec in ``specs`` to its
    target in ``targets`` (:func:`reshard`), except the subtrees named
    in ``skip`` (kept as they are)."""
    return {k: (v if k in skip else
                reshard_tree(v, specs[k], targets[k], mesh)
                if isinstance(v, dict)
                else reshard(v, specs[k], targets[k], mesh))
            for k, v in tree.items()}
