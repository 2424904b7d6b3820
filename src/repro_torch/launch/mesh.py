"""Device meshes over the ranks of ``torch.distributed``
(``src/repro/launch/mesh.py``).

A :class:`Mesh` names the dims of the world's ranks, as a JAX mesh names
its devices' axes: ``("data", "model")``, or ``("pod", "data", "model")``
for the two-pod production shape. There is one rank per process, as
``torchrun`` gives, and rank r sits at the row-major coordinate of r in
the mesh's shape. The mesh holds one process group for every non-empty
set of its axes (the ranks that differ only along those axes), so a
collective over ``("pod", "data")`` or over one axis has its group at
hand; ranks along a set of axes are numbered row-major, as a
``PartitionSpec`` entry of several axes shards a dim.

A world of one process, with no process group, is the trivial mesh:
every size 1, no group, and every collective an identity. A mesh whose
size is not the world's raises: nothing runs silently on fewer ranks.

:class:`AbstractMesh` is a mesh's shape and names alone, for sharding
specs of meshes larger than the world (the production (16, 16) and
(2, 16, 16)). :class:`DryMesh` is a mesh of any shape in one process, as
one of its ranks sees it, whose groups move nothing (``DryGroup``): the
dry run (``launch/dryrun.py``) walks one rank's step on it.
"""
from __future__ import annotations

import itertools
import math

import numpy as np


def world() -> tuple[int, int]:
    """(world size, rank) of ``torch.distributed``, or (1, 0) when no
    process group is initialised."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class AbstractMesh:
    """A mesh's shape and axis names (what the sharding rules read)."""

    def __init__(self, shape, axis_names):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} names {axis_names}")
        self.devices_shape = shape
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = math.prod(shape)

    def axis_size(self, axes) -> int:
        """Ranks along ``axes`` (one name or a tuple of names)."""
        return math.prod(self.shape[a] for a in _axes(axes))

    def __repr__(self):
        return f"{type(self).__name__}({self.shape})"


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh(AbstractMesh):
    """A mesh over the world's ranks, with a process group per set of
    axes. Built collectively: every rank constructs the same mesh."""

    def __init__(self, shape, axis_names):
        super().__init__(shape, axis_names)
        n, rank = world()
        if self.size != n:
            raise ValueError(f"mesh {mesh_name(self)} {self.axis_names} has "
                             f"{self.size} ranks, the world {n}")
        self._place(rank)
        self._groups: dict[tuple, object] = {}
        if self.size > 1:
            import torch.distributed as dist
            ranks = np.arange(self.size).reshape(self.devices_shape)
            # every rank creates every group, in one order
            for k in range(1, len(self.axis_names) + 1):
                for sub in itertools.combinations(range(len(self.axis_names)),
                                                  k):
                    rest = [i for i in range(len(self.axis_names))
                            if i not in sub]
                    moved = np.transpose(ranks, rest + list(sub)).reshape(
                        -1, math.prod(self.devices_shape[i] for i in sub))
                    names = tuple(self.axis_names[i] for i in sub)
                    for members in moved:
                        g = dist.new_group([int(r) for r in members])
                        if rank in members:
                            self._groups[names] = g

    def _place(self, rank: int) -> None:
        self.rank = rank
        self.coords = dict(zip(self.axis_names, (int(c) for c in
                               np.unravel_index(rank, self.devices_shape))))

    def _key(self, axes) -> tuple[str, ...]:
        axes = _axes(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        """The process group of the ranks that differ from this one only
        along ``axes``, or None when there is one such rank."""
        key = self._key(axes)
        if not key or self.axis_size(key) == 1:
            return None
        return self._groups[key]

    def axis_index(self, axes) -> int:
        """This rank's row-major index along ``axes``."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx


class DryMesh(Mesh):
    """A mesh of ``shape`` as its rank ``rank`` sees it, in one process
    and with no world: each group is a ``DryGroup`` of the ranks along
    its axes, on which collectives are logged and move nothing."""

    def __init__(self, shape, axis_names, rank: int = 0):
        AbstractMesh.__init__(self, shape, axis_names)
        self._place(rank)

    def group(self, axes):
        from repro_torch.distributed.collectives import DryGroup
        key = self._key(axes)
        if not key or self.axis_size(key) == 1:
            return None
        return DryGroup(self.axis_size(key), self.axis_index(key))


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the production mesh: (16, 16) ``("data",
    "model")`` for one 256-device pod, (2, 16, 16) ``("pod", "data",
    "model")`` for two."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh (:func:`production_shape`); raises unless the
    world is 256 or 512 ranks."""
    return Mesh(*production_shape(multi_pod))


def make_elastic_mesh(n_devices: int | None = None,
                      model_parallel: int = 16) -> Mesh:
    """A (data, model) mesh over the world's ``n_devices`` ranks (all of
    them by default): ``model`` = gcd(n, model_parallel) — the
    elastic-restart path (checkpoints are mesh-agnostic). ``n_devices``
    other than the world's size raises."""
    n = n_devices or world()[0]
    model = math.gcd(n, model_parallel)
    return Mesh((n // model, model), ("data", "model"))


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.devices_shape)

