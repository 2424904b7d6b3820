"""The weights of a cell, made on the device from the run's seed.

The tree has the layout the port's functions read: nested dicts whose
leaves are tensors. A family's plain reference
(``perfbench/reference/<family>.py``) gives the whole tree by a
``layout(m)`` of its own; without one the tree is :func:`uniform`: the
embedding, one stack of the family's ``layer_layout`` over ``n_layers``
under ``layers``, the final norm and, unless tied, the unembedding. A
family's tree may hold several stacks (a leading dense stack before the
MoE stack, a stack for each kind of layer; :func:`stacked` puts the
count in front of every leaf of one layer), leaves outside any stack,
and top-level names of its own: the port's tree decides them, and
set-up refuses a tree that differs from the port's (:func:`check`).

A leaf of a layout is ``(shape, law)`` or ``(shape, law, dtype)``, the
dtype a name in :data:`DTYPES`, the configuration's ``param_dtype``
where none is given. Each leaf is drawn in one call from one
``torch.Generator`` on the device, walked in sorted-key order, in the
dtype it is served in, so set-up holds no float32 copy and draws a few
GB in well under a second.

Laws: N(0, 0.02) for the embedding; N(0, fan_in^-1/2) for a product's
weight, fan_in being the size of the dims it contracts; ones for the
norms; any other law is the family's own, named in its reference's
``LAWS``. A new family is a new reference file, with no file here
edited.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PAD_VOCAB = 256          # embedding rows are padded to a multiple of this


def vocab_padded(vocab: int) -> int:
    return -(-vocab // PAD_VOCAB) * PAD_VOCAB


def family(m: dict):
    """The plain reference of ``m``'s family
    (``perfbench/reference/<family>.py``): besides the model, it gives
    the tree (``layout``) or a layer's layout (``layer_layout``), and
    the laws of its own (``LAWS``)."""
    return importlib.import_module(f"perfbench.reference.{m['family']}")


class Stack(dict):
    """A group of leaves stacked over layers: every leaf under it has a
    leading (layers,) axis."""


def stacked(one: dict, count: int) -> Stack:
    """``count`` layers of the layout ``one``, each leaf's shape with
    ``count`` in front."""
    def stack(node):
        if isinstance(node, dict):
            return {k: stack(v) for k, v in node.items()}
        return ((count,) + tuple(node[0]),) + tuple(node[1:])
    return Stack(stack(one))


def ends(m: dict) -> dict:
    """The leaves around the layers: the embedding (rows padded), the
    final norm and, unless tied, the unembedding."""
    vp = vocab_padded(m["vocab"])
    tree = {"embed": ((vp, m["d_model"]), "embed"),
            "final_norm": ((m["d_model"],), "ones")}
    if not m.get("tie_embeddings", False):
        tree["unembed"] = ((m["d_model"], vp), m["d_model"])
    return tree


def uniform(m: dict) -> dict:
    """The tree of a family that gives one layer's layout: :func:`ends`
    and ``n_layers`` of ``layer_layout`` under ``layers``."""
    return {**ends(m),
            "layers": stacked(family(m).layer_layout(m), m["n_layers"])}


def layout(m: dict) -> dict:
    """The tree of (shape, law[, dtype]) of a configuration's ``model``
    block: the family's ``layout(m)`` where it gives one, else
    :func:`uniform`. A law is a fan-in (an int) or the name of a fixed
    law."""
    fam = family(m)
    return fam.layout(m) if hasattr(fam, "layout") else uniform(m)


def leaves(tree: dict, prefix: str = ""):
    """(dotted path, leaf) in sorted-key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def dtype_of(m: dict, leaf: tuple) -> torch.dtype:
    return DTYPES[leaf[2] if len(leaf) > 2 else m["param_dtype"]]


def dtypes(m: dict) -> dict:
    """Dotted path → the dtype each leaf is served in."""
    return {k: dtype_of(m, v) for k, v in leaves(layout(m))}


def stacked_paths(m: dict) -> set:
    """The dotted paths of the leaves that lie in a :class:`Stack`."""
    def walk(node, prefix, inside):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}.",
                                inside or isinstance(v, Stack))
            elif inside:
                yield prefix + k
    return set(walk(layout(m), "", False))


def stream_seed(seed: int, *words) -> int:
    """A 63-bit seed for the stream named by ``words`` of run ``seed``."""
    key = [seed % (1 << 63)] + [int.from_bytes(w.encode(), "little")
                                if isinstance(w, str) else int(w)
                                for w in words]
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def _fill(t: torch.Tensor, law, gen: torch.Generator, laws: dict) -> None:
    if law == "ones":
        t.fill_(1)
    elif law == "embed":
        t.normal_(0.0, 0.02, generator=gen)
    elif isinstance(law, int):
        t.normal_(0.0, float(law) ** -0.5, generator=gen)
    else:
        laws[law](t, gen)


def make(m: dict, seed: int, device) -> dict:
    """The weights of ``m`` (a configuration's ``model`` block) from
    ``seed``, on ``device``, each leaf in its own dtype."""
    laws = getattr(family(m), "LAWS", {})
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "weights"))

    def build(sub):
        out = {}
        for k in sorted(sub):
            v = sub[k]
            if isinstance(v, dict):
                out[k] = build(v)
            else:
                out[k] = torch.empty(v[0], dtype=dtype_of(m, v),
                                     device=device)
                _fill(out[k], v[1], gen, laws)
        return out
    return build(layout(m))


def check(params: dict, want: dict) -> None:
    """Raise unless ``params`` has the program's tree ``want`` (leaves
    (shape, dtype), as ``abstract_params`` gives them), naming each leaf
    whose path, shape or dtype differs."""
    got = {k: (tuple(v.shape), v.dtype) for k, v in leaves(params)}
    want = {k: (tuple(v[0]), v[1]) for k, v in leaves(want)}
    bad = []
    for k in sorted(got.keys() | want.keys()):
        if k not in want:
            bad.append(f"{k} {got[k]} is not in the program's tree")
        elif k not in got:
            bad.append(f"{k} {want[k]} of the program's tree is not drawn")
        elif got[k] != want[k]:
            bad.append(f"{k} is {got[k]}, the program's {want[k]}")
    if bad:
        raise ValueError("the benchmark's weight tree differs from the "
                         "program's: " + "; ".join(bad))
