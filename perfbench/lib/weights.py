"""The weights of a cell, made on the device from the run's seed.

The tree has the layout the port's functions read (nested dicts; each
layer's leaves stacked on a leading (L,) axis), and the plain references
read the same tensors. Each leaf is drawn in one call from one
``torch.Generator`` on the device, in the dtype it is served in, so set-up
holds no float32 copy and draws a few GB in well under a second.

Laws: N(0, 0.02) for the embedding; N(0, fan_in^-1/2) for a product's
weight, fan_in being the size of the dims it contracts; ones for the
norms; any other law is the family's own, named in its reference's
``LAWS`` (``perfbench/reference/<family>.py``), which also gives the
layout of one layer. A new family is a new reference file, with no
file here edited.
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
    (``perfbench/reference/<family>.py``): besides the model, it gives a
    layer's layout (``layer_layout``) and the laws of its own (``LAWS``)."""
    return importlib.import_module(f"perfbench.reference.{m['family']}")


def layout(m: dict) -> dict:
    """The tree of (shape, law) of a configuration's ``model`` block; a
    law is a fan-in (an int) or the name of a fixed law."""
    def stack(leaf):
        if isinstance(leaf, dict):
            return {k: stack(v) for k, v in leaf.items()}
        return ((m["n_layers"],) + leaf[0], leaf[1])
    vp = vocab_padded(m["vocab"])
    tree = {"embed": ((vp, m["d_model"]), "embed"),
            "layers": stack(family(m).layer_layout(m)),
            "final_norm": ((m["d_model"],), "ones")}
    if not m.get("tie_embeddings", False):
        tree["unembed"] = ((m["d_model"], vp), m["d_model"])
    return tree


def leaves(tree: dict, prefix: str = ""):
    """(dotted path, leaf) in sorted-key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


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
    ``seed``, on ``device``, in ``m["param_dtype"]``."""
    dtype = DTYPES[m["param_dtype"]]
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
                out[k] = torch.empty(v[0], dtype=dtype, device=device)
                _fill(out[k], v[1], gen, laws)
        return out
    return build(layout(m))
