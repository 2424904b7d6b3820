"""Torch-eager oracles for the ported SIMD instructions.

These are the "base RV32IM core runs it in software" implementations
from the paper's evaluation (§4.2/§4.3 baselines): semantically
identical to the GPU kernels, written with stock torch ops only.

torch has no public associative scan: where the reference's oracles
call ``jax.lax.associative_scan``, these run a log-step doubling
(Hillis–Steele) under the same combine, which is the same function up
to the order of roundings.
"""
from __future__ import annotations

import torch


# -- c2_sort / c1_merge (sorting networks, §4.3.1) ---------------------------

def sort_chunks(x: torch.Tensor, width: int = 8,
                descending: bool = False) -> torch.Tensor:
    """Sort each contiguous chunk of `width` elements along the last axis."""
    if x.shape[-1] % width:
        raise ValueError(f"last dim {x.shape[-1]} % width {width} != 0")
    shp = x.shape
    s = torch.sort(x.reshape(*shp[:-1], shp[-1] // width, width),
                   dim=-1).values
    if descending:
        s = s.flip(-1)
    return s.reshape(shp)


def merge_sorted(a: torch.Tensor, b: torch.Tensor,
                 width: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two sorted vectors (paper c1_merge): returns (lower, upper).

    a, b: (..., n), each `width`-chunk sorted ascending (width=None → whole
    row). Per chunk, output the lower/upper halves of the sorted 2w-element
    union (written back to v1/v2 in the paper).
    """
    n = a.shape[-1]
    w = width or n
    ar = a.reshape(*a.shape[:-1], n // w, w)
    br = b.reshape(*b.shape[:-1], n // w, w)
    s = torch.sort(torch.cat([ar, br], dim=-1), dim=-1).values
    return (s[..., :w].reshape(a.shape), s[..., w:].reshape(a.shape))


def mergesort(x: torch.Tensor) -> torch.Tensor:
    """Full sort along the last axis (mergesort app oracle)."""
    return torch.sort(x, dim=-1).values


# -- c3_prefixsum (Hillis–Steele + carry, §4.3.2) ----------------------------

def prefix_sum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inclusive prefix sum (the arbitrarily-long carried scan's semantics)."""
    return torch.cumsum(x, dim=axis, dtype=x.dtype)


def serial_prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """The paper's *serial* baseline: one element per step."""
    c = torch.zeros_like(x[..., 0])
    out = []
    for i in range(x.shape[-1]):
        c = c + x[..., i]
        out.append(c)
    return torch.stack(out, dim=-1)


# -- c4_chunkscan (affine carried scan; SSD inter-chunk recurrence) ----------

def shifted(x: torch.Tensor, d: int, dim: int, fill) -> torch.Tensor:
    """Value at index i-d along ``dim``; ``fill`` where i < d."""
    n = x.shape[dim]
    pad = torch.full_like(x.narrow(dim, 0, min(d, n)), fill)
    return torch.cat([pad, x.narrow(dim, 0, max(n - d, 0))], dim=dim)


def chunk_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y[..., i] = a[..., i] * y[..., i-1] + b[..., i]  (y[-1] = 0).

    The generalisation of c3_prefixsum's carry from (+) to an affine map —
    exactly the inter-chunk state recurrence of Mamba2's SSD. The output
    dtype is promote(a, b).
    """
    return chunk_scan_state(a, b, axis=a.ndim - 1)


def chunk_scan_state(a: torch.Tensor, b: torch.Tensor,
                     axis: int = 1) -> torch.Tensor:
    """Affine carried scan with a SHARED decay per state block:
    a: (..., C, ...) scalars, b: a.shape + (P, N) states; scan along `axis`.
    Broadcast-free (the decay is never materialised at state rank)."""
    axis %= a.ndim
    extra = (1,) * (b.ndim - a.ndim)
    A = a
    B = b.to(torch.promote_types(a.dtype, b.dtype))
    d, n = 1, a.shape[axis]
    while d < n:           # (A, B)_i ∘ (A, B)_{i-d}: the combine of ref.py
        B = B + A.reshape(A.shape + extra) * shifted(B, d, axis, 0)
        A = A * shifted(A, d, axis, 1)
        d *= 2
    return B


# -- c0_lv / c0_sv (streaming, §4.1) + STREAM kernels ------------------------

def stream_copy(x: torch.Tensor) -> torch.Tensor:
    return x.clone()          # a materialised copy, never a view

def stream_scale(x: torch.Tensor, s) -> torch.Tensor:
    return x * s

def stream_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b

def stream_triad(a: torch.Tensor, b: torch.Tensor, s) -> torch.Tensor:
    return a + s * b


# -- c5_topk (router top-k via sorting network) ------------------------------

_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
         torch.float16: torch.int16, torch.float64: torch.int64}


def sortable_key(x: torch.Tensor) -> torch.Tensor:
    """An integer key per element whose order is ``lax.top_k``'s order of
    the values: for floats the bits ``b`` of each value map to
    ``b ^ ((b >> 31) & 0x7fffffff)`` (on 16 bits for bfloat16), so that
    +0.0 ranks above -0.0, a NaN with a clear sign bit above +inf and one
    with the sign bit set below -inf; integers are their own key."""
    if not x.dtype.is_floating_point:
        return x
    b = x.view(_BITS[x.dtype])
    return b ^ ((b >> (8 * b.element_size() - 1)) & torch.iinfo(b.dtype).max)


def topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis: (values descending, int32 indices) in
    ``lax.top_k``'s order: :func:`sortable_key` descending, equal keys in
    ascending index order (a stable sort; ``torch.topk`` promises no
    order for ties, and ``torch.sort`` puts NaN first whatever its sign
    and does not tell -0.0 from +0.0). Values leave by their own bits
    (gathered as integers: a bfloat16 gather makes every NaN one NaN)."""
    _, idx = torch.sort(sortable_key(x), dim=-1, descending=True,
                        stable=True)
    idx = idx[..., :k]
    bits = x.view(_BITS.get(x.dtype, x.dtype))
    return (torch.gather(bits, -1, idx).view(x.dtype),
            idx.to(torch.int32))


# -- c6_flashattn (fused attention "instruction") ----------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Oracle attention. q,k,v: (batch, heads, seq, head_dim); GQA is
    handled by the caller (kv heads repeated before the call). The causal
    mask is aligned bottom-right (``tril(k=sk-sq)``)."""
    *_, sq, d = q.shape
    sk = k.shape[-2]
    if scale is None:
        scale = d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)
