"""The share of device time launched inside the program's ``ssm.intra``
spans. In prefill (no grad, on the card) the span holds the chunk
output after K4: g's einsum (C against B within each chunk) and the SSD
chunk-output kernel, which builds the intra-chunk weights in registers
and adds the inter-chunk term and the D skip in the same pass. Where
that kernel declines a shape, the span holds the eager (B, C, Q, Q, H)
intra-chunk chain instead, from the decays through its einsum."""
from perfbench.lib import spans


def read(run):
    return spans.share(run, ["ssm.intra"])
