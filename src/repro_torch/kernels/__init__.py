# Custom SIMD instructions (paper §2.2, §4.1) for the H100, ported so far:
#   stream_copy — c0 streaming family (memcpy / STREAM), K1 stage bodies
# ops.py registers them in the ISA; ref.py holds the torch oracles.
from . import ops, ref  # noqa: F401  (importing ops registers the ISA)
