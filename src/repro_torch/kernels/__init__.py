# Custom SIMD instructions (paper §2.2, §4.1, §4.3) for the H100, ported so far:
#   stream_copy — c0 streaming family (memcpy / STREAM), K1 stage bodies
#   prefix_scan — c3_prefixsum / c4_chunkscan scans, K3 and K4 (CUDA)
#   sortnet     — c2_sort / c1_merge bitonic networks, K5/K6 (CUDA C++)
#   topk        — c5_topk key/payload network (MoE router), K7 (CUDA C++)
#   flashattn   — c6_flashattn blockwise online-softmax attention, K8 (CUDA C++)
# ops.py registers them in the ISA; ref.py holds the torch oracles.
from . import ops, ref  # noqa: F401  (importing ops registers the ISA)
