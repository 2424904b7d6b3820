"""The benchmark's operation and byte counts against hand-worked numbers."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.counts import k4, ssm  # noqa: E402
from perfbench.lib import peaks  # noqa: E402


def _model(name: str) -> dict:
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())["model"]


def test_k4_bytes_at_phase_j_shape():
    # (4, 32, 64, 64, 128): 8192 decays, 67108864 state elements read and
    # as many written, float32
    n = k4.state_scan_bytes(4, 32, 64, 64, 128)
    assert n == (8192 + 2 * 67108864) * 4 == 536903680
    assert abs(n / peaks.HBM_BYTES_PER_S * 1e3 - 0.16027) < 1e-5


def test_one_mamba2_layer():
    m = _model("mamba2-1.3b")
    # in-projections 2·2048·(2·4096 + 2·128 + 64), conv 2·4·(4096 + 256),
    # out-projection 2·4096·2048
    assert ssm.dense_flops(m) == 34865152 + 34816 + 16777216
    # + the causal half of the chunk's form 2·(257/2)·(128 + 4096)
    # + the chunk states in and out 4·128·4096
    assert ssm.prompt_token_flops(m) == 51677184 + 1085568 + 2097152
    assert ssm.step_token_flops(m) == 51677184 + 2097152
    assert ssm.request_flops(m, 1, 256, 1) == \
        48 * 256 * 54859904 + 2 * 2048 * 50280


def test_one_mamba2_training_row():
    m = _model("mamba2-1.3b")
    # forward (every position's logits) and backward at twice it
    assert ssm.train_flops(m, 1, 256) == \
        3 * (48 * 256 * 54859904 + 256 * 2 * 2048 * 50280)


def test_k4_reverse_walk_bytes():
    # decays, incoming gradient and forward output read, gradient written
    assert k4.reverse_walk_bytes(4, 16, 64, 64, 128) == \
        (4096 + 3 * 33554432) * 4
