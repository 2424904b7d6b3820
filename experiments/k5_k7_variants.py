"""How K5's loads and K7's walk set their time on the H100.

Builds variants of ``src/repro_torch/kernels/csrc/sortnet.cu`` and
``csrc/topk.cu`` in a temporary directory (as ``k8_accumulation.py``
does), holds each bit for bit against the plain version or the oracle,
and prints one JSON line per variant with its device ms
(``chip_smoke.time_ms``) and the card.

K5 at the mergesort app's width 8 (2²⁶ int32 keys, one row):

* ``as is`` — the source: each warp loads its 512 keys as 16-byte
  vectors on consecutive addresses and hands every lane its 16 keys
  through a swizzled shared-memory stage, and the same backwards for the
  stores;
* ``per-thread vectors`` — the first design: each thread loads and
  stores its own 16 consecutive keys as four 16-byte vectors (a 64-byte
  stride across the warp);
* the same with the key-by-key tail path compiled out (the input has no
  ragged tile), and with streaming hints (``__ldcs`` / ``__stcs``).

K7 at the MoE router's shapes (float32 logits of 384 experts read in
place as rows of 512, k 8): 4096 prefill rows and 4 decode rows:

* ``as is`` — batches of 8 keys sorted in registers and merged into the
  lane's list; 32 lanes a row for the decode step's 4 rows, 8 for the
  prefill's 4096;
* ``per-key insertion`` — each key inserted into the list in turn;
* ``G = 32`` — 32 lanes a row whatever the rows.

Needs the card and nvcc; run from the root of a checkout:

    python3 experiments/k5_k7_variants.py
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _cuda, ref  # noqa: E402
from repro_torch.kernels import sortnet as sn  # noqa: E402
from repro_torch.kernels import topk as tk  # noqa: E402

N, WIDTH = 1 << 26, 8
ROUTER = ((4096, 384), (4, 384))
NPOW, TOP_K = 512, 8

K5_WHOLE = ("const bool whole = vec && w0 + 32 * PER_THREAD <= n;"
            "   // warp-uniform")
K5_IN = ("    const uint4* src = reinterpret_cast<const uint4*>(x + w0);",
         "    for (int t = 0; t < PER_THREAD; ++t) v[t] = K::in(raw[t]);\n")
K5_OUT = ("    alignas(16) T raw[PER_THREAD];\n#pragma unroll\n"
          "    for (int t = 0; t < PER_THREAD; ++t) raw[t] = K::out(v[t]);",
          "      dst[j * 32 + lane] = stage[stage_slot<U>(j * 32 + lane)];\n")
K5_LOAD = ("reinterpret_cast<uint4*>(raw)[k] = "
           "reinterpret_cast<const uint4*>(p)[k];")
K5_STORE = ("reinterpret_cast<uint4*>(p)[k] = "
            "reinterpret_cast<const uint4*>(raw)[k];")
K7_WALK_START = "    if (vec) {                       // batches"
K7_WALK_END = "    const int pad_end = min(npow, n + KP);"
K7_INSERT = """    if (vec) {
      const int nv = n / V;
      for (int v = sub; v < nv; v += g) {
        alignas(16) T raw[V];
        *reinterpret_cast<uint4*>(raw) =
            reinterpret_cast<const uint4*>(xr)[v];
#pragma unroll
        for (int t = 0; t < V; ++t)
          insert(list, pack(O::key(raw[t]), v * V + t));
      }
      done = nv * V;
    }
    for (int i = done + sub; i < n; i += g)
      insert(list, pack(O::key(xr[i]), i));
"""
K7_G = "  while (log2_g > 3 && (rows << log2_g) > 32768) --log2_g;\n"


def cut(src: str, first: str, last: str, new: str) -> str:
    """src with the text from ``first`` through ``last`` replaced."""
    a = src.index(first)
    b = src.index(last, a) + len(last)
    return src[:a] + new + src[b:]


def k5_variants(src: str) -> dict[str, str]:
    for piece in (K5_WHOLE, *K5_IN, *K5_OUT, K5_LOAD, K5_STORE):
        assert src.count(piece) == 1, piece
    # the first design: each thread's 16 keys as 16-byte loads and stores
    # of its own (a 64-byte stride across the warp)
    own = cut(cut(src, *K5_IN, "    load_run<T, PER_THREAD>(x + g0, v);\n"),
              *K5_OUT, "    store_run<T, PER_THREAD>(out + g0, v);\n")
    own = own.replace(K5_WHOLE,
                      "const bool whole = vec && g0 + PER_THREAD <= n;")
    return {
        "as is": src,
        "per-thread vectors": own,
        "per-thread vectors, no key-by-key path": own.replace(
            "const bool whole = vec && g0 + PER_THREAD <= n;",
            "const bool whole = true;"),
        "per-thread vectors, streaming hints": own.replace(K5_LOAD, (
            "reinterpret_cast<uint4*>(raw)[k] = "
            "__ldcs(reinterpret_cast<const uint4*>(p) + k);")).replace(
            K5_STORE, ("__stcs(reinterpret_cast<uint4*>(p) + k, "
                       "reinterpret_cast<const uint4*>(raw)[k]);"))}


def k7_variants(src: str) -> dict[str, str]:
    for piece in (K7_WALK_START, K7_WALK_END, K7_G):
        assert src.count(piece) == 1, piece
    a, b = src.index(K7_WALK_START), src.index(K7_WALK_END)
    return {"as is": src,
            "per-key insertion": src[:a] + K7_INSERT + src[b:],
            "G = 32": src.replace(K7_G, "")}


def build(tmp: Path, stem: str, name: str, src: str, signatures):
    d = tmp / "".join(c if c.isalnum() else "_" for c in name)
    shutil.copytree(_cuda.CSRC, d)
    (d / f"{stem}.cu").write_text(src)
    lib_path = d / f"{stem}.so"
    subprocess.run([_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib_path),
                    str(d / f"{stem}.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main() -> int:
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        print("k5_k7_variants: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        v = smoke.sort_keys(smoke.SEED + 4, N, dev)
        want = sn.sort_chunks_plain(v[None], WIDTH)[0]
        src = (_cuda.CSRC / "sortnet.cu").read_text()
        for name, text in k5_variants(src).items():
            lib = build(tmp, "sortnet", "k5 " + name, text, sn._SIGNATURES)
            out = torch.empty_like(v)

            def call():
                err = lib.k5_sort_chunks(1, v.data_ptr(), out.data_ptr(), N,
                                         WIDTH, 0, stream())
                assert err == 0, err

            call()
            exact = torch.equal(out, want)
            ok &= exact
            print(json.dumps({"kernel": "K5", "variant": name, "w": WIDTH,
                              "dtype": "int32", "exact": exact,
                              "ms": smoke.time_ms(call)[0]}), flush=True)
        del v, want
        rng = np.random.default_rng(smoke.SEED + 14)
        src = (_cuda.CSRC / "topk.cu").read_text()
        inputs = [torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev) for shape in ROUTER]
        wants = [ref.topk(tk.pad_to(x, NPOW), TOP_K) for x in inputs]
        for name, text in k7_variants(src).items():
            lib = build(tmp, "topk", "k7 " + name, text, tk._SIGNATURES)
            for x, (wv, wi) in zip(inputs, wants):
                rows = x.shape[0]
                vals = torch.empty((rows, TOP_K), device=dev)
                idx = torch.empty((rows, TOP_K), dtype=torch.int32,
                                  device=dev)

                def call():
                    err = lib.k7_topk_partial(
                        0, x.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                        rows, x.stride(0), x.shape[1], NPOW, TOP_K, stream())
                    assert err == 0, err

                call()
                exact = torch.equal(vals, wv) and torch.equal(idx, wi)
                ok &= exact
                print(json.dumps({"kernel": "K7", "variant": name,
                                  "shape": list(x.shape), "npow": NPOW,
                                  "k": TOP_K, "exact": exact,
                                  "ms": smoke.time_ms(call)[0]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
