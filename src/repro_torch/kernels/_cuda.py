"""Build and load the port's CUDA C++ kernels.

Each source ``csrc/<stem>.cu`` exposes a plain C interface and is built
with ``nvcc`` into a shared library, which is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <build>/cuda/<stem>_<hash>.so \\
         csrc/<stem>.cu

The library is built at its first use in a process (or beforehand, all
sources at once, by :func:`build_all`), under the build
directory of ``core/fused_kernel.build_dir()`` (``build/repro_torch/``
in the checkout unless ``REPRO_TORCH_BUILD_DIR`` names another). Its
name carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. ``nvcc`` is found on
``PATH`` or under ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``).
``-Xptxas -v`` makes ptxas report each kernel's registers, shared memory
and spills; :data:`BUILD_LOG` keeps that report and the build's seconds
for every source built in this process.

Every exported launcher returns ``cudaGetLastError()`` as an ``int``;
:func:`check` raises on anything but 0. Nothing here falls back to a
plain version: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch.core.fused_kernel import build_dir

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

# libraries loaded in this process, by source stem
_LOADED: dict[str, ctypes.CDLL] = {}
#: sources built in this process: stem → {"seconds", "ptxas" (its report)}
BUILD_LOG: dict[str, dict] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                       "CUDA kernels build only where the CUDA toolkit is "
                       "installed")


def library_path(stem: str) -> Path:
    """Where the library of ``csrc/<stem>.cu`` is built: named by the hash
    of its source, the shared headers ``csrc/*.cuh`` and the build flags."""
    h = hashlib.sha256((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / "cuda" / f"{stem}_{h.hexdigest()[:16]}.so"


def build_all(stems=None) -> list[Path]:
    """Compile the libraries of ``stems`` (default: every ``csrc/*.cu``)
    that do not exist yet, one ``nvcc`` per source, all started together.
    Raises if any build fails."""
    if stems is None:
        stems = sorted(p.stem for p in CSRC.glob("*.cu"))
    outs = [library_path(stem) for stem in stems]
    todo = [(stem, out) for stem, out in zip(stems, outs) if not out.exists()]

    def build(stem: str, out: Path):
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")],
            capture_output=True, text=True)
        if proc.returncode:
            return f"nvcc failed on csrc/{stem}.cu:\n{proc.stderr[-4000:]}"
        os.replace(tmp, out)         # atomic: concurrent builds agree
        BUILD_LOG[stem] = {"seconds": time.perf_counter() - t0,
                           "ptxas": proc.stdout + proc.stderr}
        return None

    with ThreadPoolExecutor(max(len(todo), 1)) as pool:
        failed = [f for f in pool.map(lambda a: build(*a), todo) if f]
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def ptxas_usage(report: str) -> dict[str, dict]:
    """Per kernel (mangled name): registers, shared-memory bytes and spill
    stores from an ``-Xptxas -v`` report."""
    usage, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            usage[name] = {"registers": None, "smem_bytes": 0,
                           "spill_stores": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            usage[name]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            usage[name]["smem_bytes"] = int(sm.group(1)) if sm else 0
    return usage


def load(stem: str, signatures: dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if needed.
    ``signatures`` maps each exported launcher to its ``argtypes``; every
    launcher returns a CUDA error code (``int``)."""
    lib = _LOADED.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([stem])[0]))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LOADED[stem] = lib
    # each caller's launchers (one source may serve several wrappers, as
    # prefix_scan.cu serves K3 and K4): without argtypes ctypes would
    # pass every int as 32 bits and cut the pointers
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
