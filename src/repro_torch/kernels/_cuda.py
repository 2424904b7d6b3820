"""Build and load the port's CUDA C++ kernels.

Each source ``csrc/<stem>.cu`` exposes a plain C interface and is built
with ``nvcc`` into a shared library, which is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <build>/cuda/<stem>_<hash>.so csrc/<stem>.cu

The library is built at its first use in a process (or beforehand, all
sources at once, by :func:`build_all`), under the build
directory of ``core/fused_kernel.build_dir()`` (``build/repro_torch/``
in the checkout unless ``REPRO_TORCH_BUILD_DIR`` names another). Its
name carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. ``nvcc`` is found on
``PATH`` or under ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``).

Every exported launcher returns ``cudaGetLastError()`` as an ``int``;
:func:`check` raises on anything but 0. Nothing here falls back to a
plain version: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from repro_torch.core.fused_kernel import build_dir

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

# libraries loaded in this process, by source stem
_LOADED: dict[str, ctypes.CDLL] = {}


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
    procs = []
    for stem, out in zip(stems, outs):
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs.append((stem, out, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for stem, out, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed on csrc/{stem}.cu:\n{err[-4000:]}")
        else:
            os.replace(tmp, out)     # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(stem: str, signatures: dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if needed.
    ``signatures`` maps each exported launcher to its ``argtypes``; every
    launcher returns a CUDA error code (``int``)."""
    lib = _LOADED.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([stem])[0]))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LOADED[stem] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
