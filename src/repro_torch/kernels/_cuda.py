"""Build and load the port's CUDA C++ kernels.

Each source ``csrc/<stem>.cu`` exposes a plain C interface and is built
with ``nvcc`` into a shared library, which is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <build>/cuda/<stem>_<hash>.so csrc/<stem>.cu

The library is built at its first use in a process, under the build
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
    of its source and the build flags."""
    h = hashlib.sha256((CSRC / f"{stem}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / "cuda" / f"{stem}_{h.hexdigest()[:16]}.so"


def build(stem: str) -> Path:
    """Compile ``csrc/<stem>.cu`` unless its library already exists."""
    out = library_path(stem)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC / f"{stem}.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on csrc/{stem}.cu:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)           # atomic: concurrent builds agree
    return out


def load(stem: str, signatures: dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if needed.
    ``signatures`` maps each exported launcher to its ``argtypes``; every
    launcher returns a CUDA error code (``int``)."""
    lib = _LOADED.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build(stem)))
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
