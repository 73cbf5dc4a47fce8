"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source in ``csrc/`` has a plain C interface and is compiled on first
use into its own shared library for ``sm_90a`` (Hopper):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, the headers of ``csrc/``
and the flags, so an edited source or header is rebuilt and a stale
library is never loaded.  :func:`build`
starts one ``nvcc`` per missing source, all at once, waits for them and
returns each one's seconds; a failed compile raises with ``nvcc``'s
stderr.  Nothing here runs at
import time: the CPU tests import every module on a machine without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
# <checkout>/build/repro_torch (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("ell_spmm", "ell_spmm_bwd", "csr_spmm", "gather_rows",
           "edge_dvals", "edge_softmax", "flash_attn", "flash_attn_bwd",
           "decode_attn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.PyDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    text = b"".join(f.read_bytes() for f in [CSRC / f"{name}.cu",
                                             *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together; returns each
    compiled source's seconds."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()

    def compile_one(name):
        out = _lib_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(tmp, out)
            return time.perf_counter() - t0, None
        tmp.unlink(missing_ok=True)
        return None, (f"nvcc failed on csrc/{name}.cu "
                      f"(exit {proc.returncode}):\n{proc.stderr}")

    with ThreadPoolExecutor(len(todo)) as pool:
        done = dict(zip(todo, pool.map(compile_one, todo)))
    errors = [err for _, err in done.values() if err]
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: sec for name, (sec, _) in done.items()}


def load(name: str) -> ctypes.PyDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    Loaded as a ``PyDLL``: its entry points only enqueue a launch, so a
    call keeps the interpreter lock rather than paying to release and take
    it back (the row gather is called per served micro-batch)."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.PyDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib
