"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by one ``nvcc`` call into a shared
library with a plain C interface, loaded through ``ctypes``. The build runs
at first use, into ``kernels/_build/`` (listed in ``.gitignore``), under a
name that hashes the sources and flags, so an edited source never loads a
stale library. Nothing here runs at import time: the CPU test suite imports
every module on machines without ``nvcc`` or a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # A, B, C, batch, M, N, K, trans_a, trans_b, device, stream
    "rbr_matmul_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # g, m, v, step, v_out, n, b2, eps, bc1, bc2, device, stream
    "rbr_adam_scale_f32": (_P, _P, _P, _P, _P, _LL, _F, _F, _F, _F, _I, _P),
}


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date build was found
    log: str  # nvcc's output, including ptxas's register/spill report


_LOADED: Optional[KernelLibrary] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"librbr_kernels_{digest.hexdigest()[:16]}.so"
    build_seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _LOADED = KernelLibrary(lib, out, build_seconds, log)
    return _LOADED


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
