"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded through ``ctypes``. The build runs at first use,
into ``kernels/_build/`` (listed in ``.gitignore``), under a name that
hashes the sources, headers and flags, so an edited source never loads a
stale library. Processes that start together (the ranks of a multi-process
run) take a lock on the build directory: the first builds, the others wait
and load its library. Nothing here runs at import time: the CPU test suite
imports every module on machines without ``nvcc`` or a GPU.
"""
from __future__ import annotations

import ctypes
import fcntl
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # ptrs (int64 A, B, C per problem), dims (int32 M, N, K, batch, flags per
    # problem), tile_start (int32, count + 1), count, trans_a, trans_b, device, stream
    "rbr_matmul_grouped_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
    # ptrs (int64 g, m, v, step, v_out per leaf), n (int64 per leaf), vec (int32 per
    # leaf), chunk_start (int32, count + 1), count, chunk, b2, eps, bc1, bc2, device,
    # stream
    "rbr_adam_scale_grouped_f32": (_P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _I, _P),
}
# host ns to encode the TMA tensor maps of one bf16 forward launch (three) or
# backward launch (four): x, BH, S, dh, reps
_SIGNATURES["rbr_flash_fwd_bf16_maps_ns"] = (_P, _I, _I, _I, _I)
_SIGNATURES["rbr_flash_bwd_bf16_maps_ns"] = (_P, _I, _I, _I, _I)
# the flash kernels, each with a float32 and a bfloat16 entry point of one signature
for _dt in ("f32", "bf16"):
    _SIGNATURES.update({
        # q, k, v, o, L, BH, S, dh, seq_len, causal, window, scale, device, stream
        f"rbr_flash_fwd_{_dt}": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
        # q, k, v, dO, L, D, dq, BH, S, dh, causal, window, scale, device, stream
        f"rbr_flash_bwd_dq_{_dt}": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                                    _P),
        # q, k, v, dO, L, D, dk, dv, BH, S, dh, causal, window, scale, device, stream
        f"rbr_flash_bwd_dkv_{_dt}": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                     _I, _P),
    })


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


def _compile_and_link(sources, out: Path) -> str:
    """One ``nvcc -c`` per source, all running at once, then one link.
    Returns the compilers' output; raises if any step fails."""
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    log, failed = "", []
    for src, proc in zip(sources, procs):
        text, _ = proc.communicate()
        log += f"== {src.name}\n{text}"
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = out.with_name(f"{tag}.tmp.so")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    return log


def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"librbr_kernels_{digest.hexdigest()[:16]}.so"
    build_seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # one builder; the others wait for it
            if not out.exists():
                t0 = time.perf_counter()
                log = _compile_and_link(sources, out)
                build_seconds = time.perf_counter() - t0
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
