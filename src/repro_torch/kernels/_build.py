"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` into an object with a plain C interface; the objects
are linked into one shared library under ``build/repro_torch_kernels/<key>/``
at the repository root, where ``key`` hashes the sources and the flags. A
later call in the same process reuses the loaded library; a later process
reuses the built file. Nothing here runs at import time, and a failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"


@dataclass
class BuildInfo:
    """What the build did: where the library is, whether it was compiled in
    this process, how long that took and what ``ptxas -v`` said."""

    path: Path
    compiled: bool
    seconds: float
    ptxas: list[str] = field(default_factory=list)


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_info: BuildInfo | None = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("repro_torch kernels: nvcc not found (set CUDA_HOME "
                           "or put nvcc on PATH)")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key(sources: list[Path]) -> str:
    h = hashlib.sha256()
    for s in sources + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _ptxas_lines(text: str) -> list[str]:
    return [ln.strip() for ln in text.splitlines()
            if "ptxas info" in ln and ("Used" in ln or "Compiling" in ln
                                       or "spill" in ln)
            or "bytes stack frame" in ln or "ptxas warning" in ln]


def _compile(sources: list[Path], out: Path) -> list[str]:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [subprocess.Popen([nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(s),
                                   "-o", str(o)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name} "
                                   f"(exit {p.returncode}):\n{log}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                               *map(str, objs)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n"
                               f"{link.stdout}")
        os.replace(tmp_lib, out)          # atomic: readers see all or nothing
        (out.parent / "ptxas.txt").write_text("\n".join(logs))
    return _ptxas_lines("\n".join(logs))


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_flash_attention.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                          ci, ci, ci, ci, cf, ci, vp, vp]
    lib.repro_flash_attention.restype = ci
    lib.repro_decode_attention.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                           ci, ci, ci, ci, cf, ci, ci, vp]
    lib.repro_decode_attention.restype = ci
    lib.repro_flash_attention_smem.argtypes = [ci, ci]
    lib.repro_flash_attention_smem.restype = ctypes.c_longlong


def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if this checkout has none."""
    global _lib, _info
    if _lib is not None:              # the per-launch path: no lock
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        out_dir = BUILD_ROOT / _key(sources)
        out = out_dir / LIB_NAME
        t0 = time.perf_counter()
        compiled = not out.exists()
        if compiled:
            out_dir.mkdir(parents=True, exist_ok=True)
            ptxas = _compile(sources, out)
        else:
            log = out_dir / "ptxas.txt"
            ptxas = _ptxas_lines(log.read_text()) if log.exists() else []
        lib = ctypes.CDLL(str(out))
        _declare(lib)
        _info = BuildInfo(out, compiled, time.perf_counter() - t0, ptxas)
        _lib = lib
        return lib


def build_info() -> BuildInfo:
    """How the loaded library was obtained (builds it if needed)."""
    load()
    assert _info is not None
    return _info


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: the launch returned cudaError_t {err}")
