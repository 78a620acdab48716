"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and compiles on its
own into ``build/repro_torch/<name>-<hash>.so`` at the repository root (a
directory ``.gitignore`` lists).  The hash covers the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source builds anew and
an unchanged one loads from disk.  Separate sources build in parallel
(``build_all``).  The build runs at first use, never at import: importing
this module needs no compiler and no card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: sm_90a (not sm_90): Hopper's arch-specific target; -Xptxas -v reports
#: registers, shared memory and spills of every kernel into the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    path: Path
    seconds: float  # compile time; 0.0 when loaded from an earlier build
    log: str  # nvcc's stderr (the -Xptxas -v report)


def find_nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        cands.insert(0, str(Path(cuda_home) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (looked at $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the port's CUDA kernels build "
                       "on a machine with the CUDA toolkit")


def digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, every ``csrc/*.cuh`` header and the
    flags: the part of the library's file name that changes with them."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source and
    flag set exists; raises with nvcc's output when the compile fails."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"{name}-{digest(name)}.so"
    if out.exists():
        return Built(out, 0.0, "")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return Built(out, time.perf_counter() - t0, proc.stderr)


def build_all(names: list[str]) -> dict[str, Built]:
    """Build several sources at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


_LOADED: dict[str, tuple[ctypes.CDLL, Built]] = {}


def load(name: str) -> tuple[ctypes.CDLL, Built]:
    """Build (if needed) and load ``csrc/<name>.cu``; one load per process."""
    if name not in _LOADED:
        built = build(name)
        _LOADED[name] = (ctypes.CDLL(str(built.path)), built)
    return _LOADED[name]


@functools.lru_cache(maxsize=None)
def entry(name: str, symbol: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` (built and loaded
    at first use), returning a cudaError_t as int.  Pass every pointer and
    the stream as ``ctypes.c_void_p``: a bare Python int would be cut to
    32 bits."""
    lib, _ = load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
