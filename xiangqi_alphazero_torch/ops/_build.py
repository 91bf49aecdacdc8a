"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher and is
compiled for Hopper (``sm_90a``) into a shared library under ``_build/``
(listed in ``.gitignore``), named by a hash of the source and the flags, so
an edited source is rebuilt and a stale library is never loaded. The library
is loaded with ``ctypes``; no PyTorch headers are compiled, so a build takes
seconds. Builds happen at first use, never at import.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers, shared memory and spills per kernel
)


@dataclasses.dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float   # 0.0 when the library was already built
    log: str         # nvcc's output (the -Xptxas -v summary), "" if cached


def nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def sources() -> List[str]:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build(name: str, src: Optional[Path] = None) -> BuildResult:
    """Compile ``csrc/<name>.cu`` (or the source ``src``, under ``name``)
    unless that exact source is built already."""
    src = CSRC_DIR / f"{name}.cu" if src is None else Path(src)
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return BuildResult(name, out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    return BuildResult(name, out, seconds, log)


def build_all(names: Iterable[str] = (), extra: Optional[Dict[str, Path]] = None
              ) -> Dict[str, BuildResult]:
    """Build several sources at once, one ``nvcc`` process each: the named
    ``csrc/`` sources (all of them by default) and ``extra`` sources given
    by name and path."""
    jobs = {n: None for n in (list(names) or sources())}
    jobs.update(extra or {})
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        futures = {n: ex.submit(build, n, src) for n, src in jobs.items()}
        return {n: f.result() for n, f in futures.items()}


_LOADED: Dict[str, ctypes.CDLL] = {}


def load(name: str, src: Optional[Path] = None) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` or of ``src`` (building it if
    needed)."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name, src).path))
    return _LOADED[name]
