"""ctypes loader for the native host-side rules core (``xq_core.cpp``).

The port's copy of ``xiangqi_alphazero_tpu.engine.native``, with the same
C++ source and the same functions. It builds with the host's C++ compiler
(``$CXX``, else ``g++``, else ``c++``) at first use, never at import, and
degrades to the pure-Python oracle when no compiler is present (the
reference's Cython loader's contract, training/game.py:31-47).

The library goes into the package's ignored ``_build/``, named by a hash of
the source and the flags, so an edited source is rebuilt and a stale one is
never loaded. Each build writes a temporary file of its own and moves it
into place with ``os.replace``, so processes that build at once (test
workers) never load half a file.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "xq_core.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "_build"
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def compiler() -> Optional[str]:
    """The host C++ compiler, or None."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    return None


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libxq_core-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    cxx = compiler()
    if cxx is None:
        logger.warning("no C++ compiler found; using the Python rules")
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        logger.warning("native engine build failed (%s); using the Python rules", e)
        return False
    os.replace(tmp, out)
    return True


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native core; None when unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = library_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        logger.warning("native engine load failed (%s)", e)
        return None
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.xq_find_king.argtypes = [i8p, ctypes.c_int]
    lib.xq_find_king.restype = ctypes.c_int
    lib.xq_is_attacked.argtypes = [i8p, ctypes.c_int, ctypes.c_int]
    lib.xq_is_attacked.restype = ctypes.c_int
    lib.xq_is_in_check.argtypes = [i8p, ctypes.c_int]
    lib.xq_is_in_check.restype = ctypes.c_int
    lib.xq_gen_legal.argtypes = [i8p, ctypes.c_int, i32p, ctypes.c_int]
    lib.xq_gen_legal.restype = ctypes.c_int
    lib.xq_has_legal.argtypes = [i8p, ctypes.c_int]
    lib.xq_has_legal.restype = ctypes.c_int
    lib.xq_minimax_move.argtypes = [
        i8p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
    ]
    lib.xq_minimax_move.restype = ctypes.c_int32
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _board(board: np.ndarray) -> np.ndarray:
    b = np.ascontiguousarray(board, np.int8).reshape(-1)
    if b.shape != (90,):
        raise ValueError(f"a board has 90 squares, got {b.shape[0]}")
    return b


def _lib_or_raise() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("the native rules core is not built (no C++ compiler?)")
    return lib


def gen_legal(board: np.ndarray, side: int) -> List[int]:
    """Legal actions (ascending). board: int8[90]."""
    out = np.empty(128, np.int32)
    n = _lib_or_raise().xq_gen_legal(_board(board), side, out, 128)
    return out[:n].tolist()


def is_in_check(board: np.ndarray, side: int) -> bool:
    return bool(_lib_or_raise().xq_is_in_check(_board(board), side))


def is_attacked(board: np.ndarray, sq: int, by: int) -> bool:
    return bool(_lib_or_raise().xq_is_attacked(_board(board), sq, by))


def find_king(board: np.ndarray, side: int) -> Optional[int]:
    k = _lib_or_raise().xq_find_king(_board(board), side)
    return None if k < 0 else int(k)


def has_legal(board: np.ndarray, side: int) -> bool:
    return bool(_lib_or_raise().xq_has_legal(_board(board), side))


def minimax_move(board: np.ndarray, side: int, depth: int,
                 seed: int = 1) -> Optional[int]:
    """Alpha-beta minimax action (from*90+to), the external Elo anchor
    opponent: the semantics of ``serve/static/engine.js``'s minimaxMove
    (reference: web/client/src/lib/xiangqi-engine.ts:292-357). None if no
    legal move."""
    a = int(_lib_or_raise().xq_minimax_move(
        _board(board), side, depth, ctypes.c_uint64(seed & (2**64 - 1)),
    ))
    return None if a < 0 else a
