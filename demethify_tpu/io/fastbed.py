"""ctypes binding for the native TSV/CSV column parser (_fastbed.cpp).

The shared library is compiled lazily with g++ on first use and cached
next to the source (falls back to a user cache dir when the package is
read-only). Everything degrades gracefully: `available()` is False when no
compiler is present, and `parse_columns` then parses in Python with the
same missing-value rules.
"""

import ctypes
import hashlib
import math
import os
import subprocess
import tempfile
from typing import List, Optional, Sequence

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "_fastbed.cpp")
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _cache_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    name = f"_fastbed_{digest}.so"
    pkg_dir = os.path.dirname(_SRC)
    if os.access(pkg_dir, os.W_OK):
        return os.path.join(pkg_dir, name)
    cache = os.path.join(tempfile.gettempdir(), "demethify_tpu_native")
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, name)


def _build(so_path: str) -> bool:
    # build under a private name and rename: concurrent first uses (test
    # workers, processes of one run) never load a half-written library
    tmp_path = f"{so_path}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             _SRC, "-o", tmp_path],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp_path, so_path)
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    so_path = _cache_path()
    if not os.path.exists(so_path) and not _build(so_path):
        _lib_failed = True
        return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        _lib_failed = True
        return None
    lib.fastbed_count_rows.argtypes = [ctypes.c_char_p]
    lib.fastbed_count_rows.restype = ctypes.c_long
    lib.fastbed_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_char,
        ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ctypes.POINTER(ctypes.c_double), ctypes.c_long,
    ]
    lib.fastbed_parse.restype = ctypes.c_long
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def read_header(path: str, delim: str) -> List[str]:
    with open(path, "r") as f:
        return f.readline().rstrip("\r\n").split(delim)


def _to_float(field: str) -> float:
    try:
        return float(field)
    except ValueError:              # "", "NA", "." and other text
        return math.nan


def _parse_python(path: str, idx: Sequence[int], delim: str) -> np.ndarray:
    """The native parser's semantics in Python: missing fields, short
    rows and text parse as NaN."""
    rows = []
    with open(path, "r") as f:
        f.readline()
        for line in f:
            fields = line.rstrip("\r\n").split(delim)
            rows.append([_to_float(fields[i]) if i < len(fields)
                         else math.nan for i in idx])
    return np.asarray(rows, np.float64).reshape(len(rows), len(idx))


def parse_columns(path: str, columns: Sequence[str],
                  delim: str = "\t") -> np.ndarray:
    """Parse the named numeric columns of a delimited file with header.

    Returns float64 array of shape (n_rows, len(columns)); missing/invalid
    fields are NaN. Uses the native parser when it is available, else a
    Python parser with the same rules.
    """
    header = read_header(path, delim)
    try:
        idx = [header.index(c) for c in columns]
    except ValueError as e:
        raise KeyError(f"column not found in {path}: {e}") from e
    if not available():
        return _parse_python(path, idx, delim)
    lib = _load()

    path_b = path.encode()
    n_rows = lib.fastbed_count_rows(path_b)
    if n_rows < 0:
        raise RuntimeError(f"fastbed: cannot read {path}")
    out = np.empty((n_rows, len(idx)), dtype=np.float64)
    idx_arr = (ctypes.c_long * len(idx))(*idx)
    got = lib.fastbed_parse(
        path_b, delim.encode()[0], idx_arr, len(idx),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n_rows)
    if got < 0:
        raise RuntimeError(f"fastbed: parse failed for {path}")
    return out[:got]
