"""ctypes bindings of the native decode-ahead image loader (counterpart of
nrslam_tpu/datasets/native_loader.py).

``native/dataloader.cc`` (a multithreaded PNG / JPEG prefetch pipeline with
a plain C interface, frames decoded to float32 BT.601 luma) is built here
with the compiler and flags of ``native/Makefile``, into
``nrslam_tpu_torch/kernels/_build/`` (gitignored; the library's name
carries a hash of the source), never into ``native/``. It needs g++ and
the libpng / libjpeg headers: ``available()`` says whether it built and
loaded. Nothing on the port's disk path depends on it; nothing is built at
import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dataloader.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "kernels" / "_build"
# native/Makefile's rule: $(CXX) $(CXXFLAGS) -shared -o $@ $< $(LDLIBS).
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared"]
LIBS = ["-lpng", "-ljpeg", "-lpthread"]

_F = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode()
                            + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libnrslam_dataloader_{digest}.so"


def _compile(so: Path) -> None:
    """Compile the library into ``so`` (replaced in one step, so a process
    loading it meanwhile sees the old file or the new one). Raises on
    failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, so.name)
        proc = subprocess.run(
            [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", out,
             str(SOURCE), *LIBS], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native loader build failed:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(out, so)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the loader library. Raises on failure."""
    so = _library_path()
    if not so.exists():
        _compile(so)
    lib = ctypes.CDLL(str(so))
    lib.dl_open.restype = ctypes.c_void_p
    lib.dl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                            ctypes.c_int, ctypes.c_int]
    lib.dl_next.restype = ctypes.c_int
    lib.dl_next.argtypes = [ctypes.c_void_p, _F, ctypes.c_int, _IP, _IP]
    lib.dl_size.restype = ctypes.c_int
    lib.dl_size.argtypes = [ctypes.c_void_p]
    lib.dl_close.restype = None
    lib.dl_close.argtypes = [ctypes.c_void_p]
    lib.dl_decode.restype = ctypes.c_int
    lib.dl_decode.argtypes = [ctypes.c_char_p, _F, ctypes.c_int, _IP, _IP]
    return lib


def build(force: bool = False) -> bool:
    """Build the library (again, with ``force``) and load it. Returns
    whether that succeeded."""
    if force:
        try:
            _compile(_library_path())
        except RuntimeError:
            return False
        library.cache_clear()
    return available()


def available() -> bool:
    """Whether the library builds (g++, libpng, libjpeg) and loads."""
    try:
        library()
        return True
    except (RuntimeError, OSError):
        return False


def _frame(lib_call, buf: np.ndarray) -> Optional[np.ndarray]:
    h, w = ctypes.c_int(), ctypes.c_int()
    n = lib_call(buf.ctypes.data_as(_F), buf.size, ctypes.byref(h),
                 ctypes.byref(w))
    if n <= 0:
        return None
    return buf[:n].reshape(h.value, w.value).copy()


def decode(path: str, max_pixels: int = 8 << 20) -> Optional[np.ndarray]:
    """Decode one image to float32 gray; None where it cannot."""
    lib = library()
    buf = np.empty(max_pixels, np.float32)
    return _frame(lambda *a: lib.dl_decode(str(path).encode(), *a), buf)


class PrefetchLoader:
    """Iterate decoded frames, in order, with native decode-ahead
    workers."""

    def __init__(self, paths: Sequence[str], n_threads: int = 4,
                 capacity: int = 8, max_pixels: int = 8 << 20):
        self._lib = library()
        self._paths = (ctypes.c_char_p * len(paths))(
            *[str(p).encode() for p in paths])
        self._handle = self._lib.dl_open(self._paths, len(paths), n_threads,
                                         capacity)
        self._buf = np.empty(max_pixels, np.float32)
        self._n = len(paths)

    def __len__(self):
        return self._n

    def __iter__(self):
        while True:
            frame = self.next()
            if frame is None:
                return
            yield frame

    def next(self) -> Optional[np.ndarray]:
        return _frame(lambda *a: self._lib.dl_next(self._handle, *a),
                      self._buf)

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.dl_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
