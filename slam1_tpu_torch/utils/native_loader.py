"""ctypes bindings for the native threaded frame prefetcher
(`native/dataloader.cpp`, shared with the JAX package and unchanged):
background threads decode 8-bit grayscale PNG, RGB/RGBA PNG and binary
P5 PGM into zero-padded float32 canvases.

The library is built with g++ on first use into the port's git-ignored
`build/` directory, under a name carrying the source's hash; the build
writes a temporary file and renames it into place, so processes that
build at the same time never load a half-written library.
`build_library` returns None where no g++ or zlib is present.

The frames come back on the scale `utils/kitti.load_image` gives:
8-bit levels over 255 (the native code multiplies by 1/255, which is 1
ulp off the division on about half of the levels; the levels are read
back and divided, so both loaders give the same floats).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import List, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "dataloader.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
_FLAGS = ("-O3", "-shared", "-fPIC")
_LIBS = ("-lz", "-lpthread")
_build_lock = threading.Lock()
_lib = None


def library_path() -> Optional[str]:
    """Where the library built from the current source lives (None when
    the source is missing)."""
    if not os.path.exists(_SRC):
        return None
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS + _LIBS).encode())
    return os.path.join(BUILD_DIR, f"libslamloader_{h.hexdigest()[:16]}.so")


def build_library(force: bool = False) -> Optional[str]:
    """Compile the loader library where needed. Returns its path, or None
    when there is no source, no g++ or no zlib."""
    with _build_lock:
        path = library_path()
        if path is None:
            return None
        if os.path.exists(path) and not force:
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = ["g++", *_FLAGS, _SRC, "-o", tmp, *_LIBS]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, FileNotFoundError):
            os.unlink(tmp)
            return None
        os.replace(tmp, path)
        return path


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    path = build_library()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float)]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _gray_levels(buf: np.ndarray) -> np.ndarray:
    """The native canvas on load_image's scale: 8-bit levels over 255."""
    return np.rint(buf * 255.0).astype(np.float32) / 255.0


class NativeFrameLoader:
    """Iterates decoded, canvas-padded float32 frames with background
    decode threads. Raises RuntimeError if the native library can't
    build, IOError on a frame that does not decode."""

    def __init__(self, paths: List[str], canvas_h: int, canvas_w: int,
                 ring: int = 8, threads: int = 2):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native loader unavailable (no g++/zlib?)")
        self.h, self.w = canvas_h, canvas_w
        self.n = len(paths)
        arr = (ctypes.c_char_p * self.n)(*[p.encode() for p in paths])
        self._paths_keepalive = arr
        self._h = self._lib.loader_create(arr, self.n, canvas_h, canvas_w,
                                          ring, threads)
        self._buf = np.empty((canvas_h, canvas_w), np.float32)
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._closed:
            raise StopIteration
        idx = self._lib.loader_next(
            self._h, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if idx == -1:
            self.close()
            raise StopIteration
        if idx == -2:
            raise IOError("native loader: frame decode failed")
        return _gray_levels(self._buf)

    def close(self):
        if not self._closed and self._h:
            self._lib.loader_destroy(self._h)
            self._closed = True

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def stereo_frames(left_paths, right_paths, canvas_h, canvas_w,
                  ring: int = 8, threads: int = 2):
    """Yield (left, right) canvas pairs via two native prefetchers."""
    lt = NativeFrameLoader(left_paths, canvas_h, canvas_w, ring, threads)
    rt = NativeFrameLoader(right_paths, canvas_h, canvas_w, ring, threads)
    try:
        for l, r in zip(lt, rt):
            yield l, r
    finally:
        lt.close()
        rt.close()


def image_size(path: str):
    """(height, width) from a PNG's IHDR chunk or a P5 PGM's header."""
    with open(path, "rb") as f:
        head = f.read(64)
    if head[:8] == b"\x89PNG\r\n\x1a\n":
        return (int.from_bytes(head[20:24], "big"),
                int.from_bytes(head[16:20], "big"))
    if head[:2] == b"P5":
        tokens = []
        for line in head[2:].split(b"\n"):
            tokens += line.split(b"#")[0].split()
            if len(tokens) >= 2:
                return int(tokens[1]), int(tokens[0])
    raise IOError(f"{path}: neither a PNG nor a P5 PGM")


def decode_gray(path: str) -> np.ndarray:
    """One image decoded natively: (H,W) float32 8-bit levels over 255.
    Raises RuntimeError when the library is unavailable."""
    h, w = image_size(path)
    loader = NativeFrameLoader([path], h, w, ring=1, threads=1)
    try:
        return next(loader)
    finally:
        loader.close()
