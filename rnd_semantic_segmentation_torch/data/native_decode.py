"""The libjpeg/libpng decoder of ``native/segdata.cpp`` through ctypes
(counterpart of the JAX package's data/native_loader.py), for
DATA_PIPE.NATIVE_DECODE.

The source is the repo's, unedited, built with the JAX package's command
(``g++ -O3 -shared -fPIC ... -ljpeg -lpng -lpthread``) into
``rnd_semantic_segmentation_torch/build/segdata/``, which git ignores, so
that the two packages never race on ``native/build/``; it is built again
when the source is newer than the library.  The build runs under a file
lock and renames its output into place, so concurrent processes (ranks,
loader workers) build it once.

Unlike the JAX package, nothing falls back quietly: when the library cannot
be built or loaded, ``load_library`` raises with the compiler's or the
loader's message.  A single file that the library cannot decode (it returns
0) is decoded by PIL, as in the JAX package, and counted by the caller.

``decode`` returns a file's pixels as uint8 HWC (RGB for colour images,
[H,W,3] with the grey channel repeated for grey ones, as ``_open_rgb`` needs
them); it copies out of a per-thread buffer of ``DECODE_BUFFER_BYTES``.
``load_batch``, ``save_palette_png`` and ``save_palette_png_batch`` bind the
library's batch decoder and palette writers.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO_ROOT, "native", "segdata.cpp")
BUILD_DIR = os.path.join(_REPO_ROOT, "rnd_semantic_segmentation_torch", "build", "segdata")
LIBRARY = os.path.join(BUILD_DIR, "libsegdata.so")
CXX = "g++"
DECODE_BUFFER_BYTES = 64 * 1024 * 1024  # one 4096x4096 RGBA image, as the JAX package's

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tls = threading.local()

_u8p = ctypes.POINTER(ctypes.c_ubyte)
_f32p = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "segdata_decode": (ctypes.c_int, [
        ctypes.c_char_p, _u8p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]),
    "segdata_load_batch": (ctypes.c_int, [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _f32p, _f32p, ctypes.c_float, ctypes.c_int, _f32p, _u8p]),
    "segdata_save_palette_png": (ctypes.c_int, [
        ctypes.c_char_p, _u8p, ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_int]),
    "segdata_save_palette_png_batch": (ctypes.c_int, [
        ctypes.POINTER(ctypes.c_char_p), _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _u8p, ctypes.c_int, ctypes.c_int, _u8p]),
}


def build_library(library: Optional[str] = None, source: Optional[str] = None,
                  cxx: Optional[str] = None) -> str:
    """Compiles ``source`` into ``library`` (``SOURCE``, ``LIBRARY`` and the
    compiler ``CXX`` by default) unless it is there and newer than the
    source; raises ``RuntimeError`` with the compiler's message."""
    library, source, cxx = library or LIBRARY, source or SOURCE, cxx or CXX
    os.makedirs(os.path.dirname(library), exist_ok=True)
    with open(library + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(library) and os.path.getmtime(library) >= os.path.getmtime(source):
            return library
        tmp = f"{library}.{os.getpid()}.tmp"
        cmd = [cxx, "-O3", "-shared", "-fPIC", source, "-o", tmp,
               "-ljpeg", "-lpng", "-lpthread"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as err:
            raise RuntimeError(f"DATA_PIPE.NATIVE_DECODE: cannot run {cxx!r} to build "
                               f"{source}: {err}") from err
        if proc.returncode != 0:
            raise RuntimeError(f"DATA_PIPE.NATIVE_DECODE: {' '.join(cmd)} failed "
                               f"(exit {proc.returncode}):\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, library)
    return library


def load_library() -> ctypes.CDLL:
    """The decoder, built first if needed; raises when it cannot be built or
    loaded."""
    global _lib
    with _lock:
        if _lib is None:
            path = build_library()
            try:
                lib = ctypes.CDLL(path)
            except OSError as err:
                raise RuntimeError(f"DATA_PIPE.NATIVE_DECODE: cannot load {path}: "
                                   f"{err}") from err
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def decode(path: str) -> Optional[np.ndarray]:
    """The file's pixels as uint8 [H,W,3] (a grey image's channel repeated),
    or None when the library cannot decode it."""
    lib = load_library()
    buf = getattr(_tls, "buf", None)
    if buf is None:
        buf = _tls.buf = np.empty(DECODE_BUFFER_BYTES, np.uint8)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    ok = lib.segdata_decode(path.encode(), buf.ctypes.data_as(_u8p), buf.nbytes,
                            ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    if not ok:
        return None
    arr = buf[:h.value * w.value * c.value].reshape(h.value, w.value, c.value)
    if c.value == 1:
        return np.repeat(arr, 3, axis=-1)
    return arr.copy()


def load_batch(paths: Sequence[str], size: Tuple[int, int],
               mean: Sequence[float] = (0.485, 0.456, 0.406),
               std: Sequence[float] = (0.229, 0.224, 0.225),
               scale: float = 1.0 / 255.0,
               num_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Decode, bilinear resize to ``size`` (H, W) and normalise each file on
    ``num_threads`` threads: ``(images [N,H,W,3] float32, ok [N] bool)``; a
    file that fails is zeros with ok False."""
    lib = load_library()
    h, w, n = int(size[0]), int(size[1]), len(paths)
    out = np.zeros((n, h, w, 3), np.float32)
    okv = np.zeros((n,), np.uint8)
    names = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    mean_a = (ctypes.c_float * 3)(*[float(m) for m in mean])
    std_a = (ctypes.c_float * 3)(*[float(s) for s in std])
    lib.segdata_load_batch(names, n, h, w, mean_a, std_a, ctypes.c_float(scale),
                           int(num_threads), out.ctypes.data_as(_f32p),
                           okv.ctypes.data_as(_u8p))
    return out, okv.astype(bool)


def _palette(palette: Sequence[int]) -> np.ndarray:
    pal = np.zeros(768, np.uint8)
    flat = np.asarray(list(palette), np.uint8).ravel()[:768]
    pal[:len(flat)] = flat
    return pal


def save_palette_png(path: str, pred: np.ndarray, palette: Sequence[int]) -> bool:
    """One [H,W] uint8 class-id map as a P-mode PNG; True when written."""
    lib = load_library()
    pred = np.ascontiguousarray(pred, np.uint8)
    pal = _palette(palette)
    h, w = pred.shape
    return bool(lib.segdata_save_palette_png(path.encode(), pred.ctypes.data_as(_u8p), h, w,
                                             pal.ctypes.data_as(_u8p), 256))


def save_palette_png_batch(paths: Sequence[str], preds: np.ndarray,
                           palette: Sequence[int], num_threads: int = 8) -> np.ndarray:
    """[N,H,W] uint8 maps as P-mode PNGs on ``num_threads`` threads; ok [N]."""
    lib = load_library()
    n = len(paths)
    okv = np.zeros((n,), np.uint8)
    if n == 0:
        return okv.astype(bool)
    preds = np.ascontiguousarray(preds, np.uint8)
    pal = _palette(palette)
    names = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.segdata_save_palette_png_batch(names, preds.ctypes.data_as(_u8p), n, preds.shape[1],
                                       preds.shape[2], pal.ctypes.data_as(_u8p), 256,
                                       int(num_threads), okv.ctypes.data_as(_u8p))
    return okv.astype(bool)
