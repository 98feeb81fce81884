"""The port's JPEG codec (host C++, bound with ``ctypes``).

Two builds with one C interface:

* ``libjpeg`` (``jpeg.cpp``): libjpeg on the host's cores, built with
  ``g++ ... -ljpeg`` (the JAX package's decoder and flags);
* ``nvjpeg`` (``nvjpeg.cpp``): nvJPEG from the CUDA toolkit on the card,
  built with ``nvcc ... -lnvjpeg``, for a machine with a card and no
  libjpeg.

``codec()`` is the build for this machine: ``nvjpeg`` where torch sees a
CUDA card, ``libjpeg`` otherwise (``codec(name)`` asks for one). A build
runs at first use into ``ctvae_torch/_build/`` (git-ignored), named by
the hash of its source and flags as ``ops/_build.py`` names the kernels;
a failed build raises with the compiler's output, and a codec never
stands in for the other.

Both decode JPEG files to uint8 RGB ``[n, h, w, 3]`` in host memory (grey
files as three equal channels) and encode such arrays to files at a JPEG
quality (4:2:0 chroma). A file that does not decode raises, naming it.
Crop and resize are the port's ``data/transforms.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..ops._build import BUILD_DIR, _nvcc

CODECS = ("libjpeg", "nvjpeg")
_SRC = {"libjpeg": "jpeg.cpp", "nvjpeg": "nvjpeg.cpp"}
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-march=native")
_LIBS = {"libjpeg": ("-ljpeg", "-lpthread"),
         "nvjpeg": ("-lnvjpeg", "-lpthread")}
_STATUS = {1: "cannot be read", 2: "is no JPEG of the batch's size",
           3: "failed to decode", 4: "cannot be written"}

_lock = threading.Lock()
_codecs: Dict[str, "JpegCodec"] = {}


def default_codec() -> str:
    """``nvjpeg`` where torch sees a CUDA card, else ``libjpeg``."""
    import torch
    return "nvjpeg" if torch.cuda.is_available() else "libjpeg"


def _threads() -> int:
    return max(1, min(8, len(os.sched_getaffinity(0))))


def _command(name: str, src: str, out: str) -> list:
    if name == "nvjpeg":
        return [_nvcc(), "-O3", "-std=c++17", "-shared", "-Xcompiler",
                "-fPIC", src, "-o", out, *_LIBS[name]]
    return ["g++", *GXX_FLAGS, src, "-o", out, *_LIBS[name]]


def _build(name: str) -> Tuple[str, float]:
    """The library of codec ``name``, built if missing; (path, seconds of
    the build, 0 when it was there)."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       _SRC[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(
            _command(name, "", "")[1:]).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libjpeg_{name}-{digest}.so")
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    start = time.perf_counter()
    tmp = f"{path}.{os.getpid()}.tmp"
    log = os.path.join(BUILD_DIR, f"jpeg_{name}.log")
    with open(log, "w") as f:
        rc = subprocess.run(_command(name, src, tmp), stdout=f,
                            stderr=subprocess.STDOUT).returncode
    if rc != 0:
        with open(log) as f:
            raise RuntimeError(f"the {name} JPEG codec did not build "
                               f"(exit {rc}):\n{f.read()}")
    os.replace(tmp, path)
    return path, time.perf_counter() - start


class JpegCodec:
    """One built codec: ``name``, ``version`` (libjpeg's
    ``JPEG_LIB_VERSION`` or nvJPEG's), ``build_s`` (seconds this process
    spent compiling it)."""

    def __init__(self, name: str):
        if name not in CODECS:
            raise ValueError(f"unknown JPEG codec {name!r}; one of {CODECS}")
        path, self.build_s = _build(name)
        lib = ctypes.CDLL(path)
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.ctvae_jpeg_codec.argtypes = []
        lib.ctvae_jpeg_codec.restype = ctypes.c_char_p
        lib.ctvae_jpeg_error.argtypes = []
        lib.ctvae_jpeg_error.restype = ctypes.c_char_p
        lib.ctvae_jpeg_size.argtypes = [ctypes.c_char_p, i32p, i32p]
        lib.ctvae_jpeg_size.restype = ctypes.c_int
        lib.ctvae_decode_jpeg_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.ctvae_decode_jpeg_batch.restype = ctypes.c_int
        lib.ctvae_encode_jpeg_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.ctvae_encode_jpeg_batch.restype = ctypes.c_int
        self.name, self._lib = name, lib
        self.version = lib.ctvae_jpeg_codec().decode()

    def _raise(self, what: str, paths: Sequence[str],
               status: np.ndarray) -> None:
        bad = np.flatnonzero(status)
        listed = "; ".join(f"{paths[i]} {_STATUS.get(int(status[i]), '?')}"
                           for i in bad[:5])
        raise OSError(f"{self.name}: {len(bad)} of {len(paths)} JPEG files "
                      f"failed to {what}: {listed}"
                      f"{' ...' if len(bad) > 5 else ''} (last error: "
                      f"{self._lib.ctvae_jpeg_error().decode()})")

    def size(self, path: str) -> Tuple[int, int]:
        """(height, width) of a JPEG file, from its header."""
        h, w = ctypes.c_int(0), ctypes.c_int(0)
        rc = self._lib.ctvae_jpeg_size(os.fsencode(path), ctypes.byref(h),
                                       ctypes.byref(w))
        if rc:
            self._raise("open", [path], np.array([rc]))
        return h.value, w.value

    def decode_batch(self, paths: Sequence[str],
                     size: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """JPEG files of one size (``size``, else the first file's) ->
        uint8 [n, h, w, 3]; raises naming every file that failed."""
        n = len(paths)
        h, w = size if size is not None else self.size(paths[0])
        out = np.empty((n, h, w, 3), np.uint8)
        status = np.zeros(n, np.int32)
        arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        if self._lib.ctvae_decode_jpeg_batch(
                arr, n, out.ctypes.data, h, w, _threads(),
                status.ctypes.data):
            self._raise("decode", paths, status)
        return out

    def decode(self, path: str) -> np.ndarray:
        """One JPEG file of any size -> uint8 [h, w, 3]."""
        return self.decode_batch([path], self.size(path))[0]

    def encode_batch(self, images: np.ndarray, paths: Sequence[str],
                     quality: int = 80) -> None:
        """uint8 [n, h, w, 3] -> JPEG files at ``quality`` (each written
        to a temporary name, then renamed into place)."""
        images = np.ascontiguousarray(images)
        if images.dtype != np.uint8 or images.ndim != 4 or \
                images.shape[3] != 3 or len(images) != len(paths):
            raise ValueError(f"encode_batch takes uint8 [n, h, w, 3] and n "
                             f"paths, got {images.dtype} {images.shape} and "
                             f"{len(paths)} paths")
        n, h, w, _ = images.shape
        status = np.zeros(n, np.int32)
        arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        if self._lib.ctvae_encode_jpeg_batch(
                images.ctypes.data, n, h, w, arr, int(quality), _threads(),
                status.ctypes.data):
            self._raise("encode", paths, status)


def codec(name: Optional[str] = None) -> JpegCodec:
    """The codec ``name`` (default: ``default_codec()``), built and bound
    once per process."""
    name = name or default_codec()
    with _lock:
        if name not in _codecs:
            _codecs[name] = JpegCodec(name)
        return _codecs[name]


__all__ = ["CODECS", "JpegCodec", "codec", "default_codec"]
