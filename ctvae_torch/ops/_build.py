"""Build and load the CUDA kernels of ``ctvae_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use into ``ctvae_torch/_build/`` (listed in
``.gitignore``); a library is named by the hash of its source, the
headers of ``csrc/`` (``elem.cuh``: the float32 / bfloat16 element
types) and the flags,
so a changed source is rebuilt and an unchanged one is reused. All
missing libraries are compiled in parallel, one ``nvcc`` per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
KERNELS = ("vq", "pairwise", "gat", "gat_logits")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    # the source, the headers of csrc/ it may include, and the flags
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, path), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all() -> float:
    """Compile every kernel library that is missing; returns seconds."""
    start = time.perf_counter()
    with _lock:
        todo = [n for n in KERNELS
                if n not in _libs and not os.path.exists(_lib_path(n))]
        if todo:
            os.makedirs(BUILD_DIR, exist_ok=True)
            nvcc = _nvcc()
            procs = []
            for name in todo:
                dst = _lib_path(name)
                tmp = f"{dst}.{os.getpid()}.tmp"
                log = open(os.path.join(BUILD_DIR, f"{name}.log"), "w")
                cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                       os.path.join(CSRC, f"{name}.cu")]
                procs.append((name, tmp, dst, log,
                              subprocess.Popen(cmd, stdout=log,
                                               stderr=subprocess.STDOUT)))
            failed = []
            for name, tmp, dst, log, proc in procs:
                rc = proc.wait()
                log.close()
                if rc != 0:
                    failed.append(name)
                else:
                    os.replace(tmp, dst)
            if failed:
                logs = "\n".join(build_log(n) for n in failed)
                raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return time.perf_counter() - start


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(_lib_path(name))
                _libs[name] = lib
    return lib


def build_log(name: str) -> str:
    """nvcc's output (with ``ptxas -v``: registers, shared memory and
    spills per kernel) of the last build of ``name``, or ''."""
    path = os.path.join(BUILD_DIR, f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
