"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` interface and is
compiled into ``build/repro_torch/<name>-<hash>.so`` at the repository root,
keyed by a hash of the source and the flags, then loaded with ``ctypes``.
Nothing is built when a module is imported: the first launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# No --use_fast_math: the Sinkhorn exponents reach +-2e6 at eps = 0.005 and
# the kernels are held to the plain float32 versions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or under {home}; the "
                           "CUDA toolkit is needed to build the kernels")
    return str(path)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
        return lib


def _target(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(names) -> None:
    """Build every named source that is not built yet: one ``nvcc`` each,
    all started together, then wait for all of them."""
    running = []
    try:
        for name in names:
            out = _target(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Build to a private name and rename, so a concurrent process
            # never loads a half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            running.append((name, out, tmp, proc))
        errors = []
        for name, out, tmp, proc in running:
            _, err = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                errors.append(f"nvcc failed to build {CSRC / name}.cu:\n"
                              f"{err}")
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for _, _, tmp, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
