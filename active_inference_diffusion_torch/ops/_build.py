"""Build and load the port's CUDA kernels.

``csrc/denoise_sweep.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``build/aid_torch_kernels/libdenoise_sweep.so``
at the repository root, on first use, and rebuilt whenever the source or the
flags change (their SHA-256 is kept beside the library). It is loaded with
``ctypes``; every pointer and the stream are passed as ``c_void_p``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[1]
SOURCE = _PACKAGE / "csrc" / "denoise_sweep.cu"
BUILD_DIR = _PACKAGE.parent / "build" / "aid_torch_kernels"
LIBRARY = BUILD_DIR / "libdenoise_sweep.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    for candidate in ("/usr/local/cuda/bin/nvcc", "nvcc"):
        found = shutil.which(candidate)
        if found:
            return found
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def build() -> Path:
    """Compile the kernel library unless an up-to-date one exists."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    stamp = LIBRARY.with_suffix(".so.sha256")
    if LIBRARY.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        target = Path(tmp) / LIBRARY.name
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(target), str(SOURCE)],
            capture_output=True, text=True,
        )
        (BUILD_DIR / "build.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(target, LIBRARY)
    stamp.write_text(digest)
    return LIBRARY


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from .denoise import _TrunkOffsets

    lib = ctypes.CDLL(str(build()))
    p = ctypes.c_void_p
    lib.aid_denoise_sweep.argtypes = [
        p, p, p, p,  # z0, obs_emb, t_embs, coeffs
        p, _TrunkOffsets, p, p,  # weight buffer, offsets, seed, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B D H L K
        ctypes.c_float, ctypes.c_int, ctypes.c_size_t, p,  # mult, stochastic, smem, stream
    ]
    lib.aid_denoise_sweep.restype = ctypes.c_int
    lib.aid_cuda_error_string.argtypes = [ctypes.c_int]
    lib.aid_cuda_error_string.restype = ctypes.c_char_p
    return lib
