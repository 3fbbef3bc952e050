"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` (``denoise_sweep_cluster.cu``: the four sweep
kernels, v1 and v2 with float32 or bfloat16 weights, each in a resident and
a streamed plan; it includes
``sweep_common.cuh``) has a plain C interface. It is compiled with ``nvcc`` for ``sm_90a`` into its own shared library
``build/aid_torch_kernels/lib<name>.so`` at the repository root, on first
use, and rebuilt whenever its source, the shared header or the flags change
(their SHA-256 is kept beside the library). Stale libraries are compiled
together, one ``nvcc`` each, started at once. A library is loaded with
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
from typing import Dict

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
SOURCES = {"denoise_sweep_cluster": CSRC / "denoise_sweep_cluster.cu"}
HEADERS = (CSRC / "sweep_common.cuh",)
BUILD_DIR = _PACKAGE.parent / "build" / "aid_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build_log(name: str) -> Path:
    """nvcc's output for one library, ptxas's register and spill report included."""
    return BUILD_DIR / f"{name}.build.log"


def _nvcc() -> str:
    for candidate in ("/usr/local/cuda/bin/nvcc", "nvcc"):
        found = shutil.which(candidate)
        if found:
            return found
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _digest(name: str) -> str:
    data = SOURCES[name].read_bytes() + b"".join(h.read_bytes() for h in HEADERS)
    return hashlib.sha256(data + " ".join(NVCC_FLAGS).encode()).hexdigest()


def build() -> Dict[str, Path]:
    """Compile every kernel library that is missing or stale, all at once;
    return each library's path."""
    stale = {}
    for name in SOURCES:
        stamp = library_path(name).with_suffix(".so.sha256")
        digest = _digest(name)
        if not (library_path(name).exists() and stamp.exists() and stamp.read_text() == digest):
            stale[name] = digest
    if stale:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            nvcc = _nvcc()
            procs = {
                name: subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o",
                     str(Path(tmp) / library_path(name).name), str(SOURCES[name])],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                for name in stale
            }
            failed = []
            for name, proc in procs.items():
                output, _ = proc.communicate()
                build_log(name).write_text(output)
                if proc.returncode != 0:
                    failed.append(f"{SOURCES[name].name} ({proc.returncode}):\n{output}")
            if failed:
                raise RuntimeError("nvcc failed: " + "\n".join(failed))
            for name, digest in stale.items():
                os.replace(Path(tmp) / library_path(name).name, library_path(name))
                library_path(name).with_suffix(".so.sha256").write_text(digest)
    return {name: library_path(name) for name in SOURCES}


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built kernel library ``name`` (a key of ``SOURCES``) with its C
    signatures declared."""
    lib = ctypes.CDLL(str(build()[name]))
    p, i = ctypes.c_void_p, ctypes.c_int
    # z0, obs_emb, t_embs, coeffs, kernel weights, pieces, seed, out, arena,
    # B D H Hr L K P, output_multiplier (a device float), stochastic, streamed, smem, stream
    sweep = [p] * 9 + [i] * 7 + [p, i, i, ctypes.c_size_t, p]
    signatures = {
        "aid_denoise_sweep": sweep,
        "aid_denoise_sweep_v2": sweep,
        "aid_denoise_sweep_bf16": sweep,
        "aid_denoise_sweep_v2_bf16": sweep,
        # variant, bf16, streamed, smem, count
        "aid_sweep_max_clusters": [i, i, i, ctypes.c_size_t, p],
        "aid_sweep_cluster_size": [],
    }
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.aid_sweep_arena_bytes.argtypes = [i, i, i]  # bf16, latent, kernel's hidden
    lib.aid_sweep_arena_bytes.restype = ctypes.c_longlong
    lib.aid_cuda_error_string.argtypes = [ctypes.c_int]
    lib.aid_cuda_error_string.restype = ctypes.c_char_p
    return lib
