"""Build and load the port's CUDA kernels (plain C interface + ctypes).

``load_library()`` compiles ``csrc/*.cu`` with ``nvcc`` for ``sm_90a``
into ``build/kernels/libkfx_flash.so`` at the root of the checkout, at
first CUDA use, and loads it with ``ctypes``. One ``nvcc`` per source
runs in parallel, then one link. The library is rebuilt whenever the
hash of the sources differs from the one it was built from; the build
log (with ``-Xptxas -v`` register/shared-memory reports) lands beside it.
Nothing here runs at import time.

The wgmma kernels' TMA tensor maps are encoded by the CUDA driver API's
``cuTensorMapEncodeTiled``, which ``csrc/hopper.cuh`` fetches at run time
through ``cudaGetDriverEntryPointByVersion`` (``cudaGetDriverEntryPoint``
before CUDA 12.5), so the library links no ``-lcuda``; nor does it need
CUTLASS: the wgmma, TMA and mbarrier pieces are inline PTX.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libkfx_flash.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, k, v, o, lse, B, S, H, D, dtype, stream
    "kfx_flash_fwd": [_P] * 5 + [_I] * 5 + [_P],
    # q, k, v, do, lse, delta, dq, B, S, H, D, dtype, stream
    "kfx_flash_dq": [_P] * 7 + [_I] * 5 + [_P],
    # q, k, v, do, lse, delta, dk, dv, B, S, H, D, dtype, stream
    "kfx_flash_dkv": [_P] * 8 + [_I] * 5 + [_P],
}


def sources():
    return sorted(CSRC.glob("*.cu"))


def sources_hash() -> str:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin): the CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def build(out_dir: Path = BUILD_DIR) -> Path:
    """Compile every source in parallel, link one shared library, and
    return its path. Raises with the compiler's output on failure."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    digest = sources_hash()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src),
                   "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for cmd, obj, proc in procs:
            out, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(" ".join(cmd) + "\n" + out)
        if failed:
            (out_dir / "build.log").write_text("\n".join(log))
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / LIB_NAME
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
               *(str(o) for _, o, _ in procs)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout)
        (out_dir / "build.log").write_text("\n".join(log))
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout)
        lib = out_dir / LIB_NAME
        os.replace(tmp_lib, lib)
    (out_dir / (LIB_NAME + ".sha256")).write_text(digest)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if it is missing or was
    built from other sources."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    fresh = (lib_path.exists() and stamp.exists()
             and stamp.read_text() == sources_hash())
    if not fresh:
        lib_path = build()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kfx_cuda_error_string.argtypes = [ctypes.c_int]
    lib.kfx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def cuda_error_string(code: int) -> str:
    return load_library().kfx_cuda_error_string(code).decode()
