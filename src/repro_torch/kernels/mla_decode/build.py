"""Build the MLA decode kernel with ``nvcc`` at first use and bind its
plain C interface with ``ctypes``.

``csrc/mla_decode.cu`` is compiled for ``sm_90a`` into ``build/`` beside
it (listed in ``.gitignore``), under a name keyed by the hash of the
source and flags, so an edited source is rebuilt and a built one reused.
A build that fails raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import time

from repro_torch.kernels.fhp_step.build import cuda_tool

SOURCE = pathlib.Path(__file__).with_name("csrc") / "mla_decode.cu"
BUILD_DIR = pathlib.Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# What the last build in this process reported: seconds, ptxas output.
BUILD_INFO: dict = {}
_LIB = None


def library_path() -> pathlib.Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmla_decode_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernel unless the current source is already built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t
    if proc.returncode:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(seconds=seconds, ptxas=proc.stderr + proc.stdout,
                      library=str(out))
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call).  ``mla_decode_launch``
    takes eight pointers (q_lat, q_rope, c, kr, pos, out, part_o,
    part_lse), eleven int64 strides, B, H, C, R, T, chunk, n_splits, the
    float scale in log2 units, qtype, cache_kind, pos64 and the stream."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.mla_decode_launch.argtypes = ([vp] * 8 + [ll] * 11 + [i] * 7
                                          + [ctypes.c_float] + [i] * 3
                                          + [vp])
        lib.mla_decode_launch.restype = i
        _LIB = lib
    return _LIB
