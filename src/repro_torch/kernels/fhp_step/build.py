"""Build the CUDA kernel with ``nvcc`` at first use and bind its plain C
interface with ``ctypes``.

The shared library is compiled from the sources in ``csrc/`` for
``sm_90a`` into ``build/`` beside them (listed in ``.gitignore``), under a
name keyed by the hash of the sources and flags, so an edited source is
rebuilt and a built one is reused.  A build that fails raises; nothing
falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).with_name("build")
SOURCES = ("fhp_step.cu", "fhp_step.cuh", "rules_gen.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# What the last build in this process reported: seconds, ptxas output.
BUILD_INFO: dict = {}
_LIB = None


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    found = shutil.which(name)
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin") / name
    if default.exists():
        return str(default)
    raise RuntimeError(f"{name} not found: the CUDA kernel is built on a "
                       "machine with the CUDA toolkit")


def library_path() -> pathlib.Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libfhp_step_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernel unless the current sources are already built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / "fhp_step.cu")]
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


def launch_argtypes() -> list:
    """ctypes argument types of ``fhp_step_launch`` less its stream (the
    arguments of ``csrc/host_emulate.cpp``'s ``fhp_step_host``): six
    pointers (in, out, solid, chi, acc, moments), rule, mode, B, H, Wd, bh,
    bw, T, the unsigned t0, then y0, xw0, hg, wdg, r0, r1, c0, c1, pq and
    record_mask."""
    vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    return [vp] * 6 + [i] * 8 + [u] + [i] * 10


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.fhp_step_launch.argtypes = launch_argtypes() + [ctypes.c_void_p]
        lib.fhp_step_launch.restype = ctypes.c_int
        lib.fhp_step_info.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.fhp_step_info.restype = ctypes.c_int
        _LIB = lib
    return _LIB


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_KERNEL_NAME = re.compile(r"fhp_step_kernelI\d+(\w+?)Lb([01])ELi(\d)E")
_STREAM_NAME = re.compile(r"fhp_step_stream_kernelI\d+(\w+?)Li(\d)E")
_MODE_NAMES = ("periodic", "extended", "precomputed_rng")


def _kernel_name(mangled: str) -> str:
    k = _KERNEL_NAME.search(mangled)
    if k:
        return (f"{k.group(1).replace('Rule_', '')}"
                f"{' static' if k.group(2) == '1' else ''} "
                f"{_MODE_NAMES[int(k.group(3))]}")
    k = _STREAM_NAME.search(mangled)
    if k:
        return f"{k.group(1).replace('Rule_', '')} streamed J={k.group(2)}"
    return mangled


def ptxas_report(text: str) -> list:
    """Registers and spill bytes of each kernel instantiation in ``nvcc
    -Xptxas -v`` output: dicts of ``kernel`` (rule, static solid, mode; or
    rule, ``streamed`` and the chunks a warp J), ``registers``,
    ``spill_stores`` and ``spill_loads``, in build order."""
    out, cur = [], None
    for line in text.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            cur = {"kernel": _kernel_name(m.group(1))}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = _PTXAS_USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return out
