"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` is compiled on first use into its own shared library
with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

under `multi_modal_tracking_torch/_build/` (listed in .gitignore). The file
name carries a hash of the source, of every header under `csrc/` (`*.cuh`,
`*.h`, by name) and of the flags, so an edited source or shared header is
rebuilt and a stale library is never loaded. All missing libraries are
compiled by concurrent nvcc processes. The compiler's output (ptxas
register and shared-memory report) is kept beside each library as
`lib<name>-<hash>.log`. The host C++ libraries (`csrc/host/*.cpp`, the
training data pipeline's pixel work) are compiled the same way with g++
(`build_host`).

Nothing here runs at import time: the CPU tests import every module and
have no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_C = ctypes.c_void_p
_I = ctypes.c_int
#: C signature of every exported function: (argtypes, restype)
SIGNATURES = {
    "mixed_attention": {
        "mixed_attention_fwd_f32": ([_C] * 5 + [_I] * 5 + [ctypes.c_float, _I, _C], _I),
    },
    "mixed_attention_bf16": {
        "mixed_attention_fwd_bf16": ([_C] * 5 + [_I] * 5 + [ctypes.c_float, _I, _C], _I),
    },
    "mixed_attention_bwd": {
        "mixed_attention_bwd_f32": ([_C] * 10 + [_I, _I, _I, _I, _I, ctypes.c_float, _C],
                                    _I),
    },
    "mixed_attention_bwd_bf16": {
        "mixed_attention_bwd_bf16": ([_C] * 9 + [_I] * 5 + [ctypes.c_float, _C], _I),
    },
    "msda": {
        "msda_fwd_f32": ([_C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _I,
                          ctypes.POINTER(_I), _I, _C], _I),
        "msda_fwd_bf16": ([_C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _I,
                           ctypes.POINTER(_I), _I, _C], _I),
        "msda_launch_floor_f32": ([_I, _I, _I, _C], _I),
    },
    "adamw": {
        "adamw_f32": ([_C] * 5 + [_I, _I, _C, _C] + [ctypes.c_float] * 6 + [_C], _I),
    },
    "msda_bwd": {
        "msda_bwd_f32": ([_C] * 7 + [_I] * 7 + [ctypes.POINTER(_I), _I, _C], _I),
        "msda_bwd_bf16": ([_C] * 8 + [_I] * 7 + [ctypes.POINTER(_I), _I, _C], _I),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of multi_modal_tracking_torch "
                       "are built on the machine with the GPU (PATH or CUDA_HOME)")


def _headers() -> List[str]:
    return sorted(f for f in os.listdir(CSRC_DIR) if f.endswith((".cuh", ".h")))


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for fname in [f"{name}.cu", *_headers()]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _load(name: str, path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def build(names: List[str] | None = None) -> Dict[str, str]:
    """Compile every missing kernel library (concurrently) and load them all.
    Returns {name: compiler log}; a log is empty for a library that was
    already built."""
    names = list(SIGNATURES) if names is None else names
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs, logs = {}, {}
        for name in names:
            path = _lib_path(name)
            if name in _libs or os.path.isfile(path):
                logs[name] = ""
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            logs[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}:\n{out}")
                continue
            with open(path[:-3] + ".log", "w") as f:
                f.write(out)
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name in names:
            if name not in _libs:
                _libs[name] = _load(name, _lib_path(name))
        return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name]
    return lib


#: host C++ libraries (csrc/host/<name>.cpp): no -ffast-math, no
#: -march=native and no contraction to FMA, each of which changes float32 bits
HOST_DIR = os.path.join(CSRC_DIR, "host")
HOST_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared", "-pthread", "-ffp-contract=off"]


def host_library_path(src: str, build_dir: str = BUILD_DIR) -> str:
    """`<build_dir>/lib<name>-<hash>.so` of the C++ source `src`: the hash
    covers the source, every header beside it and the flags."""
    h = hashlib.sha256()
    folder = os.path.dirname(os.path.abspath(src))
    headers = sorted(f for f in os.listdir(folder) if f.endswith((".h", ".hpp")))
    for path in [src, *(os.path.join(folder, f) for f in headers)]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(HOST_FLAGS).encode())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(build_dir, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_host(src: str, build_dir: str = BUILD_DIR) -> str:
    """Compile the C++ source `src` with g++ into `host_library_path` unless
    it is there; returns the path. Concurrent processes each compile into a
    file of their own and rename it into place, so a reader never sees a
    partial library. Raises RuntimeError with the compiler's output."""
    path = host_library_path(src, build_dir)
    if os.path.isfile(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    try:
        proc = subprocess.run([cxx, *HOST_FLAGS, "-o", tmp, src], capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{cxx} could not run to build {src}: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{cxx} failed for {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


#: codes the bf16 attention entry points return beyond cudaError_t's
#: (csrc/wgmma_bf16.cuh hopper_host::ERR_*)
ERR_NO_ENCODER, ERR_ENCODE = 10000, 10001


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA or tensor-map
    error."""
    if err == ERR_NO_ENCODER:
        raise RuntimeError(f"{what}: the CUDA driver has no cuTensorMapEncodeTiled")
    if err > ERR_NO_ENCODER:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed, CUresult {err - ERR_ENCODE}")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
