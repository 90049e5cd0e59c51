"""Build, load and count the hand-written CUDA kernels.

The port's counterpart of the launch wrapper in triton_dist_tpu.lang.core
(`tpu_call` plus its `pallas_call_count`): each kernel is a `.cu` file
under `csrc/` with a plain C entry point. At first use it is compiled
with nvcc for sm_90a into `csrc/build/` (git-ignored), named by a hash
of its source so an edited source is rebuilt, and loaded with ctypes.
Nothing is compiled when a module is imported: the CPU tests import
every module, and the CPU path never needs nvcc.

Each wrapper counts its own launches (`wrapper.launches`, incremented
where the kernel is launched and nowhere else), so a run can prove the
main path went through the kernel and was not swapped for its plain
version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> wrapper function carrying `.launches`; filled by @counted
KERNELS: Dict[str, object] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# ptxas register/spill report of the last build, per kernel
build_log: Dict[str, str] = {}


def counted(name: str):
    """Register a kernel wrapper under `name` and give it a launch count."""
    def deco(fn):
        fn.launches = 0
        fn.kernel_name = name
        KERNELS[name] = fn
        return fn
    return deco


def count_launch(name: str) -> None:
    """Add one launch to the registered wrapper `name`; called by the
    launcher right after its kernel was queued, and nowhere else."""
    KERNELS[name].launches += 1


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start_build(name: str):
    """Start nvcc for csrc/<name>.cu unless the library is built already.
    Returns (process, tmp_path, final_path) or None."""
    path = _lib_path(name)
    if os.path.exists(path):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, path


def build(names: Iterable[str]) -> List[str]:
    """Compile the named kernels, one nvcc each, all started together.
    Raises with the compiler's output when one fails. Returns the
    library paths."""
    names = list(names)
    started = {n: _start_build(n) for n in names}
    errors = []
    for n, job in started.items():
        if job is None:
            continue
        proc, tmp, path = job
        out, _ = proc.communicate()
        build_log[n] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
            continue
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [_lib_path(n) for n in names]


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use.
    signatures: C function -> (restype, [argtypes]); every pointer and
    the stream must be ctypes.c_void_p, or ctypes truncates them."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            (path,) = build([name])
            lib = ctypes.CDLL(path)
            for fn, (restype, argtypes) in signatures.items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = list(argtypes)
            _libs[name] = lib
    return lib
