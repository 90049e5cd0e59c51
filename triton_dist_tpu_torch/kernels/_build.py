"""Build, load and count the hand-written CUDA kernels.

The port's counterpart of the launch wrapper in triton_dist_tpu.lang.core
(`tpu_call` plus its `pallas_call_count`): each kernel is a `.cu` file
under `csrc/` with a plain C entry point. At first use it is compiled
with nvcc for sm_90a into `csrc/build/` (git-ignored), named by a hash
of its source and of every shared header (`csrc/*.cuh`) so an edited
source or header is rebuilt, and loaded with ctypes.
Nothing is compiled when a module is imported: the CPU tests import
every module, and the CPU path never needs nvcc.

Each wrapper counts its own launches (`wrapper.launches`, incremented
where the kernel is launched and nowhere else), so a run can prove the
main path went through the kernel and was not swapped for its plain
version. Under a CUDA-graph capture (runtime/graphs.py) a launch is
recorded into the graph rather than run: the capture keeps its own
count, and every replay of the graph adds it to the wrappers' counts,
so a count is the kernel's launches on the card, eager or replayed.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Tuple

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


class Capture:
    """What a CUDA-graph capture recorded (runtime/graphs.py): the
    kernels' launches by name, the by-body counters' increments
    ((counter, key) pairs, `count_body`) and the pool entries handed out
    (kept alive as long as the graph)."""

    def __init__(self):
        self.launches: Dict[str, int] = {}
        self.bodies: List[tuple] = []
        self.held: list = []

    def replayed(self) -> None:
        """Count one replay: every recorded launch, on the card now."""
        for name, k in self.launches.items():
            KERNELS[name].launches += k
        for counter, key in self.bodies:
            counter[key] += 1


# the captures under way, the innermost last
_captures: List[Capture] = []


def count_launch(name: str) -> None:
    """Add one launch to the registered wrapper `name`; called by the
    launcher right after its kernel was queued, and nowhere else. Under a
    capture the launch goes to the capture's count instead (the graph's
    replays add it)."""
    if _captures:
        got = _captures[-1].launches
        got[name] = got.get(name, 0) + 1
    else:
        KERNELS[name].launches += 1


def count_body(counter: Dict[str, int], key: str) -> None:
    """Add one launch to a module's by-body counter (`launches_by_body`),
    or, under a capture, to what each replay adds."""
    if _captures:
        _captures[-1].bodies.append((counter, key))
    else:
        counter[key] += 1


@contextlib.contextmanager
def capturing():
    """Within the block the kernels' launches are recorded into a graph:
    yields the Capture, which the graph keeps."""
    cap = Capture()
    _captures.append(cap)
    try:
        yield cap
    finally:
        _captures.pop()


def under_capture() -> bool:
    """Whether a CUDA-graph capture is recording the launches now."""
    return bool(_captures)


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
    """csrc/build/lib<name>-<hash>.so, the hash taken over <name>.cu and
    every csrc/*.cuh: a kernel may include any shared header, so an
    edited header must rebuild every library rather than load a stale
    one."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read() + b"\0")
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


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
    """Compile the named kernels, one nvcc each, all started together; a
    name given twice is built once (two compilers would write one
    temporary file). Raises with the compiler's output when one fails.
    Returns the library paths."""
    names = list(dict.fromkeys(names))
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


class GridInfo(ctypes.Structure):
    """What a virtual-world launch (csrc/shmem.cuh launch_world) reports
    back: the resident blocks per SM, the SMs, and the blocks per rank it
    launched."""

    _fields_ = [("per_sm", ctypes.c_int), ("sms", ctypes.c_int),
                ("per_rank", ctypes.c_int)]

    def ptr(self) -> int:
        return ctypes.addressof(self)


def check(kernel: str, err: int, error_string, grid: GridInfo = None) -> None:
    """Raise when a launcher returned a CUDA error (a refused launch never
    runs, and no synchronisation would report it); a virtual-world
    launch names the grid it tried to fit."""
    if err == 0:
        return
    msg = f"{kernel} launch failed: {error_string(err).decode()}"
    if grid is not None:
        msg += (f" (n ranks need co-resident blocks: {grid.per_sm} blocks "
                f"per SM x {grid.sms} SMs gave {grid.per_rank} per rank)")
    raise RuntimeError(msg)


def ptxas_summary(name: str, kernel: str) -> Dict[str, str]:
    """From the last build of csrc/<name>.cu in this process (empty when
    it was loaded ready-built): each entry function whose mangled name
    holds `kernel`, by its mangled template arguments, -> "<registers>
    registers, <spill stores> / <spill loads> bytes spilled", as ptxas
    -v printed them."""
    out, cur, spill = {}, None, ""
    for line in build_log.get(name, "").splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            cur = (fn.split(kernel, 1)[1].split("EEv")[0] if kernel in fn
                   else None)
        elif cur is not None and "spill stores" in line:
            parts = line.replace(",", "").split()
            spill = f"{parts[parts.index('spill') - 2]} / " \
                    f"{parts[parts.index('loads') - 3]}"
        elif cur is not None and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split()[0]
            out[cur] = f"{regs} registers, {spill} bytes spilled"
            cur, spill = None, ""
    return out


# the H100's SMs: the launch plans' default (card_sms on the card)
SMS = 132
# a PoolCache's entries by default: past this many the least recently
# used is evicted
POOL_ENTRIES = 8


class PoolCache:
    """A kernel's persistent buffers: an entry a call configuration (slots,
    uninitialised, and flag or counter pools, zeroed once when made; the
    kernels leave them at zero). At most `size` entries, the least
    recently used evicted first; an evicted buffer goes back to the
    caching allocator, which orders its reuse by the stream it was made
    on, unless a CUDA graph captured with it still holds it (`capturing`:
    the graph writes to the buffer at every replay). `made` counts the
    entries made."""

    def __init__(self, size: int = POOL_ENTRIES):
        self.size = size
        self.entries: "collections.OrderedDict" = collections.OrderedDict()
        self.made = 0

    def get(self, key, make):
        entry = self.entries.get(key)
        if entry is None:
            entry = make()
            self.made += 1
        self.entries[key] = entry
        self.entries.move_to_end(key)
        for cap in _captures:
            cap.held.append(entry)
        while len(self.entries) > self.size:
            self.entries.popitem(last=False)
        return entry


@functools.lru_cache(maxsize=None)
def card_sms(device) -> int:
    """The SMs of a CUDA device (the launch plans' residency)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def raw_stream(device) -> int:
    """The current stream of a CUDA device as its raw handle, what a C
    entry takes: a `torch.cuda.Stream` object costs microseconds a call,
    the handle does not."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def on_device(device):
    """A device guard for a launch on `device`, entered only where it is
    not the current device (entering one costs microseconds a call)."""
    import torch

    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def straggler_args(straggler, n: int) -> Tuple[int, int]:
    """A launch's (rank, nanos) of a `straggler=(rank, nanos)` option:
    (-1, 0) for None; raises on a rank outside the world of n or a
    negative delay."""
    if straggler is None:
        return -1, 0
    rank, nanos = straggler
    if not (0 <= rank < n and nanos >= 0):
        raise ValueError(f"straggler {straggler}: (rank in [0, {n}), "
                         "nanos >= 0)")
    return rank, nanos


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
