"""The low-latency AllGather's, p2p_send's and the full-mesh
AllGather's times at their paths' shapes, with ring_shift as the
control.

    python -m triton_dist_tpu_torch.tools.profile_p2p_ll

World 4, payloads from chip_smoke.py's `rand`. Rows (PERF.md §6):
  row 9, ll_all_gather (csrc/low_latency_allgather.cu ll_ag_kernel), one
      context a case, calls going on from 0: the SP decode exchange
      (4, 4224) f32 a rank, and phase 4w's (4, 4096) bf16 a rank, native
      and on the fp8, int8 and int8 block 128 wires (their images
      through the same kernel);
  row 14, p2p_send (csrc/p2p.cu p2p_kernel): the PP handoff (512, 4096)
      bf16 a rank, stage 3 -> 0;
  row 8b, full_mesh_all_gather (csrc/allgather.cu fm_ag_kernel) on
      (128, 4096) bf16 a rank, phase 4c's Auto route;
  row 15, ring_shift (ring_shift_kernel) at the PP handoff, shift 1: the
      control.
Each case is first called 20 times on one stream, each result held
bitwise against its plain version (an LL context's slots and parity
flags against a plain twin's); then its call ms (CUDA events), device µs
a call (torch.profiler, chip_smoke.device_us), the wrapper's host µs a
call (time.perf_counter around 100 unsynchronised calls), the caching
allocator's allocations a warm call, the bound (each input read once,
each output written once) and the library's one call (ms and device µs:
a yardstick the port never calls). Rows 9 and 14 also give the
protocol's floor: the same kernel and grid on a 16-byte payload a rank
(row 8b: its wrapper's grid for 16 bytes). Where the package has the
redesigned wrappers also: the host µs by part (ll_host_parts,
p2p_host_parts, fm_host_parts, through chip_smoke.host_parts), the pools
a warm call made, the device µs and floor at each body forced
(register and bulk copy) of row 14, at 4 KiB to 1 MiB a rank
(P2P_SWEEP), and row 8b's device µs at phase 4c's bf16 payloads
(FM_SWEEP).
Prints one JSON line a row and one at the end.
chip_smoke.py is loaded from this file's checkout and the kernels
from whichever `triton_dist_tpu_torch` is imported first, so two
versions compare in one run by pointing PYTHONPATH at each checkout in
turn and running this file by its path (old, new, new, old). Needs a
CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import time

import torch

import triton_dist_tpu_torch
from triton_dist_tpu_torch import kernels, wire
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import allgather as ag
from triton_dist_tpu_torch.kernels import low_latency_allgather as llag
from triton_dist_tpu_torch.kernels import p2p
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld

N = 4
LL_CASES = (("SP decode", (4, 4224), torch.float32, None),
            ("4w native", (4, 4096), torch.bfloat16, None),
            ("4w fp8", (4, 4096), torch.bfloat16, ("fp8", None)),
            ("4w int8", (4, 4096), torch.bfloat16, ("int8", None)),
            ("4w int8 block 128", (4, 4096), torch.bfloat16, ("int8", 128)))
PP_SHAPE, PP_SRC, PP_DST = (512, 4096), N - 1, 0
# bytes a rank of the body sweep (bf16 rows)
P2P_SWEEP = (4 << 10, 32 << 10, 256 << 10, 1 << 20)
FM_SHAPE = (128, 4096)
# phase 4c's bf16 payloads a rank: 32 KiB, 1 MiB, 4 MiB
FM_SWEEP = ((4, 4096), (128, 4096), (512, 4096))
CHECK_CALLS = 20


def _chip_smoke():
    """chip_smoke.py of this file's checkout (its timing helpers)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host_us(fn, calls=100):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return dt


def _allocs(fn, calls=10):
    """The caching allocator's allocations a warm call of fn."""
    fn()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (torch.cuda.memory_stats()["allocation.all.allocated"]
            - before) / calls


def _timed(cs, fn, key, library, nbytes):
    bound, by = cs.bound_ms(0, nbytes, "bfloat16")
    return dict(ms=cs.time_ms(fn), device_us=cs.device_us(fn, key),
                host_us=_host_us(fn), allocs_per_call=_allocs(fn),
                bound_us=bound * 1e3, bound_by=by,
                library_ms=cs.time_ms(library),
                library_us=cs.device_us_total(library))


class Context:
    """An LL context and its next call index: every call on it, the
    wrapper's or a forced launch, takes the next index."""

    def __init__(self, shape, dtype, fmt=None):
        self.ctx = llag.create_ll_ag_buffer(shape, dtype, N,
                                            wire_format=fmt, device="cuda")
        self.calls = 0

    def next(self):
        self.calls += 1
        return self.calls - 1


def _ll_floor(cs):
    """Device µs of ll_ag_kernel on 16 bytes a rank (its own fresh
    context) at the wrapper's grid, each launch held bitwise first."""
    x = torch.ones((N, 4), dtype=torch.float32, device="cuda")
    c = Context(x.shape[1:], x.dtype)
    want = x[None].expand(N, *x.shape)

    def call():
        return llag._launch(x, c.ctx, c.next())

    for _ in range(3):
        if not torch.equal(call(), want):
            raise AssertionError("ll_ag_kernel on 16 bytes: not bitwise")
    return cs.device_us(call, "ll_ag_kernel")


def ll_host_parts(cs, x, c):
    """chip_smoke.host_parts of the LL wrapper on x over the Context c:
    the whole call and the bare launch take c's next call index, so the
    protocol's values stay in order; the kernel keeps no pool."""
    lib = _build.load("low_latency_allgather", llag._SIGNATURES)
    n = x.shape[0]
    nbytes = math.prod(x.shape[1:]) * x.element_size()
    out = torch.empty((n, n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    grid = _build.GridInfo()
    stream = _build.raw_stream(x.device)
    # a package whose entry takes a device count pointer gets none
    count = (None,) if len(llag._SIGNATURES["ll_ag_launch"][1]) > 10 else ()

    def launch(m):
        err = lib.ll_ag_launch(
            x.data_ptr(), c.ctx.data.data_ptr(), c.ctx.flags.data_ptr(),
            out.data_ptr(), n if m is None else m, nbytes,
            c.next() if m is None else c.calls, 0, *count, grid.ptr(),
            stream)
        assert (err == 0) == (m is None), err

    return cs.host_parts(
        lambda: llag.ll_all_gather(x, c.ctx, c.next()),
        lambda: (wire.resolve(None), llag._check(x, c.ctx, c.calls)),
        lambda: torch.empty((n, n, *x.shape[1:]), dtype=x.dtype,
                            device=x.device),
        launch, pools=None)


def ll_row(cs, label, shape, dtype, fmt, seed, redesigned):
    x = cs.rand((N, *shape), dtype, seed)
    f = None if fmt is None else wire.WireFormat(*fmt)
    c, twin = Context(shape, dtype, f), Context(shape, dtype, f)
    xw = x if f is None else wire.pack(x.reshape(-1, shape[-1]), f).reshape(
        N, shape[0], -1)
    want = (x if f is None else wire.roundtrip(
        x.reshape(-1, shape[-1]), f).reshape(x.shape))[None].expand(
            N, *x.shape)
    for _ in range(CHECK_CALLS):
        got, _ = llag.ll_all_gather(x, c.ctx, c.next(), wire_format=f)
        llag.ll_all_gather_plain(xw, twin.ctx, twin.next())
        torch.cuda.synchronize()
        if not (torch.equal(got, want)
                and torch.equal(c.ctx.data, twin.ctx.data)
                and torch.equal(c.ctx.flags[:, :2 * N],
                                twin.ctx.flags[:, :2 * N])):
            raise AssertionError(f"ll_all_gather {label}: not bitwise its "
                                 "plain version and twin context")

    def fn():
        return llag.ll_all_gather(x, c.ctx, c.next(), wire_format=f)

    nbytes = (N + N * N) * xw[0].numel() * xw.element_size()
    row = _timed(cs, fn, "ll_ag_kernel",
                 lambda: x[None].expand(N, *x.shape).contiguous(), nbytes)
    row.update(shape=[N, *shape], dtype=str(dtype)[6:],
               wire=None if f is None else list(fmt),
               bytes_a_rank=xw[0].numel() * xw.element_size())
    if redesigned and f is None:
        row["host_parts_us"] = ll_host_parts(cs, x, c)
    row["floor_us"] = _ll_floor(cs)
    return row


def _p2p_floor(cs, blocks, body=None):
    """Device µs of p2p_kernel on 16 bytes a rank at `blocks` a rank
    through its C entry: the parent's (a fresh zeroed flag pool a launch)
    where body is None, else the redesign's body over its pool."""
    lib = _build.load("p2p", p2p._SIGNATURES)
    tiny = torch.ones((N, 8), dtype=torch.bfloat16, device="cuda")
    grid = _build.GridInfo()

    def call():
        out = torch.empty_like(tiny)
        if body is None:
            flags = VirtualWorld.of(tiny).flags(lib.p2p_flag_words())
            err = lib.p2p_launch(tiny.data_ptr(), out.data_ptr(),
                                 flags.data_ptr(), N, 16, PP_SRC, PP_DST,
                                 -1, 0, blocks, grid.ptr(),
                                 torch.cuda.current_stream().cuda_stream)
        else:
            _, flags, stream = p2p._buffers(tiny)
            err = lib.p2p_launch(tiny.data_ptr(), out.data_ptr(),
                                 flags.data_ptr(), p2p._MAX_BLOCKS, N, 16,
                                 PP_SRC, PP_DST, -1, 0, blocks,
                                 int(body == "bulk"), grid.ptr(), stream)
        assert err == 0, err
        return out

    assert torch.equal(call(), p2p.p2p_send_plain(tiny, PP_SRC, PP_DST))
    return cs.device_us(call, "p2p_kernel")


def _p2p_forced(cs, x, body):
    """Device µs of p2p_kernel on x with its body forced, each launch
    held bitwise first."""
    want = p2p.p2p_send_plain(x, PP_SRC, PP_DST)

    def call():
        return p2p._launch_p2p(x, PP_SRC, PP_DST, None, body=body)

    if not torch.equal(call(), want):
        raise AssertionError(f"p2p_kernel {body}: not bitwise")
    return cs.device_us(call, "p2p_kernel")


def p2p_host_parts(cs, x, src, dst):
    """chip_smoke.host_parts of p2p_send's wrapper on x from src to
    dst."""
    lib = _build.load("p2p", p2p._SIGNATURES)
    nbytes, _, _ = p2p._check_launch("p2p_send", x, None)
    body = p2p._body_for(nbytes, x.data_ptr() % 16 == 0)
    out, flags, stream = p2p._buffers(x)
    grid = _build.GridInfo()

    def launch(m):
        err = lib.p2p_launch(
            x.data_ptr(), out.data_ptr(), flags.data_ptr(), p2p._MAX_BLOCKS,
            x.shape[0] if m is None else m, nbytes, src, dst, -1, 0,
            p2p._blocks_for(nbytes), int(body == "bulk"), grid.ptr(), stream)
        assert (err == 0) == (m is None), err

    return cs.host_parts(
        lambda: p2p.p2p_send(x, src, dst),
        lambda: (p2p._check_ranks(x, src, dst),
                 p2p._check_launch("p2p_send", x, None)),
        lambda: p2p._buffers(x), launch, pools=p2p._POOLS,
        more=dict(body=lambda: p2p._body_for(nbytes, x.data_ptr() % 16
                                             == 0)))


def p2p_row(cs, seed, redesigned):
    x = cs.rand((N, *PP_SHAPE), torch.bfloat16, seed)
    want = p2p.p2p_send_plain(x, PP_SRC, PP_DST)
    for _ in range(CHECK_CALLS):
        if not torch.equal(p2p.p2p_send(x, PP_SRC, PP_DST), want):
            raise AssertionError("p2p_send: not bitwise its plain version")

    def fn():
        return p2p.p2p_send(x, PP_SRC, PP_DST)

    nbytes = x[0].numel() * x.element_size()
    made = p2p._POOLS.made if redesigned else None
    row = _timed(cs, fn, "p2p_kernel",
                 lambda: x.clone()[PP_DST].copy_(x[PP_SRC]),
                 (2 * N - 1) * nbytes)
    row.update(shape=[N, *PP_SHAPE], dtype="bfloat16", src=PP_SRC,
               dst=PP_DST)
    if not redesigned:
        row["floor_us"] = _p2p_floor(cs, 128)
        return row
    grid = _build.GridInfo()
    p2p._launch_p2p(x, PP_SRC, PP_DST, None, grid=grid)
    row.update(body=p2p._body_for(nbytes, True), blocks=grid.per_rank,
               host_parts_us=p2p_host_parts(cs, x, PP_SRC, PP_DST),
               body_us={b: _p2p_forced(cs, x, body=b) for b in p2p._BODIES},
               floor_us={b: _p2p_floor(cs, grid.per_rank, b)
                         for b in p2p._BODIES})
    sweep = {}
    for nb in P2P_SWEEP:
        y = cs.rand((N, nb // 2), torch.bfloat16, seed + nb)
        for b in p2p._BODIES:
            sweep[f"{nb} {b}"] = _p2p_forced(cs, y, body=b)
    row["sweep_us"] = sweep
    row["pools_made_warm"] = p2p._POOLS.made - made
    row["pool_words_zero"] = all(not bool(f.any())
                                 for f in p2p._POOLS.entries.values())
    return row


def _fm_us(cs, x):
    """Device µs of fm_ag_kernel on x, each launch held bitwise first."""
    want = kernels.full_mesh_all_gather_plain(x)
    for _ in range(3):
        if not torch.equal(kernels.full_mesh_all_gather(x), want):
            raise AssertionError("fm_ag_kernel: not bitwise")
    return cs.device_us(lambda: kernels.full_mesh_all_gather(x),
                        "fm_ag_kernel")


def fm_host_parts(cs, x):
    """chip_smoke.host_parts of the full mesh's wrapper on x."""
    lib = _build.load("allgather", ag._SIGNATURES)
    n = x.shape[0]
    chunk = x[0].numel() * x.element_size()
    out, flags, stream = ag._fm_buffers(x)
    grid = _build.GridInfo()

    def launch(m):
        err = lib.fm_ag_launch(
            x.data_ptr(), out.data_ptr(), flags.data_ptr(), ag._FM_MAX_BLOCKS,
            n if m is None else m, chunk, -1, 0, ag._fm_blocks_for(n, chunk),
            grid.ptr(), stream)
        assert (err == 0) == (m is None), err

    return cs.host_parts(
        lambda: kernels.full_mesh_all_gather(x),
        lambda: (wire.resolve(None), ag._check_launch(x),
                 _build.straggler_args(None, n)),
        lambda: ag._fm_buffers(x), launch, pools=ag._FM_POOLS)


def fm_row(cs, seed, redesigned):
    y = cs.rand((N, *FM_SHAPE), torch.bfloat16, seed)
    want = kernels.full_mesh_all_gather_plain(y)
    for _ in range(CHECK_CALLS):
        if not torch.equal(kernels.full_mesh_all_gather(y), want):
            raise AssertionError("full_mesh_all_gather: not bitwise its "
                                 "plain version")
    shard = y[0].numel() * y.element_size()
    made = ag._FM_POOLS.made if redesigned else None
    row = _timed(cs, lambda: kernels.full_mesh_all_gather(y), "fm_ag_kernel",
                 lambda: y.reshape(1, -1, FM_SHAPE[1]).expand(
                     N, N * FM_SHAPE[0], FM_SHAPE[1]).contiguous(),
                 (N + N * N) * shard)
    row.update(shape=[N, *FM_SHAPE], dtype="bfloat16")
    tiny = torch.ones((N, 1, 8), dtype=torch.bfloat16, device="cuda")
    if not redesigned:
        row["floor_us"] = _fm_us(cs, tiny)
        return row
    grid = _build.GridInfo()
    ag._launch_fm(y, None, grid=grid)
    row.update(blocks=grid.per_rank, host_parts_us=fm_host_parts(cs, y),
               floor_us=_fm_us(cs, tiny))
    sweep = {}
    for i, shape in enumerate(FM_SWEEP):
        x = cs.rand((N, *shape), torch.bfloat16, seed + 1 + i)
        sweep[str(shape[0] * shape[1] * 2)] = _fm_us(cs, x)
    row["sweep_us"] = sweep
    row["pools_made_warm"] = ag._FM_POOLS.made - made
    row["pool_words_zero"] = all(not bool(f.any())
                                 for f in ag._FM_POOLS.entries.values())
    return row


def controls(cs, seed):
    x = cs.rand((N, *PP_SHAPE), torch.bfloat16, seed)
    assert torch.equal(kernels.ring_shift(x, 1), torch.roll(x, 1, 0))
    nbytes = x[0].numel() * x.element_size()
    return {"row 15 ring_shift PP handoff": _timed(
        cs, lambda: kernels.ring_shift(x, 1), "ring_shift_kernel",
        lambda: torch.roll(x, 1, 0), 2 * N * nbytes)}


def main() -> None:
    cs = _chip_smoke()
    _build.build(["low_latency_allgather", "p2p", "allgather"])
    redesigned = hasattr(p2p, "_POOLS")
    rows = {}
    for seed, (label, shape, dtype, fmt) in enumerate(LL_CASES):
        rows[f"row 9 ll_all_gather {label}"] = ll_row(
            cs, label, shape, dtype, fmt, seed, redesigned)
        print(json.dumps({f"row 9 {label}": rows[
            f"row 9 ll_all_gather {label}"]}), flush=True)
    rows["row 14 p2p_send PP handoff"] = p2p_row(cs, 10, redesigned)
    print(json.dumps({"row 14": rows["row 14 p2p_send PP handoff"]}),
          flush=True)
    rows["row 8b full_mesh_all_gather (128, 4096)"] = fm_row(
        cs, 21, hasattr(ag, "_FM_POOLS"))
    print(json.dumps({"row 8b": rows[
        "row 8b full_mesh_all_gather (128, 4096)"]}), flush=True)
    for k, v in controls(cs, 20).items():
        rows[k] = v
        print(json.dumps({k: v}), flush=True)
    print(json.dumps({"package": os.path.dirname(
        triton_dist_tpu_torch.__file__), "card": cs.card_line(),
        "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
