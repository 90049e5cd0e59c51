"""The megakernel launch — the counted wrapper of csrc/mega.cu, the port
of the Pallas megakernel that triton_dist_tpu.mega.kernel.compile_graph
builds (kernel.py:980, launched at :1386).

  mega_step(cm, pos, table, ws, weights, norms, rope_cs, k_pool, v_pool)
      one decode step of the compiled queue `cm`
      (triton_dist_tpu_torch.mega.kernel.CompiledMega) over the
      workspace ws, in place: the CUDA kernel on a CUDA tensor (one
      cooperative launch for every rank of the virtual world, or a
      raise), `cm.run_plain` on a CPU tensor.

The kernel's arguments cross as one int64 array (`_ARGS` names the
entries; csrc/mega.cu reads them by the same indices). A weight the
queue takes tile-major (`cm.tiled`) must come as (L, n, N // tn, K, tn),
every other as (L, n, K, N), streamed as TMA boxes, so its matmuls must
share one tiling: any other layout raises, none is re-laid here.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_WEIGHTS = 8
_PER_WEIGHT = ("w", "w_layer", "w_rank", "w_tiled", "w_k", "w_n", "w_tn",
               "w_split", "w_planes", "pf_w")
_ARGS = ("queue", "n_rows", "pos", "table", "maxp", "ws", "ws_rank",
         "ws_slot", "wmax", "batch", "norms", "norm_w", "rope", "kpool",
         "vpool", "hkv_tot", "n_pages", "page", "mbox", "mb_rank",
         "mb_task", "mb_src", "mb_w", "flags", "flag_stride",
         "barrier_flag", "partial", "partial_stride", "n_w", "depth",
         "n_spec",
         *(f"{k}{i}" for k in _PER_WEIGHT for i in range(MAX_WEIGHTS)))
_SIGNATURES = {
    "mega_launch": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p]),
    "mega_arg_count": (ctypes.c_int, []),
    "mega_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


@_build.counted("mega")
def mega_step(cm, pos, table, ws, weights, norms, rope_cs, k_pool, v_pool):
    """One decode step of `cm` over ws (n, n_slots, B, wmax), in place;
    returns ws. See CompiledMega.run for the operands."""
    if ws.device.type == "cpu":
        return cm.run_plain(pos, table, ws, weights, norms, rope_cs, k_pool,
                            v_pool)
    return _launch(cm, pos, table, ws, weights, norms, rope_cs, k_pool,
                   v_pool)


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"megakernel launch: {what}")


def _launch(cm, pos, table, ws, weights, norms, rope_cs, k_pool, v_pool):
    dev = ws.device
    _need(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    dt = ws.dtype
    _need(dt in _DTYPE_CODE, f"dtype {dt}: float32 or bfloat16")
    n, B = cm.world, cm.pb
    _need(tuple(ws.shape) == (n, cm.n_slots, B, cm.wmax)
          and ws.is_contiguous(), f"workspace {tuple(ws.shape)}")
    names = cm.weight_names
    _need(len(names) <= MAX_WEIGHTS, f"{len(names)} weights")
    for name in names:
        w = weights[name]
        want = cm.weight_shape(name, w.shape[0])
        _need(w.device == dev and w.dtype == dt and w.is_contiguous()
              and (None in want or tuple(w.shape) == want)
              and w.dim() == len(want) and w.shape[1] == n,
              f"weight {name} {tuple(w.shape)} {w.dtype}: the queue takes "
              f"it as {want}")
        _need(name in cm.tiled or cm.w_geom[name] is not None,
              f"weight {name}: TMA boxes need one tiling of its matmuls")
    _need(norms.dtype == torch.float32 and norms.is_contiguous()
          and norms.shape[1] == cm.norm_width, "norms (rows, norm_width) f32")
    _need(rope_cs.dtype == torch.float32 and rope_cs.is_contiguous(),
          "rope_cs f32")
    _need(pos.dtype == torch.int32 and tuple(pos.shape) == (B,)
          and table.dtype == torch.int32 and table.is_contiguous()
          and table.shape[0] == B, "pos (B,) and table (B, MAXP) int32")
    for t in (pos, table, norms, rope_cs, k_pool, v_pool):
        _need(t.device == dev, "every operand on the workspace's device")
    at = cm.attn
    if at is not None:
        _need(k_pool.dtype == dt and v_pool.dtype == dt
              and k_pool.is_contiguous() and v_pool.is_contiguous()
              and k_pool.shape == v_pool.shape
              and k_pool.shape[1] == n * at["hkv_l"]
              and k_pool.shape[3] == at["page"]
              and k_pool.shape[4] == at["D"]
              and table.shape[1] == at["maxp"]
              and rope_cs.shape[1] == at["D"],
              f"kv pools {tuple(k_pool.shape)} / table "
              f"{tuple(table.shape)} against the graph's attention {at}")
    world = VirtualWorld(n, dev)
    mbox = (world.heap((max(cm.n_ar, 1), n, B, cm.arw), dt) if n > 1
            else None)
    flags = world.flags(cm.n_flags)
    partial = world.heap((max(cm.n_partial, 1),), torch.float32)
    a = dict(queue=cm.queue_on(dev).data_ptr(), n_rows=cm.queue.shape[0],
             pos=pos.data_ptr(), table=table.data_ptr(),
             maxp=table.shape[1], ws=ws.data_ptr(),
             ws_rank=ws[0].numel(), ws_slot=ws[0, 0].numel(), wmax=cm.wmax,
             batch=B, norms=norms.data_ptr(), norm_w=norms.shape[1],
             rope=rope_cs.data_ptr(), kpool=k_pool.data_ptr(),
             vpool=v_pool.data_ptr(), hkv_tot=k_pool.shape[1],
             n_pages=k_pool.shape[2], page=k_pool.shape[3],
             mbox=0 if mbox is None else mbox.data_ptr(),
             mb_rank=0 if mbox is None else mbox[0].numel(),
             mb_task=n * B * cm.arw, mb_src=B * cm.arw, mb_w=cm.arw,
             flags=flags.data_ptr(), flag_stride=cm.n_flags,
             barrier_flag=cm.n_flags - 1, partial=partial.data_ptr(),
             partial_stride=partial.shape[1], n_w=len(names),
             depth=cm.pf_depth, n_spec=len(cm.prefetch.specs))
    for i, name in enumerate(names):
        w = weights[name]
        geom = cm.w_geom[name] or (0, 0, 0, 0)
        a.update({f"w{i}": w.data_ptr(), f"w_layer{i}": w[0].numel(),
                  f"w_rank{i}": w[0, 0].numel(),
                  f"w_tiled{i}": int(name in cm.tiled),
                  f"w_k{i}": geom[0], f"w_n{i}": geom[1],
                  f"w_tn{i}": geom[2], f"w_split{i}": geom[3],
                  f"w_planes{i}": w.shape[0] * n})
    for c, spec in enumerate(cm.prefetch.specs):
        a[f"pf_w{c}"] = names.index(spec[0])
    args = np.array([a.get(k, 0) for k in _ARGS], dtype=np.int64)
    lib = _build.load("mega", _SIGNATURES)
    _need(lib.mega_arg_count() == len(_ARGS), "argument layout mismatch")
    grid = _build.GridInfo()
    with torch.cuda.device(dev):
        err = lib.mega_launch(args.ctypes.data, n, cm.blocks,
                              _DTYPE_CODE[dt], grid.ptr(),
                              torch.cuda.current_stream().cuda_stream)
    _build.check("mega", err, lib.mega_error_string, grid)
    _build.count_launch("mega")
    return ws
