"""ModelBuilder — the megakernel's host-side op API, port of
triton_dist_tpu.mega.builder.

Ops append Tasks to a Graph; each carries a branch_key = (op kind, static
shape tuple) and dynamic args (queue row = [branch, a0..a5]) exactly as
the JAX builder (builder.py:38-229) makes them:

  matmul        [layer, src_buf, dst_buf, norm_row]
  rms_norm      [norm_row, src_buf, dst_buf]
  silu_mul      [src_buf, dst_buf, 0]
  add           [a_buf, b_buf, dst_buf]
  allreduce_add [partial_buf, residual_buf, dst_buf, parity]
  attention     [layer, qkv_buf, dst_buf, k_new_buf, v_new_buf]
  barrier       [0, 0, 0]

Buffer-id args are rewritten to workspace slots at compile time.

The JAX `cost=` estimates come from its TPU perf model; here a task's
cost is a plain byte count, the weight and activation bytes it moves
over the H100's 3.35 TB/s, in ms. The scheduler only ranks by it, and
the Qwen3 graph is a chain whose order no cost changes. The AR's parity
arg is kept so the rows equal the JAX builder's; the CUDA kernel gives
every AR task its own mailbox slot and never reads it (kernel.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

from triton_dist_tpu_torch.mega.core import BufferHandle, Graph, Task

HBM_BYTES_PER_MS = 3.35e9


class ModelBuilder:
    """Builds the task graph of one decode step (batch rows × op widths)."""

    def __init__(self, batch: int, axis: str = "tp", world: int = 1):
        self.graph = Graph(batch)
        self.batch = batch
        self.axis = axis
        self.world = world
        self._ar_count = 0

    @staticmethod
    def _ms(elements: float) -> float:
        """ms to move `elements` bf16 values (the costs only rank tasks,
        so one element size serves every dtype)."""
        return elements * 2 / HBM_BYTES_PER_MS

    def buffer(self, width: int, name: str = "",
               pinned: bool = False) -> BufferHandle:
        return self.graph.buffer(width, name, pinned)

    def make_barrier(self) -> Optional[Task]:
        """Entry barrier of every rank's blocks (world > 1 only)."""
        if self.world <= 1:
            return None
        return self.graph.add_task(
            "barrier", ("barrier", self.axis, self.world), [0, 0, 0],
            reads=[], writes=[], cost=0.0, tag="barrier",
        )

    def make_matmul(self, wname: str, layer: int, src: BufferHandle, k: int,
                    n_cols: int, dst: Optional[BufferHandle] = None,
                    tag: str = "", prologue: Optional[str] = None,
                    eps: float = 0.0, norm_row: int = 0) -> BufferHandle:
        """dst(B, n_cols) = prologue(src) @ weights[wname][layer]."""
        dst = dst or self.buffer(n_cols, tag or wname)
        in_w = 2 * k if prologue == "silu" else k
        self.graph.add_task(
            "matmul", ("matmul", wname, k, n_cols, prologue, eps),
            [layer, src.id, dst.id, norm_row],
            reads=[src], writes=[dst],
            cost=self._ms(k * n_cols + self.batch * (in_w + n_cols)),
            tag=tag or f"{wname}[{layer}]", buf_args=(1, 2),
        )
        return dst

    def make_rms_matmul(self, wname, layer, src, k, n_cols, norm_row,
                        eps, dst=None, tag=""):
        """Fused rms_norm(src) @ W."""
        return self.make_matmul(wname, layer, src, k, n_cols, dst=dst,
                                tag=tag or f"rms+{wname}[{layer}]",
                                prologue="rms", eps=eps,
                                norm_row=norm_row)

    def make_act_matmul(self, wname, layer, src, inter, n_cols,
                        dst=None, tag=""):
        """Fused (silu(gate) * up) @ W: src is the (B, 2*inter) gate_up
        output, contract dim = inter."""
        return self.make_matmul(wname, layer, src, inter, n_cols,
                                dst=dst,
                                tag=tag or f"silu+{wname}[{layer}]",
                                prologue="silu")

    def make_rms_norm(self, norm_row: int, src: BufferHandle, width: int,
                      eps: float, dst: Optional[BufferHandle] = None,
                      tag: str = "") -> BufferHandle:
        """dst = rms_norm(src) * norms[norm_row] over `width` columns."""
        dst = dst or self.buffer(width, tag or "rmsnorm")
        self.graph.add_task(
            "rms_norm", ("rms_norm", width, eps),
            [norm_row, src.id, dst.id],
            reads=[src], writes=[dst], cost=self._ms(2 * self.batch * width),
            tag=tag or f"rms[{norm_row}]", buf_args=(1, 2),
        )
        return dst

    def make_silu_mul(self, src: BufferHandle, inter: int,
                      dst: Optional[BufferHandle] = None,
                      tag: str = "") -> BufferHandle:
        """dst(B, inter) = silu(src[:, :inter]) * src[:, inter:2*inter]."""
        dst = dst or self.buffer(inter, tag or "silu_mul")
        self.graph.add_task(
            "silu_mul", ("silu_mul", inter), [src.id, dst.id, 0],
            reads=[src], writes=[dst], cost=self._ms(3 * self.batch * inter),
            tag=tag or "silu_mul", buf_args=(0, 1),
        )
        return dst

    def make_add(self, a: BufferHandle, b: BufferHandle, width: int,
                 dst: Optional[BufferHandle] = None,
                 tag: str = "") -> BufferHandle:
        """dst = a + b (residual adds)."""
        dst = dst or self.buffer(width, tag or "add")
        self.graph.add_task(
            "add", ("add", width), [a.id, b.id, dst.id],
            reads=[a, b], writes=[dst], cost=self._ms(3 * self.batch * width),
            tag=tag or "add", buf_args=(0, 1, 2),
        )
        return dst

    def make_allreduce_add(self, partial: BufferHandle,
                           residual: BufferHandle, width: int,
                           dst: Optional[BufferHandle] = None,
                           tag: str = "") -> BufferHandle:
        """dst = all_reduce(partial, axis) + residual: the row-parallel
        epilogue fused with the residual add."""
        dst = dst or self.buffer(width, tag or "ar")
        parity = self._ar_count % 2
        self._ar_count += 1
        self.graph.add_task(
            "allreduce_add",
            ("allreduce_add", width, self.axis, self.world),
            [partial.id, residual.id, dst.id, parity],
            reads=[partial, residual], writes=[dst],
            cost=self._ms((2 * self.world + 2) * self.batch * width),
            tag=tag or f"ar[{self._ar_count - 1}]", buf_args=(0, 1, 2),
        )
        return dst

    def make_attention(self, layer: int, qkv: BufferHandle, hq_l: int,
                       hkv_l: int, head_dim: int, s_max: int, eps: float,
                       use_qk_norm: bool, q_norm_base: int = 0,
                       k_norm_base: int = 0,
                       dst: Optional[BufferHandle] = None, tag: str = "",
                       page: int = 0
                       ) -> Tuple[BufferHandle, BufferHandle, BufferHandle]:
        """Decode attention: qk-norm + rope + GQA over the cached prefix,
        with the new token's k/v folded into the softmax. Returns
        (attn_out, k_new, v_new); the caller scatters k_new/v_new into the
        cache outside the kernel."""
        dst = dst or self.buffer(hq_l * head_dim, tag or "attn")
        kn = self.buffer(hkv_l * head_dim, f"k_new[{layer}]", pinned=True)
        vn = self.buffer(hkv_l * head_dim, f"v_new[{layer}]", pinned=True)
        kv = 2 * self.batch * s_max * hkv_l * head_dim
        self.graph.add_task(
            "attention",
            ("attention", hq_l, hkv_l, head_dim, s_max, eps, use_qk_norm,
             q_norm_base, k_norm_base, page),
            [layer, qkv.id, dst.id, kn.id, vn.id],
            reads=[qkv], writes=[dst, kn, vn],
            cost=self._ms(kv + 2 * self.batch * (hq_l + 2 * hkv_l)
                          * head_dim),
            tag=tag or f"attn[{layer}]", buf_args=(1, 2, 3, 4),
        )
        return dst, kn, vn


def branch_graph(world: int, batch: int, hidden: int, inter: int, hq_l: int,
                 hkv_l: int, head_dim: int, s_max: int, page: int = 0
                 ) -> Graph:
    """A graph with every megakernel branch once (matmul with none / rms /
    silu prologue, rms_norm, silu_mul, add, attention, allreduce_add, and
    a barrier at world > 1) at the widths a rank sees, every buffer pinned
    so each branch keeps its own output slot: the graph the kernel is held
    against run_plain on, branch by branch. Its input x is buffer 0;
    weights w_gu, w_dn, w_qkv, w_o, w_gu2, w_dn2 of two layers; norm rows
    0-6."""
    mb = ModelBuilder(batch, world=world)
    x = mb.buffer(hidden, "x", pinned=True)
    mb.make_barrier()
    h1 = mb.make_rms_norm(0, x, hidden, 1e-6)
    gu = mb.make_matmul("w_gu", 0, h1, hidden, 2 * inter)
    act = mb.make_silu_mul(gu, inter)
    dn = mb.make_matmul("w_dn", 0, act, inter, hidden)
    s = mb.make_add(dn, x, hidden)
    qkv = mb.make_rms_matmul("w_qkv", 1, s, hidden,
                             (hq_l + 2 * hkv_l) * head_dim, 1, 1e-6)
    attn, _, _ = mb.make_attention(1, qkv, hq_l, hkv_l, head_dim, s_max,
                                   1e-6, True, q_norm_base=3, k_norm_base=5,
                                   page=page)
    o = mb.make_matmul("w_o", 1, attn, hq_l * head_dim, hidden)
    x2 = mb.make_allreduce_add(o, s, hidden)
    gu2 = mb.make_rms_matmul("w_gu2", 0, x2, hidden, 2 * inter, 2, 1e-6)
    dn2 = mb.make_act_matmul("w_dn2", 0, gu2, inter, hidden)
    mb.make_allreduce_add(dn2, x2, hidden)
    for buf in mb.graph.buffers:
        mb.graph.pinned[buf.id] = True
    return mb.graph
