"""triton_dist_tpu_torch — the PyTorch + CUDA port of triton_dist_tpu.

A second package beside the JAX one, laid out the same way so each
module has an obvious counterpart:

  runtime/  device selection (cuda unless the caller asks for cpu), and
            the virtual world: n ranks on one card, a symmetric heap
            with a rank dim and a flag pool
  models/   ModelConfig, KVCache, the Qwen3 forward (dense and MoE),
            Engine, the Qwen3MoE entry points (and MegaQwen3, the
            megakernel decode, from mega/)
  mega/     the decode megakernel: task graph, builder, scheduler and
            slot plan, the compiled queue, MegaQwen3 and its caches
  layers/   rms_norm, rope, GQA attention, the TP attention/MLP/MoE
            blocks
  kernels/  hand-written CUDA kernels, their wrappers and plain versions
            (flash prefill; one-shot AllReduce, ring AllGather, ring
            ReduceScatter, GEMM+ReduceScatter and the fused
            AllGather+GEMM, dense and grouped, over the virtual world;
            gemm_ar over them; the decode megakernel's launch), and
            the MoE routing and grouped products in torch ops
  csrc/     the .cu sources and shared headers (shmem.cuh: put, signal,
            wait, barrier on the virtual heap), built with nvcc at first
            use
  serve/    the continuous-batching host loop (Scheduler, Worker, KVPool)
  tools/    measurement scripts that run on a CUDA card

Scope: one card; tensor parallelism at world n runs as a virtual world
of n ranks on it, in the JAX package's "dist", "xla" and "ar" modes
(and "fused" for an MoE model).
There is no planner: the caller's mode string is the plan. A dense
model's decode can also run as the megakernel: one persistent launch a
step over every rank (mega/).
The package never imports jax or triton_dist_tpu; the tests import both
and hold this package against the JAX one on the same numpy inputs.
"""
