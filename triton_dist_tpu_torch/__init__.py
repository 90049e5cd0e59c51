"""triton_dist_tpu_torch — the PyTorch + CUDA port of triton_dist_tpu.

A second package beside the JAX one, laid out the same way so each
module has an obvious counterpart:

  runtime/  device selection (cuda unless the caller asks for cpu)
  models/   ModelConfig, KVCache, the dense Qwen3 forward, Engine
  layers/   rms_norm, rope, GQA attention, the TP attention/MLP blocks
  kernels/  hand-written CUDA kernels, their wrappers and plain versions
  csrc/     the .cu sources, built with nvcc at first use
  serve/    the continuous-batching host loop (Scheduler, Worker, KVPool)
  tools/    measurement scripts that run on a CUDA card

Scope: one card (world = 1), the "ar" routing of the JAX package. Every
JAX mode is the same computation at world 1, so there is no planner.
The package never imports jax or triton_dist_tpu; the tests import both
and hold this package against the JAX one on the same numpy inputs.
"""
