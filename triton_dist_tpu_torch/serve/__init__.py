"""Continuous-batching serving plane (host loop): a priority queue, a
Scheduler that packs prefill chunks and decode tokens into one
fixed-geometry step, a Worker that runs the step, and a paged KV pool.

    sch = Scheduler(engine, slots=4, chunk=64, page=64)
    req = sch.submit(prompt_ids, max_new_tokens=32)
    sch.run()
    req.out_tokens
"""

from triton_dist_tpu_torch.serve.kv_pool import (  # noqa: F401
    KVPool,
    PoolExhausted,
    pages_for,
)
from triton_dist_tpu_torch.serve.queue import QueueFull, RequestQueue  # noqa: F401
from triton_dist_tpu_torch.serve.request import (  # noqa: F401
    Request,
    RequestState,
    TokenStream,
    summarize,
)
from triton_dist_tpu_torch.serve.scheduler import Scheduler  # noqa: F401
from triton_dist_tpu_torch.serve.worker import Worker, sampling_seed  # noqa: F401
