"""Continuous-batching serving plane: a priority queue, a Scheduler that
packs prefill chunks and decode tokens into one fixed-geometry step, a
Worker that runs the step, a paged KV pool, and the resident form
(`Scheduler(resident=True)`: a ResidentWorker feeding windows of the
Engine's resident loop through an injection ring).

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
from triton_dist_tpu_torch.serve.worker import (  # noqa: F401
    ResidentWorker,
    Worker,
    sampling_key,
)
