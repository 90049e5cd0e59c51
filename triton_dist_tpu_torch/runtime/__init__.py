from triton_dist_tpu_torch.runtime.device import (  # noqa: F401
    check_world,
    resolve_device,
)
