from triton_dist_tpu_torch.runtime.device import (  # noqa: F401
    check_modes,
    resolve_device,
)
from triton_dist_tpu_torch.runtime.symm_mem import VirtualWorld  # noqa: F401
