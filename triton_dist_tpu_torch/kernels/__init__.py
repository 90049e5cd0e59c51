"""Hand-written CUDA kernels of the port, each beside its plain version.

`KERNELS` maps every kernel's name to its counted wrapper;
`reset_launches()` / `launches()` read and clear the launch counts.
"""

from triton_dist_tpu_torch.kernels._build import (  # noqa: F401
    KERNELS,
    build,
    launches,
    reset_launches,
)
from triton_dist_tpu_torch.kernels.flash_prefill import (  # noqa: F401
    fit_block,
    flash_prefill_local,
    flash_prefill_plain,
    supports_flash_prefill,
)

# kernel name -> its csrc/ source stem, for building all of them at once
SOURCES = {"flash_prefill_local": "flash_prefill"}
