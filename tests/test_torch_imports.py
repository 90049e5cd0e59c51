"""The port never imports JAX or the JAX package: every module of
triton_dist_tpu_torch, and chip_smoke.py, imports in a fresh interpreter
in which `jax` and `triton_dist_tpu` cannot be imported."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "triton_dist_tpu"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
import triton_dist_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    triton_dist_tpu_torch.__path__, "triton_dist_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "triton_dist_tpu")]
assert not bad, bad
print(len(names), "modules")
"""


def test_port_and_chip_smoke_import_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          env={**env, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n = int(proc.stdout.split()[0])
    assert n >= 40, proc.stdout  # every module was walked


def test_all_to_all_name_is_the_module():
    """`all_to_all` names a submodule of kernels/ and a function in it;
    kernels/__init__.py does not re-export the function, so importing the
    name from the package yields the module."""
    import types

    from triton_dist_tpu_torch import kernels
    from triton_dist_tpu_torch.kernels import all_to_all
    from triton_dist_tpu_torch.kernels.all_to_all import all_to_all as fn

    assert isinstance(all_to_all, types.ModuleType)
    assert all_to_all.all_to_all is fn
    assert kernels.KERNELS["all_to_all"] is fn
    assert kernels.SOURCES["all_to_all"] == "all_to_all"
