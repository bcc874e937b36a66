"""Launchers of the PyTorch port: ``python -m repro_torch.launch.serve``
and ``python -m repro_torch.launch.train``; and the dry-run tools:
:mod:`~repro_torch.launch.mesh` (the production meshes),
:mod:`~repro_torch.launch.sharding` (the sharding rules),
:mod:`~repro_torch.launch.op_cost` (the per-partition cost counter),
:mod:`~repro_torch.launch.dryrun` and
:mod:`~repro_torch.launch.dryrun_diffusion` (the CLIs).

The submodules load on first use, so that ``python -m`` of one of them
does not find it imported by its package already."""

import importlib

__all__ = ["dryrun", "dryrun_diffusion", "mesh", "op_cost", "serve",
           "sharding", "train"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
