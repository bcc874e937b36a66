"""Production mesh construction, the counterpart of ``repro.launch.mesh``.

One card cannot hold a 256- or 512-device mesh, so the port's production
mesh is a ``torch.distributed`` ``DeviceMesh`` over a *fake* process group
(``torch.testing._internal.distributed.fake_pg``): this process plays rank
0 of 256 or 512, every collective returns at once without moving a byte,
and tensors on the ``meta`` device carry the shapes.  That is what the
dry run (:mod:`repro_torch.launch.dryrun`) needs: the local shapes, the
sharding decisions and the collectives a real run would issue.

Functions, not module-level constants: importing this module touches no
device and no process-group state.  The fake group is global to the
process, so a mesh of another size tears the previous fake group down
(:func:`release`); a real (non-fake) group is never touched.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

# The device type the mesh names.  The fake group moves nothing, so no
# device is touched; "cuda" (not "cpu") keeps DTensor off its Gloo
# fallback, which replaces every all-to-all by an all-gather.
MESH_DEVICE = "cuda"


def _fake_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialized; the "
                               "dry-run mesh needs a fake one")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def release() -> None:
    """Tear down the fake process group, if one is up (a real group is
    left alone)."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def fake_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake process
    group of ``prod(shape)`` ranks, this process rank 0."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= int(s)
    _fake_group(n)
    return DeviceMesh(MESH_DEVICE, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return fake_mesh(shape, axes)


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, of any object with
    ``axis_names`` and ``shape`` (or the JAX package's ``devices.shape``),
    or of such a dict itself."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    shape = getattr(mesh, "shape", None)
    if shape is None or callable(shape):
        shape = mesh.devices.shape
    return dict(zip(names, (int(s) for s in shape)))


def axis_names(mesh: Any) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def data_axes(mesh: Any) -> Tuple[str, ...]:
    """The batch-parallel axes of a mesh ('pod' extends 'data')."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def small_mesh(data: int = 1, model: int = 1):
    """A reduced ("data", "model") mesh (tests)."""
    return fake_mesh((data, model), ("data", "model"))
