"""Activation-sharding hooks.

The model stacks hand every residual-stream boundary tensor ``[B, S, d]``
to :func:`constrain`, and the MoE dispatch buffers to
:func:`constrain_moe`.  Both are identities unless a caller installs a
hook with :func:`activation_sharding`; the dry run
(:mod:`repro_torch.launch.dryrun`) installs ``DTensor.redistribute`` to
its activation layouts there, as the JAX package's installs
``with_sharding_constraint``.  ``moe_groups`` splits MoE routing into
group-local dispatches (GShard's grouping); ``decode_shards`` names the
sequence-sharded KV cache of the flash-decode route
(:func:`repro_torch.models.transformer._flash_decode_shardmap`): a
:class:`~repro_torch.core.mesh.Submesh` whose slots hold the cache's
parts, or the dry run's ``(DeviceMesh, axis, dp)``; ``remat_context``
gives a rematerialised layer's recomputation the context its forward ran
in (the dry run's layout mode).

Kept as module-level hooks so model code stays mesh-agnostic.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional

_HOOK: Optional[Callable[[Any], Any]] = None
_MOE_HOOK: Optional[Callable[[Any, str], Any]] = None
_MOE_GROUPS: int = 1
_DECODE_SHARDS: Optional[Any] = None
# a context-manager factory for a rematerialised layer's recomputation,
# which runs in the backward, outside the modes its forward ran under
_REMAT_CONTEXT: Optional[Callable[[], Any]] = None


def moe_groups() -> int:
    return _MOE_GROUPS


def decode_shards() -> Optional[Any]:
    return _DECODE_SHARDS


def remat_context() -> Optional[Callable[[], Any]]:
    return _REMAT_CONTEXT


def set_hook(fn: Optional[Callable[[Any], Any]]) -> None:
    global _HOOK
    _HOOK = fn


def constrain(x: Any) -> Any:
    if _HOOK is not None and getattr(x, "ndim", 0) == 3:
        return _HOOK(x)
    return x


def constrain_moe(x: Any, role: str) -> Any:
    """Constrain MoE dispatch buffers: role in {dispatch, hidden, out}."""
    if _MOE_HOOK is not None:
        return _MOE_HOOK(x, role)
    return x


@contextlib.contextmanager
def activation_sharding(fn: Optional[Callable[[Any], Any]],
                        moe_fn: Optional[Callable[[Any, str], Any]] = None,
                        moe_groups: int = 1,
                        decode_shards: Optional[Any] = None,
                        remat_context: Optional[Callable[[], Any]] = None):
    global _HOOK, _MOE_HOOK, _MOE_GROUPS, _DECODE_SHARDS, _REMAT_CONTEXT
    prev = (_HOOK, _MOE_HOOK, _MOE_GROUPS, _DECODE_SHARDS, _REMAT_CONTEXT)
    _HOOK, _MOE_HOOK, _MOE_GROUPS, _DECODE_SHARDS, _REMAT_CONTEXT = (
        fn, moe_fn, moe_groups, decode_shards, remat_context)
    try:
        yield
    finally:
        (_HOOK, _MOE_HOOK, _MOE_GROUPS, _DECODE_SHARDS,
         _REMAT_CONTEXT) = prev
