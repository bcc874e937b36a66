"""Activation-sharding hooks.

The model stacks hand every residual-stream boundary tensor ``[B, S, d]``
to :func:`constrain`, and the MoE dispatch buffers to
:func:`constrain_moe`.  Both are identities unless a caller installs a
hook with :func:`activation_sharding`; the JAX package's dry-run tools
install ``with_sharding_constraint`` there, and the port's counterparts of
those tools will install theirs.  ``moe_groups`` splits MoE routing into
group-local dispatches (GShard's grouping); ``decode_shards`` names the
sequence-sharded KV cache of the flash-decode route, which the port does
not run yet (:func:`repro_torch.models.transformer.decode_step` refuses
it).

Kept as module-level hooks so model code stays mesh-agnostic.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional

_HOOK: Optional[Callable[[Any], Any]] = None
_MOE_HOOK: Optional[Callable[[Any, str], Any]] = None
_MOE_GROUPS: int = 1
_DECODE_SHARDS: Optional[Any] = None


def moe_groups() -> int:
    return _MOE_GROUPS


def decode_shards() -> Optional[Any]:
    return _DECODE_SHARDS


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
                        decode_shards: Optional[Any] = None):
    global _HOOK, _MOE_HOOK, _MOE_GROUPS, _DECODE_SHARDS
    prev = (_HOOK, _MOE_HOOK, _MOE_GROUPS, _DECODE_SHARDS)
    _HOOK, _MOE_HOOK, _MOE_GROUPS, _DECODE_SHARDS = (
        fn, moe_fn, moe_groups, decode_shards)
    try:
        yield
    finally:
        _HOOK, _MOE_HOOK, _MOE_GROUPS, _DECODE_SHARDS = prev
