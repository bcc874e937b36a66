"""Sharding rules for every architecture family x step kind, the
counterpart of ``repro.launch.sharding``.

A spec is a :class:`P`: a tuple with one entry per tensor dimension, each
an axis name, a tuple of axis names or ``None`` (the JAX package's
``PartitionSpec``).  The functions map the port's parameter, optimizer
state, batch and cache trees to trees of specs of the same structure,
leaf by leaf, keyed by the same leaf paths as the JAX package's.

Conventions:

* weights: last ("output") dim over ``model``; for FSDP-scale archs the
  other matrix dim additionally over ``data`` (gathered at use, ZeRO-3
  style);
* projections back into the residual stream (``wo``/``*down``) have their
  *contraction* dim model-sharded instead, giving the Megatron pairing (no
  resharding between the two halves of a block);
* embeddings vocab-sharded over ``model``;
* batch over ``(pod, data)``; decode KV caches sequence-sharded over
  ``model`` (kv_heads=8 < model=16 rules out head sharding);
* MoE experts over ``model`` when divisible (granite 32e), else
  tensor-parallel within every expert (grok 8e over a 16-way axis);
* norms/scalars replicated.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.base import ArchConfig

# leaf names whose LAST dim feeds the residual stream (contraction dim is
# the sharded one)
_DOWN_NAMES = ("wo", "w_down", "moe_down", "mlp_down", "w_out", "cwo",
               "dec_out")
# leaf names that are never sharded
_REPLICATED = ("norm", "lam", "ada_b", "final_ada_b", "pos")
# the production sizes of the batch axes (the JAX package's rules read
# them as constants, whatever the mesh)
_DP_SIZES = {"pod": 2, "data": 16}


class P(tuple):
    """A partition spec: ``P("model", None)``, ``P(("pod", "data"))``."""

    def __new__(cls, *axes: Any) -> "P":
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def is_spec(x: Any) -> bool:
    return isinstance(x, P)


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def map_with_path(fn: Callable[[Tuple[str, ...], Any], Any], tree: Any,
                  *rest: Any, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf, *other_leaves)`` over every leaf of ``tree`` (specs
    are leaves), the other trees walked in step; the result keeps
    ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 path=path + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(
            map_with_path(fn, v, *(getattr(r, f) for r in rest),
                          path=path + (f,))
            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)) and not is_spec(tree):
        return type(tree)(map_with_path(fn, v, *(r[i] for r in rest),
                                        path=path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in :func:`map_with_path`'s order."""
    out: list = []
    map_with_path(lambda _, leaf: out.append(leaf), tree)
    return out


def _ndim(leaf: Any) -> int:
    return len(getattr(leaf, "shape", ()))


def _matrix_spec(name: str, stack_dims: int, fsdp: bool) -> P:
    """Spec for a [*stack, d_in, d_out]-shaped weight."""
    lead = (None,) * stack_dims
    other = "data" if fsdp else None
    if any(k in name for k in _DOWN_NAMES):
        return P(*lead, "model", other)
    return P(*lead, other, "model")


def param_specs(cfg: ArchConfig, params: Any, fsdp: bool = False) -> Any:
    """Spec tree matching ``params`` (tensors, meta tensors or anything
    with a ``shape``)."""
    data = "data" if fsdp else None

    def spec_for(path, leaf) -> P:
        name = path[-1] if path else ""
        ndim = _ndim(leaf)
        if any(k in name for k in _REPLICATED) or ndim <= 1:
            return P()
        if name == "embed":
            return P("model", data)
        if name == "lm_head":
            return P(data, "model")
        if name == "projector":
            return P(None, "model")
        if name == "conv":                       # [*, W, d]
            return P(*(None,) * (ndim - 1), "model")
        if name == "router":                     # [L, d, E]: tiny
            return P()
        if name.startswith("moe_"):              # [L, E, din, dout]
            if cfg.n_experts % 16 == 0:
                return P(None, "model", data, None)
            # experts not divisible by the model axis: TP within experts
            if "down" in name:
                return P(None, None, "model", data)
            return P(None, None, data, "model")
        return _matrix_spec(name, ndim - 2, fsdp)

    return map_with_path(spec_for, params)


def opt_state_specs(pspecs: Any) -> Any:
    """AdamW state mirrors the parameter sharding (ZeRO: moments live with
    their shards)."""
    from repro_torch.train.optimizer import AdamWState

    return AdamWState(step=P(), mu=pspecs, nu=pspecs)


def _dp(mesh_axes: Tuple[str, ...]) -> Any:
    dp = tuple(a for a in mesh_axes if a in ("pod", "data"))
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def _n_dp(mesh_axes: Tuple[str, ...]) -> int:
    n = 1
    for a in mesh_axes:
        n *= _DP_SIZES.get(a, 1)
    return n


def batch_specs(cfg: ArchConfig, mesh_axes: Tuple[str, ...],
                kind: str) -> Dict[str, P]:
    dp = _dp(mesh_axes)
    out = {"tokens": P(dp, None), "labels": P(dp, None)}
    if cfg.is_encoder_decoder:
        out["frames"] = P(dp, None, None)
    if cfg.frontend_tokens:
        out["patches"] = P(dp, None, None)
    if kind != "train":
        out.pop("labels")
    return out


def cache_specs(cfg: ArchConfig, mesh_axes: Tuple[str, ...],
                batch: int, cache: Any) -> Any:
    """Sharding for decode caches/states (family-dependent trees)."""
    # long_500k has batch 1: the batch axis is replicated
    dp = _dp(mesh_axes)
    if dp is not None and batch % _n_dp(mesh_axes) != 0:
        dp = None
    by_name = {
        "k": P(None, dp, "model", None, None),        # [L, B, S, kv, hd]
        "v": P(None, dp, "model", None, None),
        "ak": P(None, None, dp, "model", None, None),  # [S, 1, B, W, kv, hd]
        "av": P(None, None, dp, "model", None, None),
        "enc_out": P(dp, None, "model"),              # [B, enc_seq, d]
        "C": P(None, None, dp, None, "model", None),  # [S, M, B, H, dk, dv]
        "C_rem": P(None, dp, None, "model", None),
        "n": P(None, None, dp, None, "model"),        # [S, M, B, H, dk]
        "n_rem": P(None, dp, None, "model"),
        "c_s": P(None, dp, "model"),                  # [S, B, d]
        "h": P(None, None, dp, "model"),              # hybrid [S, 2, B, d]
        "h_rem": P(None, dp, "model"),
        "tail": P(None, None, dp, None, "model"),     # [S, 2, B, W-1, d]
        "tail_rem": P(None, dp, None, "model"),
    }
    return map_with_path(
        lambda path, leaf: by_name.get(path[-1] if path else "", P()), cache)


def token_spec(cfg: ArchConfig, mesh_axes: Tuple[str, ...], batch: int) -> P:
    if batch % max(1, _n_dp(mesh_axes)) != 0:
        return P(None)
    return P(_dp(mesh_axes))


def sanitize(spec_tree: Any, shape_tree: Any, mesh: Any) -> Any:
    """Drop axis assignments that do not evenly divide the dimension:
    argument shardings must divide exactly."""
    sizes = axis_sizes(mesh)

    def fix(path, spec, leaf):
        if not is_spec(spec):
            return spec
        dims = tuple(getattr(leaf, "shape", ()))
        new = []
        for i, a in enumerate(spec):
            if a is None or i >= len(dims):
                new.append(None)
                continue
            need = 1
            for x in (a if isinstance(a, tuple) else (a,)):
                need *= sizes[x]
            new.append(a if dims[i] % need == 0 else None)
        return P(*new)

    return map_with_path(fix, spec_tree, shape_tree)


def needs_fsdp(cfg: ArchConfig, kind: str) -> bool:
    """FSDP when replicated weights (+moments for train) would not fit."""
    per_model_shard = cfg.param_count() / 16.0
    if kind == "train":
        # bf16 params+grads (2+2) and fp32 moments (8) per parameter
        return per_model_shard * 12.0 > 8e9
    # serve: weights beyond ~2 GiB/shard leave too little HBM for the
    # 32k KV caches -> ZeRO-inference style gather-on-use
    return per_model_shard * 2.0 > 2e9


def adafactor_specs(pspecs: Any) -> Any:
    """Adafactor row/col stats: drop the reduced dim from the param spec."""
    from repro_torch.train.optimizer import AdafactorState

    def row(_, spec):
        if not is_spec(spec) or len(spec) < 2:
            return spec if is_spec(spec) else P()
        return P(*spec[:-1])

    def col(_, spec):
        if not is_spec(spec) or len(spec) < 2:
            return P()
        return P(*spec[:-2], spec[-1])

    return AdafactorState(step=P(), vr=map_with_path(row, pspecs),
                          vc=map_with_path(col, pspecs))
