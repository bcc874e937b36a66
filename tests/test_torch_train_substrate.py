"""The port's training substrate against the JAX package's, on the CPU:
the synthetic data pipeline (bit for bit), AdamW and Adafactor (ten steps
given the same gradients, within 1e-6 relative: both compute in f32, the
reductions in other orders), the schedule and the clipping, and the
checkpoints (round trip, keep-last-n, shape mismatch, the JAX package's
key paths, and a checkpoint written by the JAX package restored into the
port's template key for key, bit for bit)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import get_family as jax_family
from repro.train import adafactor_init as j_adafactor_init
from repro.train import adafactor_update as j_adafactor_update
from repro.train import adamw_init as j_adamw_init
from repro.train import adamw_update as j_adamw_update
from repro.train import save_checkpoint as j_save_checkpoint
from repro.train.checkpoint import _flatten as j_flatten
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import _schedule as j_schedule
from repro_torch.configs import ARCHS
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import get_family
from repro_torch.train import (
    AdafactorState,
    AdamWConfig,
    AdamWState,
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.checkpoint import _flatten
from repro_torch.train.optimizer import _schedule, global_norm
from repro_torch.train.tree import leaves, paths

OPT_REL = 1e-6

# ------------------------------------------------------------ data pipeline


@pytest.mark.parametrize("name", ["llama3-8b", "whisper-tiny", "internvl2-2b"])
@pytest.mark.parametrize("seed,shard,shards", [(0, 0, 1), (3, 1, 2),
                                               (11, 3, 4)])
def test_batches_equal_the_reference_bit_for_bit(name, seed, shard, shards):
    cfg = ARCHS[name].reduced()
    kw = dict(batch_size=4, seq_len=24, seed=seed, shard_index=shard,
              shard_count=shards)
    ours = iter(SyntheticLM(cfg, DataConfig(**kw)))
    ref = iter(JSyntheticLM(JAX_ARCHS[name].reduced(), JDataConfig(**kw)))
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert sorted(a) == sorted(b)
        assert ("frames" in a) == cfg.is_encoder_decoder
        assert ("patches" in a) == bool(cfg.frontend_tokens)
        for key in a:
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key])
        assert a["tokens"].shape == (4 // shards, 24)


def test_shards_draw_different_streams():
    cfg = ARCHS["llama3-8b"].reduced()
    first = [next(iter(SyntheticLM(cfg, DataConfig(
        batch_size=4, seq_len=16, shard_index=i, shard_count=2))))["tokens"]
        for i in range(2)]
    assert not np.array_equal(*first)


# ---------------------------------------------------------------- optimizer

def _trees(seed=0):
    """A parameter tree with 1-D, 2-D and 3-D leaves (numpy), and ten
    gradient trees of the same shape."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (12, 8), "norm": (8,), "blocks": {"wq": (2, 8, 6),
                                                         "scale": (2, 6)}}

    def draw(s, mag=1.0):
        if isinstance(s, dict):
            return {k: draw(v, mag) for k, v in s.items()}
        return (mag * rng.standard_normal(s)).astype(np.float32)

    return draw(shapes), [draw(shapes, 0.05 + 0.3 * i) for i in range(10)]


def _t(tree):
    """Tensors of copies: the port's updates write in place."""
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.abs(want).max()
    return np.abs(got - want).max() / (den if den else 1.0)


def _close_trees(got, want, rel):
    flat = dict(paths(want))
    for key, leaf in paths(got):
        assert _rel(leaf.numpy(), flat[key]) <= rel, key


CONFIGS = [
    AdamWConfig(),                                   # warm-up, clipping at 1
    AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8, grad_clip=1e6,
                weight_decay=0.3),                  # cosine, no clipping
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=["warmup-clip", "cosine"])
@pytest.mark.parametrize("which", ["adamw", "adafactor"])
def test_optimizer_ten_steps_match_the_reference(cfg, which):
    params, grads = _trees()
    jcfg = JAdamWConfig(**dataclasses.asdict(cfg))
    j_init, j_update = ((j_adamw_init, j_adamw_update) if which == "adamw"
                        else (j_adafactor_init, j_adafactor_update))
    init, update = ((adamw_init, adamw_update) if which == "adamw"
                    else (adafactor_init, adafactor_update))
    jp, tp = _j(params), _t(params)
    js, ts = j_init(jp), init(tp)
    for g in grads:
        jp, js, jm = jax.jit(j_update, static_argnums=0)(jcfg, jp, _j(g), js)
        tp, ts, tm = update(cfg, tp, _t(g), ts)
        for k in jm:
            assert _rel(tm[k].numpy(), jm[k]) <= OPT_REL, k
    _close_trees(tp, jax.tree.map(np.asarray, jp), OPT_REL)
    fields = ("mu", "nu") if which == "adamw" else ("vr", "vc")
    for f in fields:
        _close_trees(getattr(ts, f), jax.tree.map(np.asarray, getattr(js, f)),
                     OPT_REL)
    assert int(ts.step) == int(js.step) == len(grads)
    assert ts.step.dtype == torch.int32


def test_schedule_matches_the_reference():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = JAdamWConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        got = _schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = j_schedule(jcfg, jnp.int32(step))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-7 * abs(float(want)), step


def test_adamw_clips_by_the_global_norm():
    """Gradients 100x over the clip: the first step's moments are those of
    the clipped gradients (norm ``grad_clip``), and the reported norm is
    the raw one."""
    params, grads = _trees(1)
    big = jax.tree.map(lambda g: 100.0 * g, grads[3])
    cfg = AdamWConfig(grad_clip=0.5)
    _, state, m = adamw_update(cfg, _t(params), _t(big), adamw_init(_t(params)))
    raw = float(global_norm(_t(big)))
    assert abs(float(m["grad_norm"]) - raw) <= 1e-6 * raw
    clipped = float(global_norm(state.mu)) / (1 - cfg.b1)
    assert abs(clipped - cfg.grad_clip) <= 1e-5
    # an unclipped step keeps the gradient's own norm
    small = jax.tree.map(lambda g: 1e-3 * g, grads[0])
    _, state, _ = adamw_update(cfg, _t(params), _t(small),
                               adamw_init(_t(params)))
    assert abs(float(global_norm(state.mu)) / (1 - cfg.b1)
               - float(global_norm(_t(small)))) <= 1e-6


def test_adamw_decays_matrices_only():
    """Zero gradients: the update is the weight decay alone, on leaves of
    two or more dimensions."""
    params, _ = _trees(2)
    zero = jax.tree.map(np.zeros_like, params)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1)
    out, _, _ = adamw_update(cfg, _t(params), _t(zero),
                             adamw_init(_t(params)))
    np.testing.assert_array_equal(out["norm"].numpy(), params["norm"])
    assert not np.array_equal(out["embed"].numpy(), params["embed"])
    np.testing.assert_allclose(out["embed"].numpy(),
                               params["embed"] * (1 - 1e-2 * 0.1), rtol=1e-6)


def test_states_have_the_reference_fields():
    assert AdamWState._fields == ("step", "mu", "nu")
    assert AdafactorState._fields == ("step", "vr", "vc")
    params, _ = _trees()
    s = adafactor_init(_t(params))
    js = j_adafactor_init(_j(params))
    for ours, ref in ((s.vr, js.vr), (s.vc, js.vc)):
        flat = dict(paths(jax.tree.map(np.asarray, ref)))
        for key, leaf in paths(ours):
            assert tuple(leaf.shape) == flat[key].shape, key


# -------------------------------------------------------------- checkpoints

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.int32)},
            "h": torch.randn(3, generator=torch.Generator().manual_seed(0)
                             ).to(torch.bfloat16)}
    save_checkpoint(str(tmp_path), 7, tree)
    assert latest_step(str(tmp_path)) == 7
    restored, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 7
    for key, leaf in paths(tree):
        got = dict(paths(restored))[key]
        assert got.dtype == leaf.dtype and torch.equal(got, leaf), key


def test_checkpoint_keeps_last_n(tmp_path):
    tree = {"a": torch.zeros((2,))}
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, tree, keep=2)
    assert latest_step(str(tmp_path)) == 5
    assert len([d for d in os.listdir(tmp_path) if d.startswith("step_")]) == 2
    assert latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "absent"), tree)


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros((2,))})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros((3,))})


def _init_pair(name):
    cfg = ARCHS[name].reduced()
    jparams = jax_family(JAX_ARCHS[name].reduced()).init(
        jax.random.PRNGKey(0), JAX_ARCHS[name].reduced())
    tparams = get_family(cfg).init(torch.Generator("cpu").manual_seed(0), cfg,
                                   device="cpu")
    return jparams, tparams


@pytest.mark.parametrize("name,which", [("recurrentgemma-2b", "adamw"),
                                        ("whisper-tiny", "adafactor"),
                                        ("xlstm-1.3b", "adamw")])
def test_reference_checkpoint_restores_into_the_port(tmp_path, name, which):
    """Key paths equal the JAX package's (``0/embed``, ``1/mu/...``,
    ``1/step``, ``1/vr/...``), and the JAX package's checkpoint of
    (params, optimizer state) restores into the port's template key for
    key, bit for bit."""
    jparams, tparams = _init_pair(name)
    j_init, init = ((j_adamw_init, adamw_init) if which == "adamw"
                    else (j_adafactor_init, adafactor_init))
    jtree = (jparams, j_init(jparams))
    ttree = (tparams, init(tparams))
    jflat = j_flatten(jtree)
    assert sorted(_flatten(ttree)) == sorted(jflat)
    assert "0/embed" in jflat and "1/step" in jflat
    assert ("1/mu/embed" if which == "adamw" else "1/vr/embed") in jflat
    j_save_checkpoint(str(tmp_path), 4, jtree)
    (params, state), step = restore_checkpoint(str(tmp_path), ttree)
    assert step == 4
    got = dict(paths((params, state)))
    assert sorted(got) == sorted(jflat)
    for key, want in jflat.items():
        assert got[key].dtype == dict(paths(ttree))[key].dtype, key
        np.testing.assert_array_equal(got[key].numpy(), want, err_msg=key)
    assert isinstance(state, AdamWState if which == "adamw" else AdafactorState)
    assert len(leaves(params)) == len(leaves(tparams))
