"""The flash-decode over a sequence-sharded KV cache
(``repro_torch.models.transformer._flash_decode_shardmap``) against the
JAX package's, on the CPU.

* The function itself, on four CPU slots (a ``Submesh`` of four distinct
  ``torch.device("cpu")`` objects), against the reference's
  ``_flash_decode_shardmap`` on a (2, 2) mesh of forced host devices (one
  subprocess): the reference test's case (b 4, hq 8, hkv 2, hd 16, S 32,
  pos 13), a window, and ``pos`` on a shard's first and last slot.
  Outputs within 1e-4, the written caches bit-identical.
* A decode of ``ARCHS['llama3-8b'].reduced()`` with ``decode_shards``
  installed, through ``weights.py``'s carry-over, against the reference's
  unsharded decode at 1e-4 relative.  Against the port's unsharded cache,
  the sharded cache after the steps holds layer 0's K/V bit for bit and
  every slot no step wrote untouched; the deeper layers' written K/V agree
  within 1e-4, since their inputs carry the merged softmax's other
  summation order.
* The dry run's route: the same function in ``local_map`` on a fake
  (2, 2) ``DeviceMesh``, whose merges are functional all-reduces."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import get_family as jax_family
from repro.models import make_serve_step as jax_serve
from repro_torch.configs import ARCHS
from repro_torch.core.mesh import Submesh
from repro_torch.models import act_sharding, make_serve_step
from repro_torch.models.transformer import (_flash_decode_shardmap,
                                            gather_decode_cache,
                                            shard_decode_cache)
from repro_torch.weights import from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
B, HQ, HKV, HD, S = 4, 8, 2, 16, 32
# (pos, window): the reference test's case, a window, and pos on the first
# and last slot of a reference shard (16 slots) and of a port slot (8)
CASES = [(13, None), (13, 8), (16, None), (15, None), (8, None), (7, None),
         (31, 4), (0, None)]


def case_inputs():
    rng = np.random.default_rng(0)
    shapes = [(B, 1, HQ, HD), (B, 1, HKV, HD), (B, 1, HKV, HD),
              (B, S, HKV, HD), (B, S, HKV, HD)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


_REFERENCE = """
import os, json
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.models.transformer import _flash_decode_shardmap
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ('data', 'model'))
rng = np.random.default_rng(0)
shapes = [(B, 1, HQ, HD), (B, 1, HKV, HD), (B, 1, HKV, HD),
          (B, S, HKV, HD), (B, S, HKV, HD)]
args = [rng.standard_normal(s).astype(np.float32) for s in shapes]
out = {}
for pos, window in CASES:
    o, ck, cv = jax.jit(lambda *a: _flash_decode_shardmap(
        (mesh, 'model', 'data'), *a, window=window))(*args, jnp.asarray(pos))
    out[f'{pos}/{window}'] = [np.asarray(t).tolist() for t in (o, ck, cv)]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    code = (f"B, HQ, HKV, HD, S = {B}, {HQ}, {HKV}, {HD}, {S}\n"
            f"CASES = {CASES!r}\n" + textwrap.dedent(_REFERENCE))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def cpu_slots(k=4):
    return Submesh([torch.device("cpu") for _ in range(k)], range(k))


@pytest.mark.parametrize("pos,window", CASES)
def test_flash_decode_matches_the_reference(pos, window, reference):
    q, kn, vn, ck, cv = (torch.from_numpy(a) for a in case_inputs())
    mesh = cpu_slots()
    cks = [p.clone() for p in torch.chunk(ck, mesh.size, dim=1)]
    cvs = [p.clone() for p in torch.chunk(cv, mesh.size, dim=1)]
    out = _flash_decode_shardmap(mesh, q, kn, vn, cks, cvs, pos, window)
    want_out, want_ck, want_cv = (np.asarray(a, np.float32)
                                  for a in reference[f"{pos}/{window}"])
    assert out.shape == q.shape and out.dtype == q.dtype
    err = float((out - torch.from_numpy(want_out)).abs().max())
    assert err < TOL, err
    assert torch.equal(torch.cat(cks, dim=1), torch.from_numpy(want_ck))
    assert torch.equal(torch.cat(cvs, dim=1), torch.from_numpy(want_cv))
    # exactly one slot took the write
    changed = [not torch.equal(c, o) for c, o in
               zip(cks, torch.chunk(ck, mesh.size, dim=1))]
    assert sum(changed) == 1 and changed[pos // (S // mesh.size)]


def _rel(got, want, vocab):
    got = np.asarray(got, np.float64)[..., :vocab]
    want = np.asarray(want, np.float64)[..., :vocab]
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("slots", [2, 4])
def test_llama_decode_on_sharded_cache_matches_the_reference(slots):
    jcfg = JAX_ARCHS["llama3-8b"].reduced()
    cfg = ARCHS["llama3-8b"].reduced()
    jparams = jax_family(jcfg).init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    params = from_numpy(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(1)
    depth, start, steps = 32, 13, 4
    kv = [rng.standard_normal((cfg.n_layers, 2, depth, cfg.n_kv_heads,
                               cfg.head_dim)).astype(np.float32)
          for _ in range(2)]
    tokens = rng.integers(0, cfg.vocab, (steps, 2)).astype(np.int32)

    jcache = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1]),
              "pos": jnp.asarray(start, jnp.int32)}
    plain = {"k": torch.from_numpy(kv[0].copy()),
             "v": torch.from_numpy(kv[1].copy()), "pos": start}
    mesh = cpu_slots(slots)
    sharded = shard_decode_cache(plain, mesh)
    assert [p.shape[2] for p in sharded["k"]] == [depth // slots] * slots
    jstep, step = jax_serve(jcfg), make_serve_step(cfg)
    for i in range(steps):
        want, jcache = jstep(jparams, jcache, jnp.asarray(tokens[i]))
        tok = torch.from_numpy(tokens[i]).long()
        got_plain, plain = step(params, plain, tok)
        with act_sharding.activation_sharding(None, decode_shards=mesh):
            got, sharded = step(params, sharded, tok)
        assert sharded["pos"] == plain["pos"] == start + i + 1
        assert _rel(got.numpy(), np.asarray(want), cfg.vocab) < TOL, i
        assert _rel(got.numpy(), got_plain.numpy(), cfg.vocab) < TOL, i
    joined = gather_decode_cache(sharded, mesh)
    written = slice(start, start + steps)
    for name in ("k", "v"):
        got, want = joined[name], plain[name]
        # layer 0's K/V depend on the tokens alone: the same bits; deeper
        # layers' inputs carry the attention's other summation order
        assert torch.equal(got[0], want[0])
        assert _rel(got[:, :, written], want[:, :, written], None) < TOL
        # the slots no step wrote are untouched
        assert torch.equal(got[:, :, :start], want[:, :, :start])
        assert torch.equal(got[:, :, start + steps:],
                           want[:, :, start + steps:])
        assert _rel(got, np.asarray(jcache[name]), None) < TOL


def test_shard_decode_cache_round_trips():
    t = torch.arange(2 * 3 * 8 * 1 * 2, dtype=torch.float32).reshape(
        2, 3, 8, 1, 2)
    cache = {"k": t, "v": t + 1, "pos": 5}
    mesh = cpu_slots(4)
    parts = shard_decode_cache(cache, mesh)
    assert all(p.is_contiguous() and p.shape == (2, 3, 2, 1, 2)
               for p in parts["k"])
    parts["k"][0].zero_()                       # parts are copies
    assert t[:, :, :2].abs().sum() > 0
    back = gather_decode_cache(shard_decode_cache(cache, mesh), mesh)
    assert torch.equal(back["k"], t) and back["pos"] == 5
    with pytest.raises(ValueError, match="do not split"):
        shard_decode_cache(cache, cpu_slots(3))


def test_dry_run_route_on_a_fake_mesh():
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import dryrun, op_cost
    from repro_torch.launch.mesh import release, small_mesh

    mesh = small_mesh(2, 2)
    try:
        q, kn, vn, ck, cv = (torch.empty(a.shape, device="meta")
                             for a in case_inputs())
        rows, cache = ("data", None, None, None), ("data", "model", None,
                                                   None)
        args = [dryrun.distribute(t, s, mesh) for t, s in
                zip((q, kn, vn, ck, cv), (rows, rows, rows, cache, cache))]
        out, counter = op_cost.measure(
            _flash_decode_shardmap, (mesh, "model", "data"), *args, 13,
            None)
        assert isinstance(out, DTensor) and out.shape == q.shape
        # the max, then the two sums: [b, hkv, g, 1] f32 twice, then the
        # [b, 1, hkv, g, hd] products, per data shard
        bl, g = B // 2, HQ // HKV
        assert counter.collectives["all-reduce"] == 4 * (
            2 * bl * HKV * g + bl * HKV * g * HD)
        assert counter.flops == 2 * 2 * bl * HQ * (S // 2) * HD
    finally:
        release()
