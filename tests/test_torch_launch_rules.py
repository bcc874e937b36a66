"""The port's dry-run building blocks against the JAX package's, on the
CPU: the production meshes (``repro_torch.launch.mesh``), the sharding
rules leaf by leaf for all ten ``ARCHS`` configs at full size
(``repro_torch.launch.sharding``; every spec must be equal, entry for
entry, to the reference's ``PartitionSpec``), the dry run's
gradient-accumulation policy and input stand-ins (exact), and the
per-partition cost counter (``repro_torch.launch.op_cost``).

The meshes are ``DeviceMesh`` es over a fake process group, which is
global to the process: each test that makes one tears it down after."""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as JAX_ARCHS
from repro.launch import dryrun as jdry
from repro.launch import sharding as jshd
from repro.models import get_family as jax_family
from repro.models.base import INPUT_SHAPES as JAX_SHAPES
from repro.train.optimizer import adafactor_init as jax_adafactor_init
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch.configs import ARCHS
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import op_cost
from repro_torch.launch import sharding as tshd
from repro_torch.models import get_family
from repro_torch.models.base import INPUT_SHAPES
from repro_torch.train.optimizer import adafactor_init, adamw_init

NAMES = list(ARCHS)
MESH_AXES = [("data", "model"), ("pod", "data", "model")]
MESH_SIZES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]


@pytest.fixture
def fake_group():
    yield
    tmesh.release()


class _JaxMesh:
    """The attributes ``repro.launch.sharding.sanitize`` reads."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)

        class devices:
            shape = tuple(sizes.values())

        self.devices = devices


def _key(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def jax_specs(tree) -> dict:
    """``{leaf path: spec tuple}`` of a JAX spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(_key(k) for k in path): tuple(spec)
            for path, spec in flat}


def port_specs(tree) -> dict:
    out = {}
    tshd.map_with_path(lambda path, s: out.__setitem__("/".join(path),
                                                       tuple(s)), tree)
    return out


@functools.lru_cache(maxsize=None)
def jax_params(name):
    cfg = JAX_ARCHS[name]
    return jax.eval_shape(lambda k: jax_family(cfg).init(k, cfg, jnp.bfloat16),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def port_params(name):
    cfg = ARCHS[name]
    return tdry.meta_tree(get_family(cfg).init, torch.Generator(), cfg,
                          torch.bfloat16, device="cpu")


def test_configs_agree():
    import dataclasses
    assert list(JAX_ARCHS) == NAMES
    for name in NAMES:
        assert (dataclasses.asdict(JAX_ARCHS[name])
                == dataclasses.asdict(ARCHS[name])), name


# ------------------------------------------------------------------ mesh


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shapes(multi_pod, fake_group):
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    assert tmesh.axis_sizes(mesh) == want
    assert mesh.mesh_dim_names == tuple(want)
    assert mesh.size() == (512 if multi_pod else 256)
    assert tmesh.data_axes(mesh) == (("pod", "data") if multi_pod
                                     else ("data",))
    assert torch.distributed.get_world_size() == mesh.size()


def test_meshes_of_other_sizes_replace_the_fake_group(fake_group):
    a = tmesh.small_mesh(2, 4)
    assert tmesh.axis_sizes(a) == {"data": 2, "model": 4}
    assert tmesh.data_axes(a) == ("data",)
    b = tmesh.small_mesh(1, 1)
    assert tmesh.axis_sizes(b) == {"data": 1, "model": 1}
    assert torch.distributed.get_world_size() == 1
    tmesh.release()
    assert not torch.distributed.is_initialized()


def test_data_axes_and_sizes_of_plain_descriptions():
    assert tmesh.data_axes(_JaxMesh(MESH_SIZES[1])) == ("pod", "data")
    assert tmesh.axis_sizes(MESH_SIZES[0]) == {"data": 16, "model": 16}


# -------------------------------------------------------------- sharding


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_param_specs_equal_the_reference(name, fsdp):
    want = jax_specs(jshd.param_specs(JAX_ARCHS[name], jax_params(name),
                                      fsdp=fsdp))
    got = port_specs(tshd.param_specs(ARCHS[name], port_params(name),
                                      fsdp=fsdp))
    assert got == want


@pytest.mark.parametrize("sizes", MESH_SIZES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("name", NAMES)
def test_sanitized_specs_equal_the_reference(name, sizes):
    jspecs = jshd.param_specs(JAX_ARCHS[name], jax_params(name), fsdp=True)
    tspecs = tshd.param_specs(ARCHS[name], port_params(name), fsdp=True)
    want = jax_specs(jshd.sanitize(jspecs, jax_params(name), _JaxMesh(sizes)))
    got = port_specs(tshd.sanitize(tspecs, port_params(name), sizes))
    assert got == want


@pytest.mark.parametrize("name", NAMES)
def test_optimizer_state_specs_equal_the_reference(name):
    jp = jshd.param_specs(JAX_ARCHS[name], jax_params(name))
    tp = tshd.param_specs(ARCHS[name], port_params(name))
    assert (port_specs(tshd.opt_state_specs(tp))
            == jax_specs(jshd.opt_state_specs(jp)))
    assert (port_specs(tshd.adafactor_specs(tp))
            == jax_specs(jshd.adafactor_specs(jp)))
    # the state trees the specs describe have the same leaves
    j_ada = jax.eval_shape(jax_adafactor_init, jax_params(name))
    t_ada = adafactor_init(port_params(name))
    j_adamw = jax.eval_shape(jax_adamw_init, jax_params(name))
    t_adamw = adamw_init(port_params(name))
    sizes = MESH_SIZES[0]
    assert (port_specs(tshd.sanitize(tshd.adafactor_specs(tp), t_ada, sizes))
            == jax_specs(jshd.sanitize(jshd.adafactor_specs(jp), j_ada,
                                       _JaxMesh(sizes))))
    assert (port_specs(tshd.sanitize(tshd.opt_state_specs(tp), t_adamw, sizes))
            == jax_specs(jshd.sanitize(jshd.opt_state_specs(jp), j_adamw,
                                       _JaxMesh(sizes))))


@pytest.mark.parametrize("axes", MESH_AXES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("name", NAMES)
def test_batch_and_token_specs_equal_the_reference(name, axes):
    for kind in ("train", "prefill", "decode"):
        assert ({k: tuple(v) for k, v in
                 tshd.batch_specs(ARCHS[name], axes, kind).items()}
                == {k: tuple(v) for k, v in
                    jshd.batch_specs(JAX_ARCHS[name], axes, kind).items()})
    for batch in (1, 16, 32, 128, 256):
        assert (tuple(tshd.token_spec(ARCHS[name], axes, batch))
                == tuple(jshd.token_spec(JAX_ARCHS[name], axes, batch)))


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_equal_the_reference(name, shape_name):
    jcfg, tcfg = JAX_ARCHS[name], ARCHS[name]
    shape = INPUT_SHAPES[shape_name]
    ring = shape_name == "long_500k" and tcfg.arch_type not in ("ssm",
                                                                "hybrid")
    jcache = jax.eval_shape(lambda: jax_family(jcfg).init_decode_cache(
        jcfg, shape.global_batch, shape.seq_len, dtype=jnp.bfloat16,
        ring=ring, window=8192))
    tcache = tdry.meta_tree(get_family(tcfg).init_decode_cache, tcfg,
                            shape.global_batch, shape.seq_len,
                            dtype=torch.bfloat16, ring=ring, window=8192,
                            device="cpu")
    for axes, sizes in zip(MESH_AXES, MESH_SIZES):
        want = jshd.cache_specs(jcfg, axes, shape.global_batch, jcache)
        got = tshd.cache_specs(tcfg, axes, shape.global_batch, tcache)
        assert port_specs(got) == jax_specs(want)
        assert (port_specs(tshd.sanitize(got, tcache, sizes))
                == jax_specs(jshd.sanitize(want, jcache, _JaxMesh(sizes))))


def test_needs_fsdp_equals_the_reference():
    for name in NAMES:
        for kind in ("train", "prefill", "decode"):
            assert (tshd.needs_fsdp(ARCHS[name], kind)
                    == jshd.needs_fsdp(JAX_ARCHS[name], kind)), (name, kind)


def test_sanitize_drops_what_does_not_divide():
    leaf = torch.empty((51865, 384), device="meta")
    assert tshd.sanitize(tshd.P("model", None), leaf,
                         MESH_SIZES[0]) == tshd.P(None, None)
    leaf = torch.empty((51968, 384), device="meta")
    assert tshd.sanitize(tshd.P("model", None), leaf,
                         MESH_SIZES[0]) == tshd.P("model", None)
    leaf = torch.empty((16, 4096), device="meta")
    assert tshd.sanitize(tshd.P(("pod", "data"), None), leaf,
                         MESH_SIZES[1]) == tshd.P(None, None)


# ------------------------------------------------------- policy and inputs


@pytest.mark.parametrize("multi_pod", [False, True])
def test_accum_steps_equal_the_reference(multi_pod):
    for name in NAMES:
        for sname, shape in INPUT_SHAPES.items():
            if shape.kind != "train":
                continue
            got = tdry.accum_steps_for(ARCHS[name], shape, multi_pod)
            assert got == jdry.accum_steps_for(JAX_ARCHS[name],
                                               JAX_SHAPES[sname], multi_pod)
            assert shape.global_batch % got == 0


def test_input_specs_equal_the_reference():
    for name in NAMES:
        for sname in INPUT_SHAPES:
            want = jdry.input_specs(JAX_ARCHS[name], JAX_SHAPES[sname])
            got = tdry.input_specs(ARCHS[name], INPUT_SHAPES[sname])
            assert set(got) == set(want), (name, sname)
            for k in want:
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert str(got[k].dtype).split(".")[-1] == str(
                    want[k].dtype), (name, sname, k)
                assert got[k].device.type == "meta"


# ------------------------------------------------------------ cost counter


def test_a_python_loop_of_products_counts_once_per_trip():
    a = torch.empty((8, 16), device="meta")
    b = torch.empty((16, 4), device="meta")

    def loop():
        out = a @ b
        for _ in range(6):
            out = out + a @ b
        return out

    costs = op_cost.dynamic_costs(loop)
    assert costs["flops"] == 7 * 2 * 8 * 16 * 4
    assert costs["collectives"] == {"total": 0}
    # bytes: 7 products and 6 sums, each reading its operands once and
    # writing its output once
    assert costs["bytes"] == (7 * (8 * 16 + 16 * 4 + 8 * 4) * 4
                              + 6 * 3 * 8 * 4 * 4)


def test_collectives_count_each_call(fake_group):
    import torch.distributed._functional_collectives as funcol

    mesh = tmesh.fake_mesh((4,), ("x",))

    def step():
        g = funcol.all_gather_tensor(torch.ones(2), 0, (mesh, 0))
        r = torch.ones(4)
        for _ in range(7):
            r = funcol.all_reduce(r, "sum", (mesh, 0))
        return funcol.wait_tensor(g), funcol.wait_tensor(r)

    coll = op_cost.collective_bytes(step)
    # the JAX package's test_collective_parser_counts_loop_trips: one
    # f32[8] all-gather and seven f32[4] all-reduces
    assert coll["all-gather"] == 32.0
    assert coll["all-reduce"] == 7 * 16.0
    assert coll["total"] == 32.0 + 112.0


def test_flash_attention_meta_route_counts_its_products():
    from repro_torch.kernels.flash_attention import kernel

    q = torch.empty((6, 128, 64), device="meta")
    before = kernel.flash_attention.launches
    counter = op_cost.OpCost()
    with counter:
        out, lse = kernel.flash_attention(q, q, q, return_lse=True)
        kernel.flash_attention_bwd(q, q, q, out, lse, out)
    assert out.shape == q.shape and out.device.type == "meta"
    assert lse.shape == (6, 128) and lse.dtype == torch.float32
    assert counter.flops == (4 + 10) * 6 * 128 * 128 * 64
    assert kernel.flash_attention.launches == before


def test_rglru_meta_route_is_elementwise():
    from repro_torch.kernels.rglru_scan import kernel

    a = torch.empty((2, 64, 32), device="meta")
    before = kernel.rglru_scan.launches
    counter = op_cost.OpCost()
    with counter:
        h = kernel.rglru_scan(a, a)
        da, dx = kernel.rglru_scan_bwd(a, a, h, h)
    assert h.shape == da.shape == dx.shape == a.shape
    assert counter.flops == 0 and kernel.rglru_scan.launches == before
    with pytest.raises(RuntimeError, match="meta tensors only"):
        from repro_torch.kernels import meta
        meta.rglru_scan(torch.ones(1, 2, 2), torch.ones(1, 2, 2))
