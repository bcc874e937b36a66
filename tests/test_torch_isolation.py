"""The port imports neither JAX nor anything of the JAX package: every
module on its main path imports in a fresh interpreter in which importing
``jax`` or ``repro`` raises."""

import os
import subprocess
import sys

import pytest

MODULES = [
    "repro_torch",
    "repro_torch.core",
    "repro_torch.core.executor",
    "repro_torch.core.runtime",
    "repro_torch.core.registry",
    "repro_torch.sim.metrics",
    "repro_torch.nn.layers",
    "repro_torch.kernels.build",
    "repro_torch.kernels.flash_attention.kernel",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.diffusion",
    "repro_torch.diffusion.ops",
    "repro_torch.diffusion.workflows",
    "repro_torch.weights",
]
# the multi-tenant LoRA path: the grouped and single-adapter kernels, the
# adapter utilities and the models' grouped forwards
LORA_MODULES = [
    "repro_torch.kernels.lora_matmul.kernel",
    "repro_torch.kernels.lora_matmul.ops",
    "repro_torch.kernels.lora_matmul.ref",
    "repro_torch.diffusion.lora",
    "repro_torch.diffusion.mmdit",
    "repro_torch.diffusion.encoders",
    "repro_torch.diffusion.ops",
]

# the quantized forward and the RG-LRU scan: both kernels' wrappers, plain
# versions and helpers, and the modules that quantize on load and fold
QUANT_MODULES = [
    "repro_torch.kernels.quant_matmul",
    "repro_torch.kernels.quant_matmul.kernel",
    "repro_torch.kernels.quant_matmul.ops",
    "repro_torch.kernels.quant_matmul.ref",
    "repro_torch.kernels.rglru_scan.kernel",
    "repro_torch.kernels.rglru_scan.ops",
    "repro_torch.kernels.rglru_scan.ref",
    "repro_torch.nn.layers",
    "repro_torch.diffusion.mmdit",
    "repro_torch.diffusion.encoders",
    "repro_torch.diffusion.lora",
    "repro_torch.weights",
]

# the serving launcher and the modules it and the simulation plane need:
# traces, the monolithic baseline, coordinator groups, the approximate
# cache and the back-compat shim
LAUNCH_MODULES = [
    "repro_torch.launch.serve",
    "repro_torch.sim.trace",
    "repro_torch.sim.monolithic",
    "repro_torch.core.group",
    "repro_torch.diffusion.cache",
    "repro_torch.diffusion.serving",
]

# the process plane: the frame transport and the supervisor whose spawned
# workers run the port's backend
PROC_MODULES = [
    "repro_torch.core.transport",
    "repro_torch.core.supervisor",
]

# the sharded plane: device slots and submeshes, the backend, and the
# sharded forwards of the diffusion models
MESH_MODULES = [
    "repro_torch.core.mesh",
    "repro_torch.core.executor",
    "repro_torch.diffusion.mmdit",
    "repro_torch.diffusion.sampler",
    "repro_torch.diffusion.ops",
]

# the LLM families' serving path: configs, the model stacks, their step
# builders and the primitives and kernels they call
LLM_MODULES = [
    "repro_torch.configs",
    "repro_torch.models",
    "repro_torch.models.base",
    "repro_torch.models.act_sharding",
    "repro_torch.models.api",
    "repro_torch.models.steps",
    "repro_torch.models.transformer",
    "repro_torch.models.hybrid",
    "repro_torch.models.ssm",
    "repro_torch.nn.layers",
    "repro_torch.kernels.rglru_scan.ops",
    "repro_torch.kernels.flash_attention.ops",
]

# the training path: the data pipeline, the optimizers, checkpoints, the
# loop and its launcher, the train step and both kernels' backward routes
TRAIN_MODULES = [
    "repro_torch.data",
    "repro_torch.data.pipeline",
    "repro_torch.train",
    "repro_torch.train.tree",
    "repro_torch.train.optimizer",
    "repro_torch.train.checkpoint",
    "repro_torch.train.loop",
    "repro_torch.launch.train",
    "repro_torch.models.steps",
    "repro_torch.kernels.flash_attention.kernel",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.rglru_scan.kernel",
    "repro_torch.kernels.rglru_scan.ops",
]

# the dry-run tools: the production meshes, the sharding rules, the cost
# counter, the dry runs of the LLM steps and of one MMDiT step, and the
# kernels' meta routes they trace
DRYRUN_MODULES = [
    "repro_torch.launch.mesh",
    "repro_torch.launch.sharding",
    "repro_torch.launch.op_cost",
    "repro_torch.launch.dryrun",
    "repro_torch.launch.dryrun_diffusion",
    "repro_torch.kernels.meta",
]

_PROBE = """
import importlib, sys

class Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Blocked())
for m in sys.argv[1:]:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok")
"""


def _src():
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")


@pytest.mark.parametrize("modules", [MODULES, LORA_MODULES, QUANT_MODULES,
                                     LAUNCH_MODULES, PROC_MODULES,
                                     MESH_MODULES, LLM_MODULES,
                                     TRAIN_MODULES, DRYRUN_MODULES],
                         ids=["main-path", "lora", "quant-rglru", "launch",
                              "proc", "mesh", "llm", "train", "dryrun"])
def test_port_imports_without_jax_or_repro(modules):
    env = dict(os.environ, PYTHONPATH=_src())
    out = subprocess.run([sys.executable, "-c", _PROBE, *modules], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_dry_run_traces_without_jax_or_repro():
    """A dry-run pair runs to its end with the JAX package unimportable."""
    code = _PROBE.replace('print("ok")', (
        "from repro_torch.launch.dryrun import run_pair\n"
        "r = run_pair('whisper-tiny', 'decode_32k', False)\n"
        "assert r['flops'] > 0 and r['collectives']['total'] > 0\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')"))
    env = dict(os.environ, PYTHONPATH=_src())
    out = subprocess.run([sys.executable, "-c", code,
                          "repro_torch.launch.dryrun"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_probe_blocks_the_jax_package():
    """The probe itself works: importing ``repro`` under it fails."""
    env = dict(os.environ, PYTHONPATH=_src())
    out = subprocess.run([sys.executable, "-c", _PROBE, "repro.core"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "blocked" in out.stderr


def test_chip_smoke_imports_neither_jax_nor_repro():
    """The script that drives the port on the card imports the port and
    torch, never JAX or the JAX package (read from its source: it exits
    where no card is present)."""
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).resolve().parents[1]
                      / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert "repro_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "repro"}


# an op whose forward reports the JAX and JAX-package modules its process
# holds; written to a module of its own so a spawned worker can import it
_MODULES_OP = """
import sys

from repro_torch.core.model import Model


class ModulesProbe(Model):
    def setup_io(self):
        self.add_output("modules", None)

    def execute(self, model_components, **kw):
        return {"modules": sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "repro"))}
"""


def test_spawned_worker_imports_neither_jax_nor_repro(tmp_path, monkeypatch):
    """A worker of the process plane, spawned from a process that holds
    JAX and the JAX package, serves an RPC without importing either."""
    from repro_torch.core import ProcBackend, ProcConfig, processes_available

    if not processes_available():
        pytest.skip("the host forbids spawning worker processes")
    import jax  # noqa: F401  (the parent holds JAX and the JAX package)
    import repro.core  # noqa: F401

    (tmp_path / "modules_probe_op.py").write_text(_MODULES_OP)
    monkeypatch.syspath_prepend(str(tmp_path))
    import modules_probe_op

    be = ProcBackend(ProcConfig(spawn_timeout=60.0, exec_wall_timeout=60.0),
                     device="cpu")
    try:
        outs, _, _ = be.execute_batch(modules_probe_op.ModulesProbe(), [{}],
                                      executor_id=0)
        assert be.workers[0].pid != os.getpid()
    finally:
        be.close()
    assert "jax" in sys.modules and "repro" in sys.modules
    assert outs == [{"modules": []}]
