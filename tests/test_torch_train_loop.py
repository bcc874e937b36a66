"""The port's training loop and launcher on the CPU, against the JAX
package's.

The JAX package writes a step-0 checkpoint of its own parameters and
AdamW state (``save_checkpoint(dir, 0, (params, adamw_init(params)))``);
each package's ``train()`` restores it from its own copy of the directory
and takes 3 steps on the same synthetic batches: the losses agree within
1e-4 relative (f32 with other summation orders; 3 steps at lr of order
1e-6 keep the trajectories together), and a checkpoint the port writes
restores into the JAX package's template.  A resumed run (a checkpoint
after step 2, a fresh ``train()`` for step 3) ends with the uninterrupted
run's parameters bit for bit.  The launcher runs with ``--device cpu``.
"""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.data import DataConfig as JDataConfig
from repro.models import get_family as jax_family
from repro.train import TrainConfig as JTrainConfig
from repro.train import adamw_init as j_adamw_init
from repro.train import restore_checkpoint as j_restore_checkpoint
from repro.train import save_checkpoint as j_save_checkpoint
from repro.train import train as jax_train
from repro_torch.configs import ARCHS
from repro_torch.data import DataConfig
from repro_torch.train import TrainConfig, latest_step, train
from repro_torch.train.tree import paths

REL = 1e-4
DATA = dict(batch_size=2, seq_len=16, seed=0)


def quiet(_):
    pass


@pytest.mark.parametrize("name", ["whisper-tiny", "recurrentgemma-2b"])
def test_both_packages_train_on_from_a_reference_checkpoint(tmp_path, name):
    jcfg = JAX_ARCHS[name].reduced()
    jparams = jax_family(jcfg).init(jax.random.PRNGKey(7), jcfg)
    j_save_checkpoint(str(tmp_path / "jax"), 0,
                      (jparams, j_adamw_init(jparams)))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    jout = jax_train(jcfg, JDataConfig(**DATA),
                     JTrainConfig(steps=3, log_every=1,
                                  checkpoint_dir=str(tmp_path / "jax")),
                     log=quiet)
    out = train(ARCHS[name].reduced(), DataConfig(**DATA),
                TrainConfig(steps=3, log_every=1, checkpoint_every=3,
                            checkpoint_dir=str(tmp_path / "port")),
                log=quiet, device="cpu")
    assert len(out["losses"]) == len(jout["losses"]) == 3
    for got, want in zip(out["losses"], jout["losses"]):
        assert abs(got - want) <= REL * abs(want), (out["losses"],
                                                    jout["losses"])
    # the port's step-3 checkpoint restores into the JAX package's template
    assert latest_step(str(tmp_path / "port")) == 3
    (jp, js), step = j_restore_checkpoint(str(tmp_path / "port"),
                                          (jparams, j_adamw_init(jparams)))
    assert step == 3 and int(js.step) == 3
    ours = dict(paths((out["params"], out["opt_state"])))
    flat = jax.tree_util.tree_flatten_with_path((jp, js))[0]
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx",
                                                     getattr(p, "name", p))))
                       for p in path)
        np.testing.assert_array_equal(np.asarray(leaf), ours[key].numpy(),
                                      err_msg=key)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_resume_from_a_checkpoint_is_bit_identical(tmp_path, optimizer):
    """A checkpoint after step 2 and a fresh ``train()`` for step 3 end
    with the uninterrupted run's parameters and state bit for bit (the
    resumed run skips the batches of steps 1 and 2)."""
    cfg = ARCHS["recurrentgemma-2b"].reduced()
    whole = train(cfg, DataConfig(**DATA),
                  TrainConfig(steps=3, optimizer=optimizer), log=quiet,
                  device="cpu")
    d = str(tmp_path / "ckpt")
    first = train(cfg, DataConfig(**DATA),
                  TrainConfig(steps=2, checkpoint_every=2, checkpoint_dir=d,
                              optimizer=optimizer), log=quiet, device="cpu")
    assert first["losses"] == whole["losses"][:2]
    logs = []
    resumed = train(cfg, DataConfig(**DATA),
                    TrainConfig(steps=3, checkpoint_dir=d,
                                optimizer=optimizer),
                    log=logs.append, device="cpu")
    assert logs[0] == "restored checkpoint at step 2"
    assert resumed["losses"] == whole["losses"][2:]
    got = dict(paths((resumed["params"], resumed["opt_state"])))
    for key, leaf in paths((whole["params"], whole["opt_state"])):
        assert torch.equal(got[key], leaf), key


def test_train_raises_without_a_card_when_asked_for_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(ARCHS["llama3-8b"].reduced(), DataConfig(**DATA),
              TrainConfig(steps=1))


def test_launcher_runs_on_the_cpu():
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "whisper-tiny", "--steps", "2", "--batch", "2", "--seq", "16",
         "--device", "cpu", "--optimizer", "adafactor"],
        env=dict(os.environ, PYTHONPATH=src), capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith("final loss: ")
