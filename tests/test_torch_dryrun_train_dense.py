"""The port's dry run against the JAX package's at train_4k, for the dense
transformers of ``ARCHS`` (llama3-8b, internvl2-2b, h2o-danube-3-4b,
yi-34b) at their reduced widths on a (2, 4) mesh, under the gates of
``test_torch_dryrun._check``: per-partition FLOPs within 5 %, argument
bytes equal, collective bytes within 2x.  The other architectures are in
``test_torch_dryrun_train_{whisper,moe,recurrent}`` and, for
qwen3-1.7b, ``test_torch_dryrun``.

The JAX side runs in one subprocess of 8 forced host devices, started
before the first trace, with its flash attention off: on the CPU that is
a Pallas kernel in interpret mode that XLA cannot partition (see
``test_torch_dryrun_train_whisper``).  Every collective in the JAX
package's CPU program is f32 where the port's move the activations'
dtype, and each reduce-scatter is an all-reduce there, so a port that
moves what XLA moves reads half of XLA's bytes or less; each kind is
printed beside the reference's (``-s``)."""

import pytest

from test_torch_dryrun import (  # noqa: F401 (the mesh fixture)
    case_key, cases_reference, check_case, mesh)

NAMES = ["llama3-8b", "internvl2-2b", "h2o-danube-3-4b", "yi-34b"]
CASES = [(a, "train_4k", "") for a in NAMES]


@pytest.fixture(scope="module")
def reference():
    yield from cases_reference(CASES)


def test_every_architecture_is_a_case():
    """Every architecture of ``ARCHS`` at train_4k in one of the files
    (qwen3-1.7b in ``test_torch_dryrun``)."""
    from test_torch_dryrun_train_moe import NAMES as MOE
    from test_torch_dryrun_train_recurrent import NAMES as RECURRENT
    from test_torch_dryrun_train_whisper import NAMES as WHISPER

    from repro_torch.configs import ARCHS

    held = NAMES + WHISPER + MOE + RECURRENT + ["qwen3-1.7b"]
    assert sorted(held) == sorted(ARCHS)


@pytest.mark.parametrize("case", CASES, ids=case_key)
def test_train_step_costs_match_the_reference(case, reference, mesh,
                                              monkeypatch):
    got = check_case(case, mesh, reference, monkeypatch)
    assert got["kind"] == "train" and got["optimizer"] == "adamw"
