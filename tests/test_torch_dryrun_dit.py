"""The port's dry run against the JAX package's for the three diffusion
families of ``REAL`` at their published widths (one CFG denoising step of
batch 4), and one reduced train step on Adafactor, on a (2, 4) mesh,
under the gates of ``test_torch_dryrun._check`` (the JAX side as in
``test_torch_dryrun_train_dense``).  sd3.5-large's 38 heads do not divide the
4-way model axis: XLA splits them 2 ways and does each half on 2 ranks,
and the port's attention does the same.  The Adafactor step makes
``ArchConfig.param_count`` read 2e11 on both sides, which takes the
optimizer a full-size grok takes, and 32 microbatches."""

import pytest

from test_torch_dryrun import (  # noqa: F401 (the mesh fixture)
    case_key, cases_reference, check_case, mesh)

CASES = [("sd3", "denoise_b4_cfg", ""),
         ("sd3.5-large", "denoise_b4_cfg", ""),
         ("flux-dev", "denoise_b4_cfg", ""),
         ("qwen3-1.7b", "train_4k", "adafactor")]


@pytest.fixture(scope="module")
def reference():
    yield from cases_reference(CASES)


@pytest.mark.parametrize("case", CASES, ids=case_key)
def test_step_costs_match_the_reference(case, reference, mesh, monkeypatch):
    got = check_case(case, mesh, reference, monkeypatch)
    if case[2] == "adafactor":
        assert got["optimizer"] == "adafactor" and got["accum_steps"] == 32
