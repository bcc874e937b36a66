"""The MoE train steps (granite-moe-1b-a400m, grok-1-314b) on the port's
dry run against the JAX package's, as in ``test_torch_dryrun_train_dense``.
The routing and the scatter into the expert buffers run on each shard's
own groups (the tokens split along ``d``, the router's partial logits
all-reduced), and the combine too: ``DTensor`` refuses the backward of
the groups' split otherwise."""

import pytest

from test_torch_dryrun import (  # noqa: F401 (the mesh fixture)
    case_key, cases_reference, check_case, mesh)

NAMES = ["granite-moe-1b-a400m", "grok-1-314b"]
CASES = [(a, "train_4k", "") for a in NAMES]


@pytest.fixture(scope="module")
def reference():
    yield from cases_reference(CASES)


@pytest.mark.parametrize("case", CASES, ids=case_key)
def test_train_step_costs_match_the_reference(case, reference, mesh,
                                              monkeypatch):
    got = check_case(case, mesh, reference, monkeypatch)
    assert got["kind"] == "train" and got["optimizer"] == "adamw"
