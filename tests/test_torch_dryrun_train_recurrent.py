"""The xLSTM and hybrid train steps (xlstm-1.3b, recurrentgemma-2b) on the
port's dry run against the JAX package's, as in
``test_torch_dryrun_train_dense``.  xLSTM's log-sigmoid (whose backward
``DTensor`` has no rule for), its chunked mLSTM and its sLSTM scan run
on local shards."""

import pytest

from test_torch_dryrun import (  # noqa: F401 (the mesh fixture)
    case_key, cases_reference, check_case, mesh)

NAMES = ["xlstm-1.3b", "recurrentgemma-2b"]
CASES = [(a, "train_4k", "") for a in NAMES]


@pytest.fixture(scope="module")
def reference():
    yield from cases_reference(CASES)


@pytest.mark.parametrize("case", CASES, ids=case_key)
def test_train_step_costs_match_the_reference(case, reference, mesh,
                                              monkeypatch):
    got = check_case(case, mesh, reference, monkeypatch)
    assert got["kind"] == "train" and got["optimizer"] == "adamw"
