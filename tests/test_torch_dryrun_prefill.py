"""The MoE prefill steps (granite-moe-1b-a400m, grok-1-314b at
prefill_32k) on the port's dry run against the JAX package's, on a (2, 4)
mesh, under the gates of ``test_torch_dryrun._check`` (the JAX side as
in ``test_torch_dryrun_train_dense``).  The router's products run on the
tokens split along ``d`` (the partial logits all-reduced), and the
experts' products keep the groups split, as XLA partitions them."""

import pytest

from test_torch_dryrun import (  # noqa: F401 (the mesh fixture)
    case_key, cases_reference, check_case, mesh)

CASES = [(a, "prefill_32k", "") for a in ("granite-moe-1b-a400m",
                                          "grok-1-314b")]


@pytest.fixture(scope="module")
def reference():
    yield from cases_reference(CASES)


@pytest.mark.parametrize("case", CASES, ids=case_key)
def test_prefill_step_costs_match_the_reference(case, reference, mesh,
                                                monkeypatch):
    got = check_case(case, mesh, reference, monkeypatch)
    assert got["kind"] == "prefill"
