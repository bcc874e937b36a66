"""whisper-tiny's train_4k step on the port's dry run against the JAX
package's, as in ``test_torch_dryrun_train_dense``.  Held against the
reference with its flash attention off: with it on, the reference's
encoder attention is the Pallas kernel in interpret mode, which XLA
cannot partition, and it all-gathers the kernel's blocks inside the
kernel's loop (5.02e10 collective bytes a partition in all, where the
port, whose attention runs on local shards, moves none of those)."""

import pytest

from test_torch_dryrun import (  # noqa: F401 (the mesh fixture)
    case_key, cases_reference, check_case, mesh)

NAMES = ["whisper-tiny"]
CASES = [(a, "train_4k", "") for a in NAMES]


@pytest.fixture(scope="module")
def reference():
    yield from cases_reference(CASES)


@pytest.mark.parametrize("case", CASES, ids=case_key)
def test_train_step_costs_match_the_reference(case, reference, mesh,
                                              monkeypatch):
    got = check_case(case, mesh, reference, monkeypatch)
    assert got["kind"] == "train" and got["optimizer"] == "adamw"
