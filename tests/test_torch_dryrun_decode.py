"""The port's dry run against the JAX package's at decode_32k, for every
architecture of ``ARCHS`` (qwen3-1.7b in ``test_torch_dryrun``) at its
reduced widths on a (2, 4) mesh, under the gates of
``test_torch_dryrun._check`` (the JAX side as in
``test_torch_dryrun_train_dense``).  Argument bytes count only the
argument leaves a step reads or hands back, as XLA keeps only those:
whisper's decode never reads its encoder, internvl2's never its
projector.  The embedding lookup in a table split along the vocabulary
is partitioned as XLA partitions it (each shard looks up its rows, the
partial rows all-reduced)."""

import pytest
import torch

from test_torch_dryrun import (  # noqa: F401 (the mesh fixture)
    case_key, cases_reference, check_case, mesh)

NAMES = ["llama3-8b", "granite-moe-1b-a400m", "internvl2-2b",
         "h2o-danube-3-4b", "yi-34b", "xlstm-1.3b", "whisper-tiny",
         "grok-1-314b", "recurrentgemma-2b"]
CASES = [(a, "decode_32k", "") for a in NAMES]


@pytest.fixture(scope="module")
def reference():
    yield from cases_reference(CASES)


def test_every_architecture_is_a_case():
    from repro_torch.configs import ARCHS

    assert sorted(NAMES + ["qwen3-1.7b"]) == sorted(ARCHS)


@pytest.mark.parametrize("case", CASES, ids=case_key)
def test_decode_step_costs_match_the_reference(case, reference, mesh,
                                               monkeypatch):
    got = check_case(case, mesh, reference, monkeypatch)
    assert got["kind"] == "decode"


def _placed_args(mesh):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import dryrun
    from repro_torch.launch.sharding import P

    tree = {"a": torch.empty(8, 16, device="meta"),
            "b": torch.empty(8, 4, device="meta"),
            "c": torch.empty(16, dtype=torch.bfloat16, device="meta")}
    specs = {"a": P("data", "model"), "b": P(None, "model"), "c": P()}
    args = dryrun.distribute_tree(tree, specs, mesh)
    assert args["a"].placements == (Shard(0), Shard(1))
    assert args["c"].placements == (Replicate(), Replicate())
    return args


@pytest.mark.parametrize("reads", [("a",), ("a", "b", "c")])
def test_argument_bytes_count_the_leaves_a_step_reads(reads, mesh):
    """A step that reads part of its argument tree counts only the leaves
    it reads (a leaf it hands back counts as read); one that reads every
    leaf counts them all, each at its local shard's bytes."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.dryrun import partitioned

    args = _placed_args(mesh)
    local = {"a": 4 * 4 * 4, "b": 8 * 1 * 4, "c": 16 * 2}

    def run():
        with partitioned():
            out = [args[k].sum() for k in reads if k != "b"]
            return out + ([args["b"]] if "b" in reads else [])

    got = dryrun.analyze(run, {"arguments": (args, 3)})
    assert got["bytes_per_device"]["argument"] == (
        sum(local[k] for k in reads) + 4)
    assert dryrun.local_bytes((args, 3)) == sum(local.values()) + 4
