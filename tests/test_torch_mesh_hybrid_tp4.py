"""The Zamba2 hybrid on four tensor-parallel ranks (spawned, gloo on the
CPU) against the JAX forwards on one device: the forwards of
``test_torch_mesh_hybrid.py`` at tp 4 (the shared block on one q and one
kv head a rank, the SSM layers whole on every rank).  Logits within
1e-5, every rank's alike, the SSM state bit for bit alike."""
import pytest

import test_torch_mesh_hybrid as base
from test_torch_mesh_hybrid import tree, want  # noqa: F401 (fixtures)


@pytest.fixture(scope="module")
def runs(tree):                                         # noqa: F811
    return base.spawn_suite(4, tree)


@pytest.mark.parametrize("what", ["prefill", "chunk", "decode", "full"])
def test_hybrid_logits_match_jax_tp4(runs, want, what):     # noqa: F811
    base.check_forwards(runs, want, what)


def test_hybrid_shards_per_rank_tp4(runs):
    base.check_shards(runs, 4)
