"""MLA on four tensor-parallel ranks (spawned, gloo on the CPU) against
the JAX forwards on one device: the forwards of ``test_torch_mesh_mla.py``
at tp 4 (reduced DeepSeek-V2-Lite: one of its 4 heads a rank; the 3-head
MLA: the block whole on every rank).  Logits within 1e-5, ranks alike,
latent pages bit for bit alike."""
import pytest

import test_torch_mesh_mla as base
from test_torch_mesh_mla import MODELS, trees, want  # noqa: F401 (fixtures)


@pytest.fixture(scope="module")
def runs(trees):                                        # noqa: F811
    return base.spawn_suite(4, trees)


@pytest.mark.parametrize("what", ["prefill", "chunk", "decode", "full"])
@pytest.mark.parametrize("name", list(MODELS))
def test_mla_logits_match_jax_tp4(runs, want, name, what):  # noqa: F811
    base.check_forwards(runs, want, name, what)


@pytest.mark.parametrize("name", list(MODELS))
def test_mla_heads_and_latent_per_rank_tp4(runs, name):
    base.check_mla_heads(runs, name, 4)
    base.check_latent(runs, name)
