"""The port's forwards on four tensor-parallel ranks (spawned, gloo on the
CPU) against the JAX forwards on one device: the configs and checks of
``test_torch_mesh_model.py`` at tp 4 (8 q / 4 kv heads: one kv head a
rank; 6 q / 3 kv heads: attention whole on every rank; vocabulary 96 in
quarters, 97 whole; the MLP in quarters).  Logits within 1e-5."""
import pytest

import test_torch_mesh_model as base
from test_torch_mesh_model import SHAPES, models  # noqa: F401  (fixture)


@pytest.fixture(scope="module")
def runs(models):                                      # noqa: F811
    return base.spawn_forwards(4, models)


@pytest.mark.parametrize("what", ["prefill", "chunk", "decode", "full"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_logits_match_jax_tp4(runs, models, name, what):   # noqa: F811
    base.check_logits(runs, models, name, what)


@pytest.mark.parametrize("name", list(SHAPES))
def test_heads_per_rank_tp4(runs, models, name):           # noqa: F811
    base.check_heads(runs, models, 4, name)
