"""The jobs and checks of ``test_torch_mesh_engine_data.py`` at (data 2,
tp 2): four spawned ranks, each holding one of the two kv heads of every
page array and, under FSDP, half of each sharded leaf's tp slice,
against the JAX ``Engine`` on a (2, 2) host mesh."""
import pytest

import test_torch_mesh_engine_data as base
from test_torch_mesh_engine_data import CASES


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return base.run_both((2, 2), tmp_path_factory.mktemp("engine-data-tp2"))


@pytest.mark.parametrize("case", CASES)
def test_data_engine_matches_jax_tp2(runs, case):
    base.check_against_jax(runs, case)


@pytest.mark.parametrize("case", CASES)
def test_data_ranks_replay_the_same_steps_tp2(runs, case):
    base.check_replay(runs, case)


@pytest.mark.parametrize("case", CASES)
def test_data_ranks_hold_their_slices_tp2(runs, case):
    base.check_slices(runs, case)
