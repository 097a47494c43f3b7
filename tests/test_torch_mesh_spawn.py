"""``launch.mesh.spawn``'s rendezvous under contention: many worlds
started at once on the CPU (the load of several pytest workers each
spawning its mesh tests' ranks) must all join, each its own ranks.

The parent opens the rendezvous store on a port the operating system
picks and holds it until its ranks are joined, so no world can take
another's port between a probe and a listen (the fault this pins: a
port read from a closed socket, then opened by rank 0 once its process
had started, lost to another world with ``EADDRINUSE``)."""
import threading

import pytest

from helpers import torch_mesh_ranks as ranks
from repro_torch.launch.mesh import spawn

WORLDS = 8


def test_concurrent_spawns_all_join():
    results, errors = {}, {}

    def run(i):
        try:
            results[i] = spawn(ranks.rank_sum, 2, (10 * i,), device="cpu",
                               threads=1, timeout=120, deadline=240)
        except Exception as e:                     # noqa: BLE001
            errors[i] = repr(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(WORLDS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for i in range(WORLDS):
        # each world summed its own two ranks' values: 10 i + 0, 10 i + 1
        assert results[i] == [(0, {"data": 0, "model": 0}, 20.0 * i + 1),
                              (1, {"data": 0, "model": 1}, 20.0 * i + 1)]


@pytest.mark.parametrize("data,tp", [(2, 1), (1, 2)])
def test_spawn_world_shapes(data, tp):
    got = spawn(ranks.rank_sum, tp, (3,), data=data, device="cpu",
                threads=1, timeout=120, deadline=240)
    assert [g[0] for g in got] == [0, 1]
    assert [g[1] for g in got] == [{"data": r // tp, "model": r % tp}
                                   for r in range(2)]
    assert all(g[2] == 7.0 for g in got)
