"""The JAX package's paged ``Engine`` on a ``(data, model)`` mesh of host
devices, for the port's data-axis engine tests: each case's job through
``run_policy`` or a ``ServeLoop``, the engine's clock moving a fixed
time a step (1 ms by default), as ``tests/test_torch_mesh_engine.py``
runs the JAX engine on one device.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/helpers/jax_mesh_engine.py IN.npz OUT.json

``IN.npz`` holds ``spec`` (JSON: the arch, the config fields to replace,
the engine's keyword arguments and the cases, each a name, ``mesh``
[data, model], ``fsdp`` and the job: ``kind`` "policy" | "loop",
``policy``, ``discipline``, ``workload`` ["serve", n, seed] and
optionally ``clock``, the seconds a timed step, default 1 ms) and the
params' leaves ``p0``, ``p1``, ... in ``jax.tree.flatten`` order.
``OUT.json`` maps each case's name to its results by request (tokens,
preemptions, and cached tokens under ``run_policy``) and
``prefix_stats()``.

The mesh is built as ``Mesh(np.array(jax.devices()[:n]).reshape(data,
model), ...)``, as ``tests/helpers/jax_mesh_train.py`` builds it."""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.configs import get_reduced
from repro.core import policies
from repro.core.latency_model import PAPER_TABLE2
from repro.data import synthetic
from repro.distributed.sharding import ParallelismConfig
from repro.engine import engine as engine_mod
from repro.engine.engine import Engine
from repro.engine.request import RuntimeRequest
from repro.models import init_params
from repro.serving import ServeLoop


class FixedClock:
    """``perf_counter`` moving ``step`` seconds a call: every timed step
    takes ``step``."""

    def __init__(self, step: float = 1e-3):
        self.t, self.step = 0.0, step

    def perf_counter(self):
        self.t += self.step
        return self.t


def run_job(eng, job, vocab):
    _, n, seed = job["workload"]
    if job["kind"] == "loop":
        pairs = synthetic.sample_serve_workload(n, vocab, seed=seed,
                                                arrival_rate=50.0)
        loop = ServeLoop(eng, job["policy"], model=PAPER_TABLE2,
                         discipline=job["discipline"])
        loop.start(warm_lengths=[len(p) for _, p in pairs])
        loop.submit_trace(pairs)
        res = loop.serve()
        return {str(rid): {"tokens": [int(t) for t in v["tokens"]],
                           "preemptions": int(v["preemptions"])}
                for rid, v in res.items()}
    pairs = synthetic.sample_serve_workload(n, vocab, seed=seed)
    rts = [RuntimeRequest(request=r, prompt_tokens=p,
                          max_new_tokens=r.output_len) for r, p in pairs]
    pol = policies.make(job["policy"], model=PAPER_TABLE2,
                        max_batch=eng.max_slots)
    res = eng.run_policy(rts, pol, discipline=job["discipline"])
    return {str(rid): {"tokens": [int(t) for t in v["tokens"]],
                       "preemptions": int(v["preemptions"]),
                       "cached": int(v["cached"])}
            for rid, v in res.items()}


def run(src: str, dst: str):
    z = np.load(src)
    spec = json.loads(str(z["spec"]))
    cfg = dataclasses.replace(get_reduced(spec["arch"]), **spec["replace"])
    shapes = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
    treedef = jax.tree.structure(shapes)
    params = jax.tree.unflatten(treedef, [jnp.asarray(z[f"p{i}"]) for i in
                                          range(treedef.num_leaves)])
    out = {}
    for case in spec["cases"]:
        data, tp = case["mesh"]
        mesh = Mesh(np.array(jax.devices()[:data * tp]).reshape(data, tp),
                    ("data", "model"))
        engine_mod.time = FixedClock(case.get("clock", 1e-3))
        eng = Engine(cfg, params, mesh=mesh,
                     parallelism=ParallelismConfig(fsdp=case["fsdp"]),
                     **spec["engine"])
        out[case["name"]] = {"results": run_job(eng, case,
                                                cfg.vocab_size),
                             "prefix": eng.prefix_stats()}
    with open(dst, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    run(sys.argv[1], sys.argv[2])
