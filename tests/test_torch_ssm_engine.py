"""Port dense engine vs JAX dense engine on reduced ``mamba2-780m`` in
float32: the same seeded workload through ``Engine.run_policy`` under
``fcfs`` with stalling prefill and ``slo-preempt`` with ``chunked:16``,
identical greedy tokens per request and the same completion set.

An attention-free arch takes the dense layout whatever ``paged`` asks
(as the JAX engine forces), prefills whole prompts at their exact length
(the recurrent state must see no pad token), and the serve launcher runs
it end to end on the CPU."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import policies as jax_policies
from repro.core.latency_model import PAPER_TABLE2 as JAX_MODEL
from repro.data import synthetic as jax_synthetic
from repro.engine.engine import Engine as JaxEngine
from repro.engine.request import RuntimeRequest as JaxRuntimeRequest
from repro.models import init_params
from repro_torch.bridge import from_jax_params
from repro_torch.core import policies
from repro_torch.core.latency_model import PAPER_TABLE2
from repro_torch.data import synthetic
from repro_torch.engine.engine import Engine
from repro_torch.engine.request import RuntimeRequest

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dataclasses.replace(get_reduced("mamba2-780m"), dtype="float32")
ENGINE_KW = dict(max_slots=3, max_seq_len=256)


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(0), CFG)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _run(port, params, policy, discipline):
    syn = synthetic if port else jax_synthetic
    rt_cls = RuntimeRequest if port else JaxRuntimeRequest
    rts = [rt_cls(request=r, prompt_tokens=p, max_new_tokens=r.output_len)
           for r, p in syn.sample_serve_workload(6, CFG.vocab_size, seed=0)]
    if port:
        eng = Engine(CFG, params[1], device="cpu", **ENGINE_KW)
        pol = policies.make(policy, model=PAPER_TABLE2, max_batch=3)
    else:
        eng = JaxEngine(CFG, params[0], **ENGINE_KW)
        pol = jax_policies.make(policy, model=JAX_MODEL, max_batch=3)
    return eng.run_policy(rts, pol, discipline=discipline), eng


@pytest.mark.parametrize("policy,discipline", [("fcfs", "stall"),
                                               ("slo-preempt", "chunked:16")])
def test_ssm_engine_tokens_match_jax(params, policy, discipline):
    got, eng = _run(True, params, policy, discipline)
    want, jeng = _run(False, params, policy, discipline)
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid]["tokens"] == want[rid]["tokens"], rid
        assert len(got[rid]["tokens"]) > 0
    assert not eng.paged and not jeng.paged and not eng._partial
    if discipline == "stall":
        # whole prompts prefill at their exact length (16-96 tokens)
        lengths = {k[1] for k in eng._warm if k[0] == "prefill"}
        assert lengths and any(n & (n - 1) for n in lengths), lengths


@pytest.mark.parametrize("paged", [None, True, False])
def test_ssm_engine_takes_the_dense_pool(params, paged):
    eng = Engine(CFG, params[1], device="cpu", paged=paged, **ENGINE_KW)
    assert not eng.paged and eng.pool is None and eng.prefix is None
    layer = eng.cache["layers"][0]
    assert set(layer) == {"conv", "ssm"} and layer["ssm"].dtype == \
        torch.float32


def test_serve_cli_runs_mamba2_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mamba2-780m", "--reduced", "--device", "cpu", "--n", "4",
         "--policy", "fcfs"], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("policy=fcfs ") and "arch=mamba2-780m-reduced" \
        in last and "device=cpu" in last and "/4" in last
