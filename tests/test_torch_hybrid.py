"""Port vs JAX reference: the Zamba2 hybrid (Mamba2 blocks and one shared
attention+MLP block) on both KV layouts, in float32 on the CPU.

Reduced ``zamba2-1.2b`` at 4 layers, ``(SSM, ATTN, SSM, ATTN)``: both
attention layers run the one shared block, each with its own K/V.
(``reduced(num_layers=n)`` cuts a hybrid pattern to ``(SSM, ATTN)``
whatever ``n`` is, so the pattern is set beside the depth.)  Params come
from ``repro.models.init_params`` through ``from_jax_params``.

* The parameter tree: ``shared_block`` and ``{}`` at every attention
  position, leaf for leaf the JAX tree (at the published 38-layer
  pattern too); ``require_ported`` on both layouts.
* The six forwards: logits at the reference's 1e-5
  (``tests/test_paged.py``), per-slot conv / SSM state at 1e-5, the
  live pages equal.
* The engine: identical greedy tokens per request, the same completion
  set and preemption counts, no prefix index on either side, under
  fcfs on paged and dense x stall and ``chunked:16``, and slo-preempt
  stall on paged.  The paged ``chunked:16`` run pins the reference's
  two traps (``ROADMAP.md`` §3): a ragged chunk's padded rows enter the
  SSM state, and a reused slot's first chunk starts from the state its
  previous request left.  The port reproduces them, so its tokens
  equal the JAX tokens there and differ, on both sides, from the
  stalling run's on a ragged prompt.
* A decode round over a slot prefix leaves an idle slot's conv and SSM
  state bit-identical; the ``ServeLoop`` on the paged hybrid gives the
  JAX loop's tokens, overlapped and synchronous alike; the serve CLI
  runs ``--arch zamba2-1.2b``."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_reduced
from repro.core import policies as jax_policies
from repro.core.latency_model import PAPER_TABLE2 as JAX_MODEL
from repro.data import synthetic as jax_synthetic
from repro.engine.engine import Engine as JaxEngine
from repro.engine.request import RuntimeRequest as JaxRuntimeRequest
from repro.models import init_params as jax_init_params
from repro.models import model as jax_model
from repro.models.cache import init_cache as jax_init_cache
from repro.models.cache import init_paged_cache as jax_init_paged_cache
from repro.models.cache import kv_bytes_per_token as jax_kv_bytes
from repro.models.config import ATTN, SSM
from repro.serving import ServeLoop as JaxServeLoop
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.core import policies
from repro_torch.core.latency_model import PAPER_TABLE2
from repro_torch.data import synthetic
from repro_torch.engine.engine import Engine
from repro_torch.engine.request import RuntimeRequest
from repro_torch.models.cache import (init_cache, init_paged_cache,
                                      kv_bytes_per_token, paged_slot_len,
                                      require_ported)
from repro_torch.models.model import (forward_chunk, forward_chunk_paged,
                                      forward_decode, forward_decode_paged,
                                      forward_full, forward_prefill_paged,
                                      init_params)
from repro_torch.serving import ServeLoop

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)
PATTERN = (SSM, ATTN, SSM, ATTN)
CFG = dataclasses.replace(get_reduced("zamba2-1.2b"), num_layers=4,
                          layer_pattern=PATTERN, dtype="float32")
TCFG = dataclasses.replace(torch_get_reduced("zamba2-1.2b"), num_layers=4,
                           layer_pattern=PATTERN, dtype="float32")
ENGINE_KW = dict(max_slots=3, max_seq_len=256)
jax_full = jax.jit(jax_model.forward_full, static_argnames=("cfg",))
jax_decode = jax.jit(jax_model.forward_decode, static_argnames=("cfg",))
jax_chunk = jax.jit(jax_model.forward_chunk, static_argnames=("cfg",))
jax_prefill_paged = jax.jit(jax_model.forward_prefill_paged,
                            static_argnames=("cfg", "slot", "length"))
jax_chunk_paged = jax.jit(jax_model.forward_chunk_paged,
                          static_argnames=("cfg", "slot", "length"))
jax_decode_paged = jax.jit(jax_model.forward_decode_paged,
                           static_argnames=("cfg",))


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    CFG)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _tree(node):
    """Nested keys, list lengths, ``{}`` markers, leaf shapes and dtypes."""
    if isinstance(node, dict):
        return {k: _tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree(v) for v in node]
    return tuple(node.shape), str(node.dtype).replace("torch.", "")


@pytest.mark.parametrize("layers", ["reduced", "published pattern"])
def test_init_params_tree_matches_jax(layers):
    """One ``shared_block`` drawn at the first attention layer, ``{}`` at
    every attention position, the JAX tree leaf for leaf (key order
    included, so ``from_jax_params`` maps one onto the other)."""
    jcfg, tcfg = CFG, TCFG
    if layers != "reduced":
        # the published 38-layer pattern (six attention layers) at the
        # reduced widths
        pattern = get_config("zamba2-1.2b").layer_pattern
        jcfg = dataclasses.replace(CFG, num_layers=38, layer_pattern=pattern)
        tcfg = dataclasses.replace(TCFG, num_layers=38,
                                   layer_pattern=pattern)
    want = _tree(jax.eval_shape(lambda k: jax_init_params(k, jcfg),
                                jax.random.PRNGKey(0)))
    got = _tree(init_params(tcfg, seed=0, device="cpu"))
    assert got == want
    assert list(got) == list(want)
    attn = [i for i, kind in enumerate(tcfg.layer_pattern) if kind == ATTN]
    assert attn == ([1, 3] if layers == "reduced"
                    else [5, 11, 17, 23, 29, 35])
    assert all(got["layers"][i] == {} for i in attn)
    assert set(got["shared_block"]) == {"attn_norm", "mlp_norm", "attn",
                                        "mlp"}


def test_require_ported_layouts():
    """The hybrid runs on both layouts; SSM-only stacks stay off the
    paged pool, the engines refuse multi-codebook heads (the model
    forwards take them), MLA / MoE (DeepSeek-V2-Lite, DBRX) run on both
    layouts with the reference's KV bytes per token; the hybrid's count
    the six attention layers only, as JAX's."""
    full = torch_get_config("zamba2-1.2b")
    for cfg in (full, TCFG):
        require_ported(cfg)
        require_ported(cfg, paged=True)
    assert kv_bytes_per_token(full) == jax_kv_bytes(
        get_config("zamba2-1.2b")) == 6 * 2 * 32 * 64 * 2
    require_ported(torch_get_config("mamba2-780m"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md M10"):
        require_ported(torch_get_config("mamba2-780m"), paged=True)
    for arch in ("deepseek-v2-lite-16b", "dbrx-132b"):
        require_ported(torch_get_config(arch))
        require_ported(torch_get_config(arch), paged=True)
        assert kv_bytes_per_token(torch_get_config(arch)) == jax_kv_bytes(
            get_config(arch))
    mcfg = torch_get_config("musicgen-medium")
    require_ported(mcfg)
    require_ported(mcfg, paged=True)
    for paged in (True, False):
        with pytest.raises(NotImplementedError, match="JAX Engine"):
            Engine(mcfg, {"embed": torch.zeros(1)}, paged=paged,
                   device="cpu")


def _ssm_close(tc, jc, slots=slice(None)):
    for i, kind in enumerate(PATTERN):
        if kind == SSM:
            for name in ("conv", "ssm"):
                _close(tc["layers"][i][name][slots],
                       np.asarray(jc["layers"][i][name])[slots])


def test_dense_forwards_match_jax(params):
    """``forward_full`` (prefill into the dense cache), ``forward_chunk``
    from it and three ``forward_decode`` steps: logits, the rings and the
    conv / SSM state."""
    jp, tp = params
    rng = np.random.default_rng(0)
    jc = jax_init_cache(CFG, 2, 64)
    tc = init_cache(TCFG, 2, 64, device="cpu")
    toks = rng.integers(0, CFG.vocab_size, (2, 20)).astype(np.int32)
    jl, jc, _ = jax_full(jp, CFG, tokens=jnp.asarray(toks), cache=jc)
    tl, tc, _ = forward_full(tp, TCFG, tokens=torch.from_numpy(toks),
                             cache=tc)
    _close(tl, jl)
    toks = rng.integers(0, CFG.vocab_size, (2, 8)).astype(np.int32)
    jl, jc = jax_chunk(jp, CFG, tokens=jnp.asarray(toks), cache=jc)
    tl, tc = forward_chunk(tp, TCFG, tokens=torch.from_numpy(toks), cache=tc)
    _close(tl, jl)
    nxt = rng.integers(0, CFG.vocab_size, (2, 1)).astype(np.int32)
    for _ in range(3):
        jl, jc = jax_decode(jp, CFG, tokens=jnp.asarray(nxt), cache=jc)
        tl, tc = forward_decode(tp, TCFG, tokens=torch.from_numpy(nxt),
                                cache=tc)
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [31, 31]
    _ssm_close(tc, jc)
    for i in (1, 3):
        for name in ("k", "v"):
            _close(tc["layers"][i][name], jc["layers"][i][name])


def test_paged_forwards_match_jax(params):
    """``forward_prefill_paged`` (slot 0 at exact length, slot 1 padded
    to its bucket: the padded rows enter the SSM state on both sides),
    ``forward_chunk_paged`` (10 valid rows of a 16-row bucket, from the
    slot's state) and three ``forward_decode_paged`` steps: logits, each
    slot's conv / SSM state, and the live pages (page 0, the null page,
    takes the padded rows in no set order)."""
    jp, tp = params
    B, MSL, P = 2, 128, 16
    npg = paged_slot_len(CFG, MSL, P) // P
    bt = np.arange(1, 1 + B * npg, dtype=np.int32).reshape(B, npg)
    jc = jax_init_paged_cache(CFG, B, MSL, 1 + B * npg, P)
    jc["block_tables"] = jnp.asarray(bt)
    tc = init_paged_cache(TCFG, B, MSL, 1 + B * npg, P, device="cpu")
    tc["block_tables"] = torch.from_numpy(bt)
    rng = np.random.default_rng(1)
    for slot, n, pad in ((0, 37, 37), (1, 13, 16)):
        toks = np.zeros((1, pad), np.int32)
        toks[0, :n] = rng.integers(0, CFG.vocab_size, n)
        jl, jc = jax_prefill_paged(jp, CFG, tokens=jnp.asarray(toks),
                                   cache=jc, slot=slot, length=n)
        tl, tc = forward_prefill_paged(tp, TCFG,
                                       tokens=torch.from_numpy(toks),
                                       cache=tc, slot=slot, length=n)
        _close(tl, jl)
    _ssm_close(tc, jc)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :10] = rng.integers(0, CFG.vocab_size, 10)
    jl, jc = jax_chunk_paged(jp, CFG, tokens=jnp.asarray(toks), cache=jc,
                             slot=0, length=10)
    tl, tc = forward_chunk_paged(tp, TCFG, tokens=torch.from_numpy(toks),
                                 cache=tc, slot=0, length=10)
    _close(tl, jl)
    _ssm_close(tc, jc)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [47, 13]
    nxt = rng.integers(0, CFG.vocab_size, (B, 1)).astype(np.int32)
    for _ in range(3):
        jl, jc = jax_decode_paged(jp, CFG, tokens=jnp.asarray(nxt), cache=jc)
        tl, tc = forward_decode_paged(tp, TCFG, tokens=torch.from_numpy(nxt),
                                      cache=tc)
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    _ssm_close(tc, jc)
    for i in (1, 3):
        for name in ("k", "v"):
            _close(tc["layers"][i][name][1:],
                   np.asarray(jc["layers"][i][name])[1:])


def test_decode_paged_active_freezes_inactive_slots(params):
    """``active`` keeps an inactive slot's conv / SSM state bit for bit
    (the JAX engine's ``where`` freeze) and moves the active one's."""
    _, tp = params
    tc = init_paged_cache(TCFG, 2, 64, 9, 16, device="cpu")
    tc["block_tables"] = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    gen = torch.Generator().manual_seed(0)
    for i in (0, 2):
        for name in ("conv", "ssm"):
            tc["layers"][i][name].copy_(torch.randn(
                tc["layers"][i][name].shape, generator=gen))
    before = [tc["layers"][i][n].clone() for i in (0, 2)
              for n in ("conv", "ssm")]
    forward_decode_paged(tp, TCFG, tokens=torch.ones((2, 1), dtype=torch.int32),
                         cache=tc, active=torch.tensor([True, False]))
    after = [tc["layers"][i][n] for i in (0, 2) for n in ("conv", "ssm")]
    for a, b in zip(before, after):
        assert torch.equal(a[1], b[1])
        assert not torch.equal(a[0], b[0])


# ----------------------------------------------------------- engines
@pytest.fixture(scope="module")
def runs(params):
    """Memoized engine runs, ``runs(port, paged, discipline, policy)``:
    each JAX run compiles a prefill per distinct prompt length, so each
    is made once for the module."""
    memo = {}

    def run(port, paged, discipline, policy="fcfs"):
        key = (port, paged, discipline, policy)
        if key not in memo:
            memo[key] = _run(port, params, paged, discipline, policy)
        return memo[key]
    return run


def _run(port, params, paged, discipline, policy):
    syn = synthetic if port else jax_synthetic
    rt_cls = RuntimeRequest if port else JaxRuntimeRequest
    pairs = syn.sample_serve_workload(6, CFG.vocab_size, seed=0)
    rts = [rt_cls(request=r, prompt_tokens=p, max_new_tokens=r.output_len)
           for r, p in pairs]
    if port:
        eng = Engine(TCFG, params[1], paged=paged, device="cpu", **ENGINE_KW)
        pol = policies.make(policy, model=PAPER_TABLE2, max_batch=3)
    else:
        eng = JaxEngine(CFG, params[0], paged=paged, **ENGINE_KW)
        pol = jax_policies.make(policy, model=JAX_MODEL, max_batch=3)
    out = eng.run_policy(rts, pol, discipline=discipline)
    assert eng.paged is paged and eng.prefix is None
    return out, [len(p) for _, p in pairs]


@pytest.mark.parametrize("paged,discipline,policy", [
    (True, "stall", "fcfs"), (True, "chunked:16", "fcfs"),
    (False, "stall", "fcfs"), (False, "chunked:16", "fcfs"),
    (True, "stall", "slo-preempt")])
def test_engine_tokens_match_jax(runs, paged, discipline, policy):
    got, _ = runs(True, paged, discipline, policy)
    want, _ = runs(False, paged, discipline, policy)
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid]["tokens"] == want[rid]["tokens"], rid
        assert got[rid]["preemptions"] == want[rid]["preemptions"], rid
        assert len(got[rid]["tokens"]) > 0


def test_paged_chunk_traps_reproduced(runs):
    """Paged ``chunked:16`` runs each chunk padded to its bucket from the
    slot's state as it stands: its tokens differ from the stalling run's
    on a ragged prompt, in the port as in JAX, and equal JAX's; the
    three other layouts x disciplines agree with each other."""
    for port in (True, False):
        chunked, lengths = runs(port, True, "chunked:16")
        stall, _ = runs(port, True, "stall")
        ragged = [rid for rid, n in zip(sorted(stall), lengths) if n % 16]
        assert ragged
        assert any(chunked[rid]["tokens"] != stall[rid]["tokens"]
                   for rid in ragged)
        for layout in ((False, "stall"), (False, "chunked:16")):
            other, _ = runs(port, *layout)
            assert {r: v["tokens"] for r, v in other.items()} == \
                {r: v["tokens"] for r, v in stall.items()}
    got, _ = runs(True, True, "chunked:16")
    want, _ = runs(False, True, "chunked:16")
    assert {r: v["tokens"] for r, v in got.items()} == \
        {r: v["tokens"] for r, v in want.items()}


def test_dispatch_decode_keeps_idle_slot_state(params):
    """A fused decode round at width 2 of a 4-slot paged pool, slot 0
    live and slot 1 idle beside it (its request prefilled, then masked
    out): slot 1's conv / SSM state and ``pos`` are bit-identical after
    the round, slot 0's moved, and slots 2-3 (past the width) are
    untouched."""
    eng = Engine(TCFG, params[1], max_slots=4, max_seq_len=128,
                 device="cpu")
    pairs = synthetic.sample_serve_workload(2, CFG.vocab_size, seed=3)
    rts = [RuntimeRequest(request=r, prompt_tokens=p[:20], max_new_tokens=8)
           for r, p in pairs]
    for slot, rt in enumerate(rts):
        eng.begin_prefill(rt, slot)
        eng.prefill_step(rt)
    ssm = [eng.cache["layers"][i] for i in (0, 2)]
    before = [{n: layer[n].clone() for n in ("conv", "ssm")} for layer in ssm]
    pos = eng.cache["pos"].clone()
    feed = torch.zeros((4, 1), dtype=torch.int32)
    feed[0, 0] = rts[0].generated[-1]
    toks = eng.dispatch_decode(feed, np.array([True, False, False, False]),
                               width=2)
    assert toks.shape == (2,)
    for old, layer in zip(before, ssm):
        for n in ("conv", "ssm"):
            assert torch.equal(old[n][1:], layer[n][1:])
            assert not torch.equal(old[n][0], layer[n][0])
    assert eng.cache["pos"].tolist() == [pos[0] + 1] + pos[1:].tolist()


def _serve(port, params, overlap=True):
    syn = synthetic if port else jax_synthetic
    pairs = syn.sample_serve_workload(4, CFG.vocab_size, seed=0,
                                      arrival_rate=50.0)
    kw = dict(max_slots=4, max_seq_len=256)
    if port:
        loop = ServeLoop(Engine(TCFG, params[1], device="cpu", **kw), "fcfs",
                         model=PAPER_TABLE2, overlap=overlap)
    else:
        loop = JaxServeLoop(JaxEngine(CFG, params[0], **kw), "fcfs",
                            model=JAX_MODEL, overlap=overlap)
    loop.start(warm_lengths=[len(p) for _, p in pairs])
    loop.submit_trace(pairs)
    res = loop.serve()
    assert len(res) == 4 and loop.eng.paged
    return {rid: v["tokens"] for rid, v in res.items()}, loop


def test_serve_loop_tokens_match_jax(params):
    """The paged hybrid through the ``ServeLoop``: overlapped tokens equal
    synchronous ones and the JAX loop's, per request."""
    got, loop = _serve(True, params)
    sync, _ = _serve(True, params, overlap=False)
    want, _ = _serve(False, params)
    assert got == sync == want
    assert loop.metrics.summary()["overlap_frac"] > 0


def test_serve_cli_runs_zamba2_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "zamba2-1.2b", "--reduced", "--device", "cpu", "--n", "4",
         "--policy", "fcfs"], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("policy=fcfs mode=stream ") and \
        "arch=zamba2-1.2b-reduced" in last and "completed=4/4" in last
