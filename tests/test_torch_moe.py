"""Port vs JAX reference: the MoE FFN, and the two MoE configs served
whole, in float32 on the CPU.

* The plain ragged product (``ops.ragged_dot`` on a CPU tensor) against
  ``jax.lax.ragged_dot``, an empty group and a group of every row
  included, at 1e-6.
* ``_local_moe`` (the same experts chosen per token, probabilities,
  output), ``load_balance_loss`` and ``moe_ffn`` with and without
  shared experts, at 1e-6, on seeded numpy inputs and the JAX
  ``init_moe`` weights bridged.
* Reduced ``deepseek-v2-lite-16b`` (MLA; layer 0 dense at
  ``d_ff_dense``, layer 1 MoE with a shared expert) and reduced
  ``dbrx-132b`` (GQA group 4; every layer MoE): the parameter tree leaf
  for leaf; ``forward_full`` (its aux loss at 1e-6 relative), dense
  decode, paged prefill and paged decode logits at the reference's
  1e-5 (DBRX also both chunk paths; DeepSeek's refuse, as the JAX
  package's assert); the caches' latent or K/V leaves.
* Both engines: identical greedy tokens, completion sets and
  preemption counts to the JAX ``Engine`` on ``sample_serve_workload(6)``
  under fcfs / slo-reanneal / slo-preempt on both layouts, and DBRX
  paged ``chunked:16`` with the prefix cache (its stats equal too).
* ``lm_loss`` and its gradients on reduced DeepSeek against the JAX
  ``lm_loss`` (1e-6 relative; 1e-5 of each leaf's max), remat equal to
  no remat."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import policies as jax_policies
from repro.core.latency_model import PAPER_TABLE2 as JAX_MODEL
from repro.data import synthetic as jax_synthetic
from repro.engine.engine import Engine as JaxEngine
from repro.engine.request import RuntimeRequest as JaxRuntimeRequest
from repro.models import init_params as jax_init_params
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.models.cache import init_cache as jax_init_cache
from repro.models.cache import init_paged_cache as jax_init_paged_cache
from repro.train.train_step import lm_loss as jax_lm_loss
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.core import policies
from repro_torch.core.latency_model import PAPER_TABLE2
from repro_torch.data import synthetic
from repro_torch.engine.engine import Engine
from repro_torch.engine.request import RuntimeRequest
from repro_torch.kernels import ops
from repro_torch.kernels.ragged_dot import ragged_dot_plain
from repro_torch.models import moe
from repro_torch.models.cache import (init_cache, init_paged_cache,
                                      paged_slot_len)
from repro_torch.models.model import (forward_chunk, forward_chunk_paged,
                                      forward_decode, forward_decode_paged,
                                      forward_full, forward_prefill_paged,
                                      init_params)
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import loss_and_grads

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)          # logits: the reference's bound
LAYER_TOL = dict(atol=1e-6, rtol=1e-6)    # layers
ARCHS = ("deepseek-v2-lite-16b", "dbrx-132b")
CFGS = {a: dataclasses.replace(get_reduced(a), dtype="float32")
        for a in ARCHS}
TCFGS = {a: dataclasses.replace(torch_get_reduced(a), dtype="float32")
         for a in ARCHS}
ENGINE_KW = dict(max_slots=3, max_seq_len=256)


@pytest.fixture(scope="module")
def params():
    """JAX params of each reduced arch and their bridge, made once."""
    memo = {}

    def get(arch):
        if arch not in memo:
            jp = jax.jit(jax_init_params, static_argnums=1)(
                jax.random.PRNGKey(0), CFGS[arch])
            memo[arch] = jp, from_jax_params(jax.tree.map(np.asarray, jp),
                                             device="cpu")
        return memo[arch]
    return get


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _tree(node):
    if isinstance(node, dict):
        return {k: _tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree(v) for v in node]
    return tuple(node.shape), str(node.dtype).replace("torch.", "")


# ------------------------------------------------------------- layers
@pytest.mark.parametrize("sizes", [(3, 0, 5, 2), (0, 10, 0, 0),
                                   (4, 4, 4, 4)],
                         ids=["empty group", "one group takes all",
                              "even"])
def test_ragged_dot_plain_matches_jax(sizes):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((sum(sizes), 24)).astype(np.float32)
    w = rng.standard_normal((len(sizes), 24, 40)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    want = jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(gs))
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(gs))
    ops.reset_launch_counts()
    got = ops.ragged_dot(*args)
    assert torch.equal(got, ragged_dot_plain(*args))
    assert ops.launch_counts()["ragged_dot"] == 0
    _close(got, want, LAYER_TOL)


def _moe_case(shared: int, t: int = 13):
    """An MoE of 6 experts, top 2, at the layer tests' widths (d 64, as
    ``tests/test_torch_layers.py``): float32 sums of that length agree
    within 1e-6; at the reduced model's d 256 with two shared experts
    they differ by up to 2.6e-6, inside the model-level 1e-5."""
    cfg = dataclasses.replace(CFGS["deepseek-v2-lite-16b"], d_model=64,
                              moe=dataclasses.replace(
                                  CFGS["deepseek-v2-lite-16b"].moe,
                                  num_experts=6, top_k=2, d_ff_expert=48,
                                  num_shared_experts=shared))
    jp = jax_moe.init_moe(jax.random.PRNGKey(3), cfg, jnp.float32)
    x = np.random.default_rng(1).standard_normal(
        (1, t, cfg.d_model)).astype(np.float32)
    return cfg, jp, from_jax_params(jax.tree.map(np.asarray, jp),
                                    device="cpu"), x


def test_local_moe_and_load_balance_match_jax():
    """Same experts per token, same probabilities, same output; the aux
    loss from the same probabilities."""
    cfg, jp, tp, x = _moe_case(0)
    k = cfg.moe.top_k
    names = ("router", "w_gate", "w_up", "w_down")
    want, jprobs = jax_moe._local_moe(jnp.asarray(x[0]),
                                      *(jp[n] for n in names), k)
    got, probs = moe._local_moe(torch.from_numpy(x[0]),
                                *(tp[n] for n in names), k)
    _close(probs, jprobs, LAYER_TOL)
    assert torch.topk(probs, k).indices.tolist() == np.asarray(
        jax.lax.top_k(jprobs, k)[1]).tolist()
    _close(got, want, LAYER_TOL)
    np.testing.assert_allclose(
        float(moe.load_balance_loss(probs, None, k)),
        float(jax_moe.load_balance_loss(jprobs, None, k)), rtol=1e-6)


@pytest.mark.parametrize("shared", [0, 2])
def test_moe_ffn_matches_jax(shared):
    cfg, jp, tp, x = _moe_case(shared)
    want, waux = jax_moe.moe_ffn(jp, cfg, jnp.asarray(x))
    got, aux = moe.moe_ffn(tp, cfg, torch.from_numpy(x))
    assert ("shared" in tp) == bool(shared)
    _close(got, want, LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


# ------------------------------------------------------------- model
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    cfg, tcfg = CFGS[arch], TCFGS[arch]
    want = _tree(jax.eval_shape(lambda k: jax_init_params(k, cfg),
                                jax.random.PRNGKey(0)))
    got = _tree(init_params(tcfg, seed=0, device="cpu"))
    assert got == want
    kinds = [sorted(layer) for layer in got["layers"]]
    if arch == "dbrx-132b":
        assert all("moe" in k and "mlp" not in k for k in kinds)
    else:
        assert "mlp" in kinds[0] and "moe" in kinds[1]
        assert got["layers"][0]["mlp"]["w_gate"][0] == (
            cfg.d_model, cfg.moe.d_ff_dense)
        assert set(got["layers"][1]["moe"]["shared"]) == {
            "w_gate", "w_up", "w_down"}
        assert got["layers"][1]["moe"]["router"][1] == "float32"


def _attn_leaves(arch):
    return ("ckv", "kpe") if arch == "deepseek-v2-lite-16b" else ("k", "v")


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_forwards_match_jax(params, arch):
    """``forward_full`` (its aux at 1e-6 relative) into the dense cache,
    DBRX's ``forward_chunk`` from it, then three ``forward_decode``
    steps: logits and the cache leaves."""
    cfg, tcfg = CFGS[arch], TCFGS[arch]
    jp, tp = params(arch)
    rng = np.random.default_rng(0)
    jc = jax_init_cache(cfg, 2, 64)
    tc = init_cache(tcfg, 2, 64, device="cpu")
    toks = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jc, jaux = jax.jit(jax_model.forward_full, static_argnames="cfg")(
        jp, cfg, tokens=jnp.asarray(toks), cache=jc)
    tl, tc, aux = forward_full(tp, tcfg, tokens=torch.from_numpy(toks),
                               cache=tc)
    _close(tl, jl)
    assert float(jaux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    if arch == "dbrx-132b":
        toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
        jl, jc = jax.jit(jax_model.forward_chunk, static_argnames="cfg")(
            jp, cfg, tokens=jnp.asarray(toks), cache=jc)
        tl, tc = forward_chunk(tp, tcfg, tokens=torch.from_numpy(toks),
                               cache=tc)
        _close(tl, jl)
    else:
        with pytest.raises(NotImplementedError, match="MLA"):
            forward_chunk(tp, tcfg, tokens=torch.zeros((2, 8),
                                                       dtype=torch.int32),
                          cache=tc)
    nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    decode = jax.jit(jax_model.forward_decode, static_argnames="cfg")
    for _ in range(3):
        jl, jc = decode(jp, cfg, tokens=jnp.asarray(nxt), cache=jc)
        tl, tc = forward_decode(tp, tcfg, tokens=torch.from_numpy(nxt),
                                cache=tc)
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
    for i in range(cfg.num_layers):
        for name in _attn_leaves(arch):
            _close(tc["layers"][i][name], jc["layers"][i][name])


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_forwards_match_jax(params, arch):
    """``forward_prefill_paged`` (slot 0 at a whole bucket, slot 1 padded),
    DBRX's ``forward_chunk_paged`` (10 valid rows of 16), three
    ``forward_decode_paged`` steps: logits and the live pages."""
    cfg, tcfg = CFGS[arch], TCFGS[arch]
    jp, tp = params(arch)
    B, MSL, P = 2, 128, 16
    npg = paged_slot_len(cfg, MSL, P) // P
    bt = np.arange(1, 1 + B * npg, dtype=np.int32).reshape(B, npg)
    jc = jax_init_paged_cache(cfg, B, MSL, 1 + B * npg, P)
    jc["block_tables"] = jnp.asarray(bt)
    tc = init_paged_cache(tcfg, B, MSL, 1 + B * npg, P, device="cpu")
    tc["block_tables"] = torch.from_numpy(bt)
    rng = np.random.default_rng(1)
    prefill = jax.jit(jax_model.forward_prefill_paged,
                      static_argnames=("cfg", "slot", "length"))
    for slot, n, pad in ((0, 32, 32), (1, 13, 16)):
        toks = np.zeros((1, pad), np.int32)
        toks[0, :n] = rng.integers(0, cfg.vocab_size, n)
        jl, jc = prefill(jp, cfg, tokens=jnp.asarray(toks), cache=jc,
                         slot=slot, length=n)
        tl, tc = forward_prefill_paged(tp, tcfg,
                                       tokens=torch.from_numpy(toks),
                                       cache=tc, slot=slot, length=n)
        _close(tl, jl)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :10] = rng.integers(0, cfg.vocab_size, 10)
    if arch == "dbrx-132b":
        jl, jc = jax.jit(jax_model.forward_chunk_paged,
                         static_argnames=("cfg", "slot", "length"))(
            jp, cfg, tokens=jnp.asarray(toks), cache=jc, slot=0, length=10)
        tl, tc = forward_chunk_paged(tp, tcfg, tokens=torch.from_numpy(toks),
                                     cache=tc, slot=0, length=10)
        _close(tl, jl)
    else:
        with pytest.raises(NotImplementedError, match="MLA"):
            forward_chunk_paged(tp, tcfg, tokens=torch.from_numpy(toks),
                                cache=tc, slot=0, length=10)
    decode = jax.jit(jax_model.forward_decode_paged, static_argnames="cfg")
    nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    for _ in range(3):
        jl, jc = decode(jp, cfg, tokens=jnp.asarray(nxt), cache=jc)
        tl, tc = forward_decode_paged(tp, tcfg, tokens=torch.from_numpy(nxt),
                                      cache=tc)
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
    for i in range(cfg.num_layers):
        for name in _attn_leaves(arch):
            # page 0, the null page, takes padded rows in no set order
            _close(tc["layers"][i][name][1:],
                   np.asarray(jc["layers"][i][name])[1:])


# ----------------------------------------------------------- engines
@pytest.fixture(scope="module")
def runs(params):
    """Memoized engine runs, ``runs(port, arch, paged, policy,
    discipline)``."""
    memo = {}

    def run(port, arch, paged, policy, discipline):
        key = (port, arch, paged, policy, discipline)
        if key not in memo:
            memo[key] = _run(port, arch, params(arch), paged, policy,
                             discipline)
        return memo[key]
    return run


def _run(port, arch, params, paged, policy, discipline):
    syn = synthetic if port else jax_synthetic
    rt_cls = RuntimeRequest if port else JaxRuntimeRequest
    pairs = syn.sample_serve_workload(6, CFGS[arch].vocab_size, seed=0)
    rts = [rt_cls(request=r, prompt_tokens=p, max_new_tokens=r.output_len)
           for r, p in pairs]
    if port:
        eng = Engine(TCFGS[arch], params[1], paged=paged, device="cpu",
                     **ENGINE_KW)
        pol = policies.make(policy, model=PAPER_TABLE2, max_batch=3)
    else:
        eng = JaxEngine(CFGS[arch], params[0], paged=paged, **ENGINE_KW)
        pol = jax_policies.make(policy, model=JAX_MODEL, max_batch=3)
    out = eng.run_policy(rts, pol, discipline=discipline)
    assert eng.paged is paged
    return out, eng.prefix_stats()


@pytest.mark.parametrize("arch,paged,policy,discipline", [
    (arch, paged, policy, "stall") for arch in ARCHS
    for paged in (True, False)
    for policy in ("fcfs", "slo-reanneal", "slo-preempt")] + [
    ("dbrx-132b", True, "fcfs", "chunked:16")])
def test_engine_tokens_match_jax(runs, arch, paged, policy, discipline):
    got, gstats = runs(True, arch, paged, policy, discipline)
    want, wstats = runs(False, arch, paged, policy, discipline)
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid]["tokens"] == want[rid]["tokens"], rid
        assert got[rid]["preemptions"] == want[rid]["preemptions"], rid
        assert len(got[rid]["tokens"]) > 0
    if discipline != "stall":
        assert gstats == wstats


# ----------------------------------------------------------- training
def test_lm_loss_and_grads_match_jax(params):
    """Reduced DeepSeek (MLA, one dense and one MoE layer): the loss with
    the MoE aux term, and every gradient leaf, the router's included;
    per-layer remat gives the same loss and gradients."""
    cfg, tcfg = CFGS["deepseek-v2-lite-16b"], TCFGS["deepseek-v2-lite-16b"]
    jp, tp = params("deepseek-v2-lite-16b")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels[0, :3] = -100
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, cfg, jnp.asarray(toks),
                              jnp.asarray(labels)), has_aux=True))(jp)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    loss, metrics, grads = loss_and_grads(tcfg, tp, batch, remat=False)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["aux_loss"].detach()),
                               float(want_m["aux_loss"]), rtol=1e-6)
    assert float(want_m["aux_loss"]) > 0
    want_t = from_jax_params(jax.tree.map(np.asarray, want_g), "cpu")
    for g, w in zip(opt.leaves(grads), opt.leaves(want_t)):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    l1, _, g1 = loss_and_grads(tcfg, tp, batch, remat=True)
    assert float(l1) == float(loss)
    assert all(torch.equal(a, b) for a, b in zip(opt.leaves(grads),
                                                 opt.leaves(g1)))
