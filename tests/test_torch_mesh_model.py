"""The port's forwards as ranks of a tensor-parallel mesh (spawned, gloo on
the CPU) against the JAX forwards on one device, float32.

At tp 2 (tp 4: ``test_torch_mesh_model_tp4.py``), on each rank's slice
of the same params: paged whole
prefill, two chunks and three decode steps, and ``forward_full``, within
1e-5 of the JAX logits (the reference's own sharded-vs-single bound,
``tests/helpers/verify_sharding.py``), every rank alike.  Configs: 8 q /
4 kv heads with tied embeddings (heads, MLP and vocabulary split: the
head's logits put back together from each rank's vocabulary rows), the
same untied with a GELU MLP, and the indivisible 6 q / 3 kv heads over a
97-token vocabulary (attention and vocabulary whole on every rank, the
MLP split).  ``moe_ffn`` with a ctx, on both branches (expert parallel:
2 of 4 experts a rank; baseline: every expert, the sequence split)
against the JAX ``moe_ffn`` without one, within 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helpers import torch_mesh_ranks as ranks
from repro.configs import get_reduced
from repro.models import ModelConfig as JaxConfig
from repro.models import init_params
from repro.models.cache import init_paged_cache
from repro.models.model import (forward_chunk_paged, forward_decode_paged,
                                forward_full, forward_prefill_paged)
from repro.models.moe import init_moe, moe_ffn
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.launch.mesh import spawn
from repro_torch.models.config import ModelConfig as PortConfig

TOL = 1e-5
SHAPES = {
    "split": dict(num_layers=2, d_model=64, num_heads=8, num_kv_heads=4,
                  head_dim=8, d_ff=128, vocab_size=96, tie_embeddings=True),
    "split-untied-gelu": dict(num_layers=2, d_model=64, num_heads=8,
                              num_kv_heads=4, head_dim=8, d_ff=128,
                              vocab_size=96, mlp_type="gelu"),
    "kv3": dict(num_layers=2, d_model=48, num_heads=6, num_kv_heads=3,
                head_dim=8, d_ff=96, vocab_size=97),
}
MOE = dataclasses.replace(get_reduced("deepseek-v2-lite-16b"),
                          dtype="float32")
PORT_MOE = dataclasses.replace(port_reduced("deepseek-v2-lite-16b"),
                               dtype="float32")
MOE_X = [np.random.default_rng(s).standard_normal(
    shape).astype(np.float32) for s, shape in
    ((1, (2, 8, MOE.d_model)), (2, (3, 1, MOE.d_model)))]
MOE_CASES = [(ep, i) for ep in (True, False) for i in range(len(MOE_X))]


def _cfgs(name):
    kw = dict(name=f"t-mesh-{name}", family="dense", dtype="float32",
              **SHAPES[name])
    return JaxConfig(**kw), PortConfig(**kw)


_prefill = jax.jit(forward_prefill_paged, static_argnums=(1,),
                   static_argnames=("slot", "length"))
_chunk = jax.jit(forward_chunk_paged, static_argnums=(1,),
                 static_argnames=("slot", "length"))
_decode = jax.jit(forward_decode_paged, static_argnums=(1,))
_full = jax.jit(forward_full, static_argnums=(1,))


def jax_forwards(cfg, params):
    """The steps of ``ranks.paged_forwards`` on the JAX forwards."""
    cache = init_paged_cache(cfg, 4, 128, 33, 16)
    bt = np.zeros((4, 8), np.int32)
    bt[0, :4] = [1, 2, 3, 4]
    bt[1, :4] = [5, 6, 7, 8]
    cache["block_tables"] = jnp.asarray(bt)
    toks = jnp.asarray(np.arange(1, 25, dtype=np.int32)[None])
    out = {}
    lg, cache = _prefill(params, cfg, tokens=toks, cache=cache, slot=0,
                         length=24)
    out["prefill"] = np.asarray(lg)
    ids = np.arange(30, 62, dtype=np.int32)[None]
    if cfg.mla is not None:
        lg, cache = _prefill(params, cfg, tokens=jnp.asarray(ids),
                             cache=cache, slot=1, length=32)
    else:
        for i in range(2):
            lg, cache = _chunk(
                params, cfg, tokens=jnp.asarray(ids[:, 16 * i:16 * (i + 1)]),
                cache=cache, slot=1, length=16)
    out["chunk"] = np.asarray(lg)
    out["decode"] = []
    for feed in ranks.DECODE_FEEDS:
        lg, cache = _decode(
            params, cfg, tokens=jnp.asarray(np.array(feed, np.int32)),
            cache=cache)
        out["decode"].append(np.asarray(lg))
    out["full"] = np.asarray(_full(params, cfg, tokens=toks)[0])
    return out


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in SHAPES:
        jcfg, pcfg = _cfgs(name)
        params = init_params(jax.random.PRNGKey(0), jcfg)
        out[name] = (jcfg, pcfg, jax.tree.map(np.asarray, params),
                     jax_forwards(jcfg, params))
    return out


@pytest.fixture(scope="module")
def moe_block():
    return jax.tree.map(np.asarray,
                        init_moe(jax.random.PRNGKey(3), MOE, jnp.float32))


def spawn_forwards(tp, models, moe=()):
    """Every config of ``models`` (and the MoE cases) on ``tp`` ranks."""
    cases = [(m[1], m[2]) for m in models.values()]
    return spawn(ranks.forward_suite, tp, (cases, moe), device="cpu",
                 threads=1, timeout=60, deadline=180)


@pytest.fixture(scope="module")
def runs(models, moe_block):
    moe = [(PORT_MOE, moe_block, MOE_X[i], ep) for ep, i in MOE_CASES]
    return spawn_forwards(2, models, moe)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    d = float(np.max(np.abs(got - want)))
    assert d <= TOL, d


def check_logits(ranks_out, models, name, what):
    """Each rank's logits within TOL of JAX's, and every rank's alike."""
    want = models[name][3][what]
    i = list(SHAPES).index(name)
    for rank in ranks_out:
        got = rank["forwards"][i][what]
        if what == "decode":
            for g, w in zip(got, want):
                _close(g, w)
        else:
            _close(got, want)
    # every rank put the same whole logits together
    first = ranks_out[0]["forwards"][i][what]
    for rank in ranks_out[1:]:
        assert np.array_equal(np.asarray(rank["forwards"][i][what]),
                              np.asarray(first))


def check_heads(ranks_out, models, tp, name):
    cfg = models[name][1]
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    local = kv // tp if kv % tp == 0 else kv
    for rank in ranks_out:
        res = rank["forwards"][list(SHAPES).index(name)]
        assert res["page_shape"] == (33, 16, local, hd)
        assert res["attn_shapes"]["wk"] == (cfg.d_model, local * hd)


@pytest.mark.parametrize("what", ["prefill", "chunk", "decode", "full"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_logits_match_jax(runs, models, name, what):
    check_logits(runs, models, name, what)


@pytest.mark.parametrize("name", list(SHAPES))
def test_heads_per_rank(runs, models, name):
    """Pages [N, P, kv/tp, hd] and wk columns kv/tp heads where the kv
    heads divide tp; whole ones otherwise (kv 3: the reference's spec
    would cut wk's columns mid-head; the rank holds the whole projection
    and the whole pages)."""
    check_heads(runs, models, 2, name)


@pytest.mark.parametrize("ep,i", MOE_CASES)
def test_moe_ffn_matches_jax(runs, moe_block, ep, i):
    x = MOE_X[i]
    block = jax.tree.map(jnp.asarray, moe_block)
    want, aux = moe_ffn(block, MOE, jnp.asarray(x), None)
    if not ep and x.shape[1] > 1:
        # the baseline splits the sequence: its loss is the mean of the
        # slices' losses, as the reference's pmean over the tp axis
        half = x.shape[1] // 2
        aux = np.mean([float(moe_ffn(block, MOE, jnp.asarray(x[:, s]),
                                     None)[1])
                       for s in (slice(0, half), slice(half, None))])
    for rank in runs:
        got = rank["moe"][MOE_CASES.index((ep, i))]
        _close(got["out"], want)
        assert abs(got["aux"] - float(aux)) <= TOL
        n = MOE.moe.num_experts
        assert got["experts"] == (n // 2 if ep else n)
