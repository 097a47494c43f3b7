"""Port vs JAX reference: multi-head latent attention (MLA, DeepSeek-V2),
in float32 on the CPU.

* ``mla_full`` (expanded prefill: output and the latent it caches),
  ``mla_decode`` over the dense latent ring and ``mla_decode_paged``
  over the pages (absorbed decode in float32), at 1e-6, from the JAX
  ``init_mla`` weights bridged, on seeded numpy inputs; the written
  latent rows equal.
* ``require_ported`` takes the MLA + MoE configs on both layouts; the
  latent caches have the JAX shapes, and ``kv_bytes_per_token`` is the
  reference's.
* No chunked path: an ``Engine`` forces ``chunked_prefill`` to 0, and
  ``run_policy`` under ``chunked:16`` warns as the JAX engine does and
  falls back to stalling prefill (the same tokens as a stalling run, on
  both sides); ``ServeLoop`` refuses the discipline with
  ``UnsupportedDisciplineError``, as the JAX loop does.
* The ``ServeLoop`` on reduced ``deepseek-v2-lite-16b`` (paged, fcfs):
  the JAX loop's greedy tokens per request, overlapped and synchronous
  alike; a fused decode round at width 2 of a 4-slot pool."""
import dataclasses
import warnings

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
from repro.models import attention as jax_attn
from repro.models import init_params as jax_init_params
from repro.models.cache import gather_pages as jax_gather_pages
from repro.models.cache import init_cache as jax_init_cache
from repro.models.cache import init_paged_cache as jax_init_paged_cache
from repro.models.cache import kv_bytes_per_token as jax_kv_bytes
from repro.serving import ServeLoop as JaxServeLoop
from repro.serving import UnsupportedDisciplineError as JaxUnsupported
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.core import policies
from repro_torch.core.latency_model import PAPER_TABLE2
from repro_torch.data import synthetic
from repro_torch.engine.engine import Engine
from repro_torch.engine.request import RuntimeRequest
from repro_torch.models import attention as attn
from repro_torch.models.cache import (gather_pages, init_cache,
                                      init_paged_cache, kv_bytes_per_token,
                                      require_ported)
from repro_torch.models.model import init_params
from repro_torch.serving import ServeLoop, UnsupportedDisciplineError

torch.set_num_threads(2)
ARCH = "deepseek-v2-lite-16b"
CFG = dataclasses.replace(get_reduced(ARCH), dtype="float32")
TCFG = dataclasses.replace(torch_get_reduced(ARCH), dtype="float32")
LAYER_TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    CFG)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.fixture(scope="module")
def layer():
    """One MLA layer's JAX weights and their bridge, and seeded inputs."""
    jp = jax_attn.init_mla(jax.random.PRNGKey(1), CFG, jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    own = attn.init_mla(TCFG, torch.float32, torch.device("cpu"),
                        torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == {
        k: (v.shape, torch.float32) for k, v in jp.items()}
    return jp, tp, np.random.default_rng(0)


def test_mla_full_matches_jax(layer):
    jp, tp, rng = layer
    x = rng.standard_normal((2, 19, CFG.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(19, dtype=np.int32), (2, 19)).copy()
    want, (jckv, jkpe) = jax_attn.mla_full(jp, CFG, jnp.asarray(x),
                                           jnp.asarray(pos))
    got, (ckv, kpe) = attn.mla_full(tp, TCFG, torch.from_numpy(x),
                                    torch.from_numpy(pos))
    assert ckv.shape == (2, 19, CFG.mla.kv_lora_rank)
    assert kpe.shape == (2, 19, CFG.mla.qk_rope_head_dim)
    _close(got, want)
    _close(ckv, jckv)
    _close(kpe, jkpe)


def test_mla_decode_matches_jax(layer):
    """Three steps over a 24-slot ring from ragged lengths (5 and 23: the
    second wraps on its second step)."""
    jp, tp, rng = layer
    m = CFG.mla
    L = 24
    ckv = rng.standard_normal((2, L, m.kv_lora_rank)).astype(np.float32)
    kpe = rng.standard_normal((2, L, m.qk_rope_head_dim)).astype(np.float32)
    jckv, jkpe = jnp.asarray(ckv), jnp.asarray(kpe)
    cache = {"ckv": torch.from_numpy(ckv.copy()),
             "kpe": torch.from_numpy(kpe.copy())}
    pos = np.array([5, 23], np.int32)
    for _ in range(3):
        x = rng.standard_normal((2, 1, CFG.d_model)).astype(np.float32)
        want, jckv, jkpe = jax_attn.mla_decode(
            jp, CFG, jnp.asarray(x), jnp.asarray(pos[:, None]), jckv, jkpe,
            jnp.asarray(pos))
        got, cache = attn.mla_decode(tp, TCFG, torch.from_numpy(x),
                                     torch.from_numpy(pos[:, None]), cache,
                                     torch.from_numpy(pos))
        _close(got, want)
        _close(cache["ckv"], jckv)
        _close(cache["kpe"], jkpe)
        pos = pos + 1


def test_mla_decode_active_keeps_inactive_rows(layer):
    _, tp, rng = layer
    m = CFG.mla
    cache = {"ckv": torch.randn(2, 8, m.kv_lora_rank),
             "kpe": torch.randn(2, 8, m.qk_rope_head_dim)}
    before = {k: v.clone() for k, v in cache.items()}
    x = torch.from_numpy(rng.standard_normal(
        (2, 1, CFG.d_model)).astype(np.float32))
    pos = torch.tensor([3, 3], dtype=torch.int32)
    attn.mla_decode(tp, TCFG, x, pos[:, None], cache, pos,
                    active=torch.tensor([True, False]))
    for k in cache:
        assert torch.equal(cache[k][1], before[k][1])
        assert not torch.equal(cache[k][0, 3], before[k][0, 3])


def test_mla_decode_paged_matches_jax(layer):
    """Three steps through block tables of 4 pages of 8 (slot 1's pages
    out of order), lengths 5 and 30; the live pages equal after."""
    jp, tp, rng = layer
    m = CFG.mla
    N, P = 10, 8
    ckv = rng.standard_normal((N, P, m.kv_lora_rank)).astype(np.float32)
    kpe = rng.standard_normal((N, P, m.qk_rope_head_dim)).astype(np.float32)
    bt = np.array([[1, 2, 3, 4], [9, 5, 7, 6]], np.int32)
    jckv, jkpe = jnp.asarray(ckv), jnp.asarray(kpe)
    tckv, tkpe = torch.from_numpy(ckv.copy()), torch.from_numpy(kpe.copy())
    cache = {"ckv": tckv, "kpe": tkpe}
    pos = np.array([5, 30], np.int32)
    for _ in range(3):
        x = rng.standard_normal((2, 1, CFG.d_model)).astype(np.float32)
        want, jckv, jkpe = jax_attn.mla_decode_paged(
            jp, CFG, jnp.asarray(x), jnp.asarray(pos[:, None]), jckv, jkpe,
            jnp.asarray(bt), jnp.asarray(pos))
        got, cache = attn.mla_decode_paged(
            tp, TCFG, torch.from_numpy(x), torch.from_numpy(pos[:, None]),
            cache, torch.from_numpy(bt), torch.from_numpy(pos))
        _close(got, want)
        pos = pos + 1
    for name, jv in (("ckv", jckv), ("kpe", jkpe)):
        _close(gather_pages(cache[name], torch.from_numpy(bt)),
               jax_gather_pages(jv, jnp.asarray(bt)))


# ------------------------------------------------------------- caches
def test_require_ported_and_latent_caches():
    """MLA + MoE (DeepSeek) and GQA + MoE (DBRX) on both layouts; the
    latent leaves have the JAX shapes and dtypes, and KV bytes per token
    are the reference's: (512 + 64) x 2 B x 27 layers at DeepSeek-V2-
    Lite's published width."""
    for arch in (ARCH, "dbrx-132b"):
        for cfg in (torch_get_config(arch), torch_get_reduced(arch)):
            require_ported(cfg)
            require_ported(cfg, paged=True)
        assert kv_bytes_per_token(torch_get_config(arch)) == jax_kv_bytes(
            get_config(arch))
    assert kv_bytes_per_token(torch_get_config(ARCH)) == (512 + 64) * 2 * 27
    dense = init_cache(TCFG, 3, 40, device="cpu")
    paged = init_paged_cache(TCFG, 3, 40, 7, 16, device="cpu")
    for got, want in ((dense, jax_init_cache(CFG, 3, 40)),
                      (paged, jax_init_paged_cache(CFG, 3, 40, 7, 16))):
        for tl, jl in zip(got["layers"], want["layers"]):
            assert sorted(tl) == sorted(jl) == ["ckv", "kpe"]
            for k in tl:
                assert tuple(tl[k].shape) == jl[k].shape
                assert str(tl[k].dtype).replace("torch.", "") == \
                    str(jl[k].dtype)
        assert tuple(got["block_tables" if "block_tables" in got
                         else "pos"].shape) == \
            want["block_tables" if "block_tables" in want else "pos"].shape


# ---------------------------------------------------- no chunked path
def _rts(port, n=4, seed=0):
    syn = synthetic if port else jax_synthetic
    rt_cls = RuntimeRequest if port else JaxRuntimeRequest
    return [rt_cls(request=r, prompt_tokens=p, max_new_tokens=r.output_len)
            for r, p in syn.sample_serve_workload(n, CFG.vocab_size,
                                                  seed=seed)]


@pytest.mark.parametrize("paged", [True, False])
def test_chunked_discipline_falls_back_to_stall(params, paged):
    """Both engines force ``chunked_prefill`` to 0, warn alike on a
    chunked discipline and serve it as a stalling run."""
    out = {}
    for port in (True, False):
        if port:
            eng = Engine(TCFG, params[1], max_slots=3, max_seq_len=256,
                         paged=paged, chunked_prefill=32, device="cpu")
            pol = lambda: policies.make("fcfs", model=PAPER_TABLE2,  # noqa
                                        max_batch=3)
        else:
            eng = JaxEngine(CFG, params[0], max_slots=3, max_seq_len=256,
                            paged=paged, chunked_prefill=32)
            pol = lambda: jax_policies.make("fcfs",  # noqa: E731
                                            model=JAX_MODEL, max_batch=3)
        assert eng.chunked_prefill == 0 and eng.prefix is None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            chunked = eng.run_policy(_rts(port), pol(),
                                     discipline="chunked:16")
        stall = eng.run_policy(_rts(port), pol(), discipline="stall")
        out[port] = ([str(w.message) for w in caught
                      if "MLA" in str(w.message)],
                     {r: v["tokens"] for r, v in chunked.items()},
                     {r: v["tokens"] for r, v in stall.items()})
    (msgs, chunked, stall), (jmsgs, jchunked, jstall) = out[True], out[False]
    assert msgs == jmsgs and len(msgs) == 1
    assert "falling back to whole-prompt (stalling) prefill" in msgs[0]
    assert chunked == stall == jchunked == jstall


def test_serve_loop_refuses_chunked(params):
    for discipline in ("chunked:16", "chunked"):
        with pytest.raises(UnsupportedDisciplineError, match="MLA"):
            ServeLoop(Engine(TCFG, params[1], max_slots=2, max_seq_len=128,
                             device="cpu"), "fcfs", model=PAPER_TABLE2,
                      discipline=discipline)
        with pytest.raises(JaxUnsupported, match="MLA"):
            JaxServeLoop(JaxEngine(CFG, params[0], max_slots=2,
                                   max_seq_len=128), "fcfs",
                         model=JAX_MODEL, discipline=discipline)


# -------------------------------------------------------- serve loop
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
    got, loop = _serve(True, params)
    sync, _ = _serve(True, params, overlap=False)
    want, _ = _serve(False, params)
    assert got == sync == want
    assert all(len(t) > 0 for t in got.values())
    assert loop.metrics.summary()["overlap_frac"] > 0


def test_dispatch_decode_at_a_slot_prefix(params):
    """A fused round at width 2 of a 4-slot paged pool (slot 1 idle):
    the latent pages pass through whole, slot 0's token lands in its
    page, and ``pos`` moves for slot 0 only."""
    eng = Engine(TCFG, params[1], max_slots=4, max_seq_len=128,
                 device="cpu")
    rts = _rts(True, n=2, seed=3)
    for slot, rt in enumerate(rts):
        rt.prompt_tokens = rt.prompt_tokens[:20]
        eng.begin_prefill(rt, slot)
        eng.prefill_step(rt)
    view = eng._slice_slots(eng.cache, 2)
    assert all(v["ckv"] is layer["ckv"] and v["kpe"] is layer["kpe"]
               for v, layer in zip(view["layers"], eng.cache["layers"]))
    pos = eng.cache["pos"].clone()
    page = eng.cache["block_tables"][0, int(pos[0]) // eng.block_size]
    row = eng.cache["layers"][0]["ckv"][page, int(pos[0]) % eng.block_size]
    before = row.clone()
    feed = torch.zeros((4, 1), dtype=torch.int32)
    feed[0, 0] = rts[0].generated[-1]
    toks = eng.dispatch_decode(feed, np.array([True, False, False, False]),
                               width=2)
    assert toks.shape == (2,)
    assert not torch.equal(before, eng.cache["layers"][0]["ckv"][
        page, int(pos[0]) % eng.block_size])
    assert eng.cache["pos"].tolist() == [pos[0] + 1] + pos[1:].tolist()


def test_init_params_bridge_keeps_float32_router_and_kv_norm(params):
    jp, tp = params
    moe_layer = tp["layers"][1]["moe"]
    assert moe_layer["router"].dtype == torch.float32
    assert set(moe_layer["shared"]) == {"w_gate", "w_up", "w_down"}
    assert tp["layers"][0]["attn"]["kv_norm"].dtype == torch.float32
    own = init_params(dataclasses.replace(TCFG, dtype="bfloat16"), seed=0,
                      device="cpu")
    assert own["layers"][1]["moe"]["router"].dtype == torch.float32
    assert own["layers"][1]["moe"]["w_gate"].dtype == torch.bfloat16
    assert own["layers"][0]["attn"]["kv_norm"].dtype == torch.float32
