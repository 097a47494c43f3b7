"""The port's batched annealer (``repro_torch.core.annealing_torch`` and
the plain version of its kernel, ``repro_torch.kernels.anneal``) against
the reference ``repro.core.annealing_jax`` on the CPU, on the
docs/annealer.md contract:

* scorer parity — after chains of valid moves the incremental stats
  score a schedule as the full objective, the JAX helpers and numpy
  ``evaluate`` do (met counts exact, G to 1e-6 relative in float64, the
  rows equal to a fresh build), at two pad lengths;
* trajectory parity — fed the reference's own proposal stream (its
  ``_sample_move`` split chain replayed from the same keys), the plain
  anneal returns the reference's best schedule per chain with G to 1e-9
  relative in float64, on both scoring paths;
* vmap equivalence — the multi-instance front end equals per-instance
  runs on the same per-instance draws;
* invariants — no schedule loses to either starting solution, and the
  config raises exactly where the reference raises.

A best schedule "equals" the reference's when its boundaries are the
same and its permutation is the same, or, where a swap inside one batch
left G equal (the two frameworks add a batch's members in another order
and so break that tie apart), the same requests sit in each batch and G
agrees to 1e-12 relative: a batch is a set, so both are one schedule."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.annealing_jax as aj
from repro.core import SAParams as JaxSAParams
from repro.core.latency_model import PAPER_TABLE2 as JAX_MODEL
from repro.core.objective import fcfs_schedule, sorted_by_e2e_schedule
from repro.core.slo import as_arrays
from repro.data.synthetic import sample_requests
from repro_torch.core import annealing_torch as at
from repro_torch.core.annealing import SAParams
from repro_torch.core.latency_model import PAPER_TABLE2
from repro_torch.core.objective import evaluate
from repro_torch.kernels import _build, anneal as ka, ops

torch.set_num_threads(2)
F64 = torch.float64
N, MB = 13, 4
CFG = dict(iters=3, num_chains=4)


def _arrays(seed, n=N, regime="contended"):
    """The reference test's workload: the paper's request mix, SLOs
    tightened in the contended regime so schedules mix met and unmet."""
    reqs = sample_requests(n, seed=seed)
    for r in reqs:
        if regime == "contended":
            r.slo = dataclasses.replace(
                r.slo, e2e=r.slo.e2e * 0.2 if r.slo.e2e else None,
                ttft=r.slo.ttft * 0.02 if r.slo.ttft else None,
                tpot=r.slo.tpot * 0.5 if r.slo.tpot else None)
        r.predicted_output_len = r.output_len
    return as_arrays(reqs)


def _np_g(arrays, perm, bnd, n):
    perm, bid = aj._extract(np.asarray(perm), np.asarray(bnd), n)
    return evaluate(arrays, PAPER_TABLE2, perm, bid)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ scorers
@pytest.fixture(scope="module")
def jitted():
    nv = jnp.int32(N)
    return {"cand": jax.jit(lambda reqc, perm, bnd, stats, op, i, j:
                            aj._candidate(reqc, perm, bnd, stats, op, i, j,
                                          nv, MB)),
            "agg": jax.jit(lambda stats: aj._agg(stats, MB)),
            "build": jax.jit(lambda reqc, perm, bnd:
                             aj._build_stats(reqc, perm, bnd, MB))}


@pytest.mark.parametrize("regime", ["contended", "loose"])
def test_incremental_scorer_matches_oracles(jitted, regime):
    """float64: after a chain of valid moves the incremental stats score
    the schedule as the port's full objective, the JAX helpers and numpy
    ``evaluate`` (G to 1e-6 relative, met exactly; the two frameworks'
    G to 1e-12), the candidate's delta score equals the committed
    score, and every row equals a fresh build."""
    with jax.enable_x64(True):
        for seed in (0, 1):
            arrays = _arrays(seed, regime=regime)
            pad = aj._pad_len(N)
            jreqc = aj._pack(arrays, JAX_MODEL, pad)
            reqc = at._pack(arrays, PAPER_TABLE2, pad, F64)
            np.testing.assert_array_equal(reqc.numpy(), np.asarray(jreqc))
            nv = torch.tensor(N)
            perm_s, perm, bnd = at._starts(reqc, nv, MB)
            jps, jpa, jb0 = aj._starts(jreqc, jnp.int32(N), MB)
            np.testing.assert_array_equal(perm_s.numpy(), np.asarray(jps))
            np.testing.assert_array_equal(bnd.numpy(), np.asarray(jb0))
            stats = at._build_stats(reqc, perm, bnd, MB)
            jperm, jbnd = jpa, jb0
            rng = np.random.default_rng(seed)
            applied = 0
            for _ in range(60):
                op, i, j = (int(rng.integers(0, 3)), int(rng.integers(1, N)),
                            int(rng.integers(0, N)))
                ok, _, upd = at._candidate(reqc, perm, bnd, stats,
                                           *map(torch.tensor, (op, i, j)),
                                           nv, MB)
                jok, _, _ = jitted["cand"](jreqc, jperm, jbnd,
                                           jitted["build"](jreqc, jperm,
                                                           jbnd),
                                           jnp.int32(op), jnp.int32(i),
                                           jnp.int32(j))
                assert bool(ok) == bool(jok)
                g_delta, met_delta = at._agg_delta(stats, upd[4], upd[5], MB)
                if not bool(ok):
                    continue
                applied += 1
                perm, bnd, stats = at._apply(perm, bnd, stats, upd,
                                             torch.tensor(True))
                ok2, jperm, jbnd = aj._structural(
                    jperm, jbnd, jnp.int32(op), jnp.int32(i), jnp.int32(j),
                    jnp.int32(N), MB)
                assert bool(ok2)
                np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
                np.testing.assert_array_equal(bnd.numpy(), np.asarray(jbnd))
                g_inc, met_inc = at._agg(stats, MB)
                g_full, met_full = at._eval_g(reqc, perm, bnd)
                jg, jmet = jitted["agg"](jitted["build"](jreqc, jperm, jbnd))
                ev = _np_g(arrays, perm, bnd, N)
                scale = max(ev.G, 1e-9)
                assert float(g_delta) == float(g_inc)
                assert int(met_delta) == int(met_inc)
                assert abs(float(g_inc) - float(g_full)) <= 1e-9 * scale
                assert abs(float(g_inc) - ev.G) <= 1e-6 * scale
                assert abs(float(g_inc) - float(jg)) <= 1e-12 * scale
                assert int(met_inc) == int(met_full) == int(jmet) == ev.n_met
                fresh = at._build_stats(reqc, perm, bnd, MB)
                for got, want in zip(stats, fresh):
                    np.testing.assert_array_equal(got.numpy(), want.numpy())
            assert applied > 20          # the move stream was exercised


def test_scorer_padding_invariance():
    """Masked padding does not change the objective: one instance packed
    at two pad lengths scores the same, and as numpy does."""
    arrays = _arrays(3)
    p0, b0 = fcfs_schedule(N, MB)
    for pad in (16, 32):
        reqc = at._pack(arrays, PAPER_TABLE2, pad, F64)
        perm = _t(np.concatenate([p0, np.arange(N, pad)]))
        bnd = _t(np.concatenate([b0 != np.concatenate([[-1], b0[:-1]]),
                                 np.ones(pad - N, bool)]))
        g, met = at._agg(at._build_stats(reqc, perm, bnd, MB), MB)
        g_full, met_full = at._eval_g(reqc, perm, bnd)
        ev = _np_g(arrays, perm, bnd, N)
        assert abs(float(g) - ev.G) <= 1e-6 * max(ev.G, 1e-9)
        assert abs(float(g_full) - ev.G) <= 1e-6 * max(ev.G, 1e-9)
        assert int(met) == int(met_full) == ev.n_met


def test_pack_is_the_reference_pack_in_float32():
    """float32 by default (JAX without x64): the float64 columns cast
    once, padding rows zero with VALID = 0."""
    arrays = _arrays(5)
    reqc = at._pack(arrays, PAPER_TABLE2, 16)
    assert reqc.dtype == torch.float32
    np.testing.assert_array_equal(reqc.numpy(),
                                  np.asarray(aj._pack(arrays, JAX_MODEL, 16)))
    assert (reqc[N:, at._VALID] == 0).all()
    assert (reqc[:N, at._VALID] == 1).all()


# ---------------------------------------------------------- trajectories
@functools.lru_cache(maxsize=None)
def _replay(n_prop):
    """The reference's proposal stream: ``_sample_move``'s split chain,
    one 4-uniform draw per proposal, from each chain's key."""
    def one(key):
        def step(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.uniform(sub, (4,))
        return jax.lax.scan(step, key, None, length=n_prop)[1]
    return jax.jit(jax.vmap(one))


def _same_schedules(perms, bnds, gs, jperms, jbnds, jgs):
    """Per chain: the same boundaries, the same permutation or (a tie
    inside one batch) the same batches as sets with G to 1e-12, and G to
    1e-9 relative.  Returns the number of identical permutations."""
    exact = 0
    for p, b, g, jp, jb, jg in zip(perms, bnds, gs, np.asarray(jperms),
                                   np.asarray(jbnds), np.asarray(jgs)):
        p, b = np.asarray(p), np.asarray(b)
        assert abs(float(g) - float(jg)) <= 1e-9 * abs(float(jg))
        np.testing.assert_array_equal(b, jb)
        if (p == jp).all():
            exact += 1
            continue
        bid = np.cumsum(b) - 1
        assert all(sorted(p[bid == k]) == sorted(jp[bid == k])
                   for k in range(bid[-1] + 1))
        assert abs(float(g) - float(jg)) <= 1e-12 * abs(float(jg))
    return exact


@pytest.mark.parametrize("incremental", [True, False])
@pytest.mark.parametrize("mb", [1, 4, 8])
@pytest.mark.parametrize("n", [5, 13, 40])
def test_plain_anneal_follows_the_reference_trajectory(n, mb, incremental):
    """float64, JAX's own proposal stream: the plain anneal returns
    ``_run_chains``' best schedule and G for every chain, in both SLO
    regimes."""
    cfg = aj.JaxSAConfig(**CFG)
    tcfg = at.TorchSAConfig(**CFG)
    n_prop = at.n_proposals(tcfg, F64)
    exact = chains = 0
    with jax.enable_x64(True):
        for seed, regime in ((0, "contended"), (1, "loose")):
            arrays = _arrays(seed, n, regime)
            pad = aj._pad_len(n)
            keys = jax.random.split(jax.random.PRNGKey(seed), cfg.num_chains)
            jperms, jbnds, jgs = aj._run_chains(
                keys, aj._pack(arrays, JAX_MODEL, pad), jnp.int32(n), mb,
                cfg, incremental)
            draws = _t(_replay(n_prop)(keys))
            assert draws.dtype == F64
            perms, bnds, gs = at._run_chains(
                draws, at._pack(arrays, PAPER_TABLE2, pad, F64), n, mb, tcfg,
                incremental)
            assert perms.dtype == torch.int32 and bnds.dtype == torch.bool
            exact += _same_schedules(perms, bnds, gs, jperms, jbnds, jgs)
            chains += cfg.num_chains
    assert exact >= chains - 1


@pytest.mark.parametrize("incremental", [True, False])
def test_plain_multi_anneal_follows_the_reference(incremental):
    """Ragged instances with an empty one, instances x chains in one call:
    ``_run_chains_multi``'s best schedules and G, each instance on the
    stream of ``fold_in(PRNGKey(seed), i)``."""
    sizes = (9, 0, 16, 5)
    cfg = aj.JaxSAConfig(**CFG)
    tcfg = at.TorchSAConfig(**CFG)
    n_prop = at.n_proposals(tcfg, F64)
    with jax.enable_x64(True):
        arrays = [_arrays(100 + k, n) for k, n in enumerate(sizes)]
        pad = aj._pad_len(max(sizes))
        base = jax.random.PRNGKey(7)
        keys = jnp.stack([jax.random.split(jax.random.fold_in(base, i),
                                           cfg.num_chains)
                          for i in range(len(sizes))])
        jres = aj._run_chains_multi(
            keys, jnp.stack([aj._pack(a, JAX_MODEL, pad) for a in arrays]),
            jnp.asarray(sizes, jnp.int32), MB, cfg, incremental)
        draws = torch.stack([_t(_replay(n_prop)(k)) for k in keys])
        res = at._run_chains_multi(
            draws, torch.stack([at._pack(a, PAPER_TABLE2, pad, F64)
                                for a in arrays]),
            torch.tensor(sizes, dtype=torch.int32), MB, tcfg, incremental)
        exact = sum(_same_schedules(*(r[i] for r in res),
                                    *(r[i] for r in jres))
                    for i in range(len(sizes)))
    assert exact >= len(sizes) * cfg.num_chains - 1


@pytest.mark.parametrize("incremental", [True, False])
def test_float32_g_is_numpy_evaluate(incremental):
    """float32 (the card's dtype) on the CPU: the returned G is numpy
    ``evaluate`` of the returned schedule to 1e-5 relative."""
    for seed, n in ((0, 13), (1, 40)):
        arrays = _arrays(seed, n)
        perm, bid, g = at.priority_mapping_torch(
            arrays, PAPER_TABLE2, MB, at.TorchSAConfig(**CFG), seed=seed,
            incremental=incremental, device="cpu")
        ev = evaluate(arrays, PAPER_TABLE2, perm, bid)
        assert abs(ev.G - g) <= 1e-5 * ev.G


# ----------------------------------------------------------- front ends
def test_multi_front_end_equals_single_instance_runs():
    """One (instances x chains) call equals each padded instance run
    alone on the same per-instance draws (the padding and masking do the
    work of the per-instance loop)."""
    sizes = (9, 16, 5)
    tcfg = at.TorchSAConfig(**CFG)
    arrays = [_arrays(100 + k, n) for k, n in enumerate(sizes)]
    multi = at.priority_mapping_multi_torch(arrays, PAPER_TABLE2, MB, tcfg,
                                            seed=7, device="cpu")
    pad = at._pad_len(max(sizes))
    for i, (a, n) in enumerate(zip(arrays, sizes)):
        draws = at.make_draws([at.instance_seed(7, i)], tcfg)[0]
        perms, bnds, gs = at._run_chains(
            draws, at._pack(a, PAPER_TABLE2, pad), n, MB, tcfg, True)
        best = int(torch.argmax(gs))
        perm, bid = at._extract(perms[best], bnds[best], n)
        m_perm, m_bid, m_g = multi[i]
        np.testing.assert_array_equal(m_perm, perm)
        np.testing.assert_array_equal(m_bid, bid)
        assert m_g == float(gs[best])
        assert sorted(m_perm.tolist()) == list(range(n))
        assert np.bincount(m_bid).max() <= MB


def test_multi_handles_empty_and_ragged():
    out = at.priority_mapping_multi_torch(
        [_arrays(0, n=6), as_arrays([]), _arrays(1, n=16)], PAPER_TABLE2, MB,
        at.TorchSAConfig(**CFG), seed=0, device="cpu")
    assert len(out) == 3
    assert out[1][0].size == 0 and out[1][2] == 0.0
    for (perm, bid, _), n in zip((out[0], out[2]), (6, 16)):
        assert sorted(perm.tolist()) == list(range(n))
    assert at.priority_mapping_multi_torch([], PAPER_TABLE2, MB,
                                           device="cpu") == []


@pytest.mark.parametrize("incremental", [True, False])
def test_no_schedule_loses_to_a_starting_solution(incremental):
    """Both scoring paths return valid schedules that never lose to
    either Algorithm 1 starting solution."""
    for seed in (0, 1):
        arrays = _arrays(seed, n=16)
        p0, b0 = fcfs_schedule(16, MB)
        ps, bs = sorted_by_e2e_schedule(arrays, PAPER_TABLE2, MB)
        g_start = max(evaluate(arrays, PAPER_TABLE2, p0, b0).G,
                      evaluate(arrays, PAPER_TABLE2, ps, bs).G)
        perm, bid, g = at.priority_mapping_torch(
            arrays, PAPER_TABLE2, MB, at.TorchSAConfig(iters=20, num_chains=2),
            seed=seed, incremental=incremental, device="cpu")
        ev = evaluate(arrays, PAPER_TABLE2, perm, bid)
        assert sorted(perm.tolist()) == list(range(16))
        assert np.bincount(bid).max() <= MB
        assert ev.G >= g_start * (1 - 1e-5)


BAD_CONFIGS = [dict(num_chains=0), dict(iters=0), dict(tau=1.0),
               dict(tau=0.0), dict(T0=0.0), dict(T_thres=-1.0),
               dict(T0=100.0, T_thres=200.0), dict(T0=20.0, T_thres=20.0),
               dict(), dict(iters=1, num_chains=1, tau=0.5)]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=str)
def test_config_raises_where_the_reference_raises(kw):
    try:
        want = aj.JaxSAConfig(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            at.TorchSAConfig(**kw)
        assert str(got.value) == str(e)
        return
    cfg = at.TorchSAConfig(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.n_levels == want.n_levels
    assert at.temperature_levels(cfg.T0, cfg.T_thres, cfg.tau, F64) == \
        want.n_levels


@pytest.mark.parametrize("kw", [
    dict(), dict(iters=100, budget_mode="per_level"), dict(iters=7),
    dict(T0=50.0, T_thres=5.0, tau=0.8), dict(moves=(2,)),
    dict(moves=(0, 1)), dict(acceptance="greedy")], ids=str)
def test_config_from_sa_params_matches_the_reference(kw):
    """The global budget spread over the levels, per_level kept, and the
    ablation knobs refused exactly as the reference refuses them."""
    try:
        want = aj.config_from_sa_params(JaxSAParams(**kw), num_chains=3)
    except ValueError:
        with pytest.raises(ValueError, match="ablation"):
            at.config_from_sa_params(SAParams(**kw), num_chains=3)
        return
    got = at.config_from_sa_params(SAParams(**kw), num_chains=3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_front_ends_validate_and_need_a_card_unless_asked():
    arrays = _arrays(0)
    with pytest.raises(ValueError, match="max_batch"):
        at.priority_mapping_torch(arrays, PAPER_TABLE2, 0, device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        at.priority_mapping_multi_torch([arrays], PAPER_TABLE2, -1,
                                        device="cpu")
    with pytest.raises(TypeError, match="TorchSAConfig"):
        at.priority_mapping_torch(arrays, PAPER_TABLE2, 4,
                                  aj.JaxSAConfig(), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        at.priority_mapping_torch(arrays, PAPER_TABLE2, 4)


def test_draws_are_sized_by_the_working_dtype_recursion():
    """``draws`` holds iters proposals for every level of the loop's own
    ``T *= tau`` in the working dtype, and the plain anneal refuses a
    stream too short for its schedule."""
    cfg = at.TorchSAConfig(iters=2, num_chains=3)
    d = at.make_draws([0, 1], cfg)
    assert d.shape == (2, 3, at.temperature_levels(500.0, 20.0, 0.95) * 2, 4)
    assert d.dtype == torch.float32 and 0 <= float(d.min()) < \
        float(d.max()) < 1
    assert torch.equal(d[1], at.make_draws([1], cfg)[0])
    reqc = at._pack(_arrays(0), PAPER_TABLE2, 16)[None]
    with pytest.raises(ValueError, match="proposals a chain"):
        ka.anneal_chains_plain(reqc, torch.tensor([N]), d[:1, :, :5], MB,
                               cfg.T0, cfg.T_thres, cfg.tau, cfg.iters)


def test_ops_dispatch_by_device_and_cuda_wrapper_refuses_float64():
    """A CPU tensor runs the plain version (no launch counted); the CUDA
    wrapper takes float32 only, and says so before touching a card."""
    cfg = at.TorchSAConfig(**CFG)
    reqc = at._pack(_arrays(0), PAPER_TABLE2, 16)[None]
    draws = at.make_draws([0], cfg)
    nv = torch.tensor([N], dtype=torch.int32)
    ops.reset_launch_counts()
    got = ops.anneal_chains(reqc, nv, draws, MB, cfg.T0, cfg.T_thres,
                            cfg.tau, cfg.iters)
    want = ka.anneal_chains_plain(reqc, nv, draws, MB, cfg.T0, cfg.T_thres,
                                  cfg.tau, cfg.iters)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts()["anneal"] == 0
    assert _build.SOURCES["anneal"] == "anneal"
    with pytest.raises(TypeError, match="float32"):
        ka.anneal_chains_cuda(reqc.double(), nv, draws.double(), MB,
                              cfg.T0, cfg.T_thres, cfg.tau, cfg.iters)
    with pytest.raises(ValueError, match="CUDA|cuda"):
        ka.anneal_chains_cuda(reqc, nv, draws, MB, cfg.T0, cfg.T_thres,
                              cfg.tau, cfg.iters)


@pytest.mark.parametrize("bad", ["reqc_cols", "draws_rank", "n_valid_dtype",
                                 "n_valid_shape"])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """The CUDA wrapper checks shapes and dtypes before it builds or
    launches anything: a wrong input raises ValueError here, on a
    machine without a card."""
    cfg = at.TorchSAConfig(**CFG)
    reqc = at._pack(_arrays(0), PAPER_TABLE2, 16)[None]
    draws = at.make_draws([0], cfg)
    nv = torch.tensor([N], dtype=torch.int32)
    if bad == "reqc_cols":
        reqc = reqc[..., :-1].contiguous()
    elif bad == "draws_rank":
        draws = draws[0]
    elif bad == "n_valid_dtype":
        nv = nv.long()
    elif bad == "n_valid_shape":
        nv = torch.tensor([N, N], dtype=torch.int32)
    want = {"reqc_cols": "reqc must be", "draws_rank": "draws must be",
            "n_valid_dtype": "n_valid must be",
            "n_valid_shape": "n_valid must be"}[bad]
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match=want):
        ka.anneal_chains_cuda(reqc, nv, draws, MB, cfg.T0, cfg.T_thres,
                              cfg.tau, cfg.iters)
    assert dict(_build.LAUNCHES) == before
