"""The port's partition rules (``repro_torch.distributed.sharding``) against
the JAX package's (``repro.distributed.sharding``), with no process.

For every arch of ``repro.configs.ASSIGNED`` at its published width,
``param_specs`` equal leaf by leaf on the meshes (16, 16), (1, 2), (1, 4)
and (1, 8), with FSDP on and off; the JAX side reads ``jax.eval_shape``
params through a shape-only mesh, the port's meta-device tensors.  The
same for ``cache_specs`` on the dense and the paged layout, and for the
reference's paged cases (kv 8 sharded on the head axis, the indivisible
kv 3 replicated at tp 2).  The per-rank shapes ``shard_params`` and the
sharded ``init_paged_cache`` produce equal the spec arithmetic on each
mesh's first and last rank."""
import dataclasses
import functools
import math

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import ASSIGNED, get_config
from repro.distributed import sharding as jsh
from repro.models import ModelConfig as JaxConfig
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models.cache import init_paged_cache as jax_paged_cache
from repro_torch.configs import get_config as port_config
from repro_torch.distributed import sharding as psh
from repro_torch.launch.mesh import Mesh, coords_of, make_production_mesh
from repro_torch.models.cache import cache_spec as port_cache_spec
from repro_torch.models.cache import init_paged_cache as port_paged_cache
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.layers import heads_split
from repro_torch.models.model import init_params as port_init_params

MESHES = {"16x16": {"data": 16, "model": 16}, "1x2": {"data": 1, "model": 2},
          "1x4": {"data": 1, "model": 4}, "1x8": {"data": 1, "model": 8}}
SMALL = ("1x2", "1x4", "1x8")
BATCH, MAX_LEN, SLOTS, BLOCKS = 128, 1024, 8, 513


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    return jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                  get_config(arch)))


@functools.lru_cache(maxsize=None)
def port_params(arch):
    return port_init_params(port_config(arch), device="meta")


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return getattr(k, attr)
    return str(k)


def flat_jax(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(_key(k) for k in path): v for path, v in leaves}


def flat_port(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat_port(tree[k], path + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat_port(v, path + (i,)))
        return out
    return {path: tree}


def assert_same_specs(port, ref):
    got, want = flat_port(port), flat_jax(ref)
    assert sorted(got) == sorted(want)
    for path in want:
        assert isinstance(got[path], psh.P), path
        assert tuple(got[path]) == tuple(want[path]), \
            (path, got[path], want[path])


def test_parallelism_config_matches_reference():
    fields = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)]
    assert fields(psh.ParallelismConfig) == fields(jsh.ParallelismConfig)
    for fsdp in (True, False):
        assert psh.ParallelismConfig(fsdp=fsdp).fsdp_spec == \
            jsh.ParallelismConfig(fsdp=fsdp).fsdp_spec


def test_partition_spec_normalized_as_jax():
    for entries in ((("data",), "model"), (None, None), (),
                    (("pod", "data"), None, "model")):
        assert tuple(psh.P(*entries)) == tuple(JP(*entries))


def test_meshes_and_coordinates():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}
    shape = {"data": 2, "model": 4}
    assert [coords_of(r, shape)["model"] for r in range(8)] == \
        [0, 1, 2, 3] * 2
    assert Mesh(shape, rank=5).coords == {"data": 1, "model": 1}


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_specs_match_reference(arch, mesh, fsdp):
    shape = MESHES[mesh]
    ref = jsh.param_specs(jax_params(arch), get_config(arch),
                          FakeMesh(shape), jsh.ParallelismConfig(fsdp=fsdp))
    got = psh.param_specs(port_params(arch), port_config(arch),
                          Mesh(shape), psh.ParallelismConfig(fsdp=fsdp))
    assert_same_specs(got, ref)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_cache_specs_match_reference(arch, mesh, layout):
    jcfg, pcfg = get_config(arch), port_config(arch)
    if layout == "paged" and not jcfg.attn_layers:
        # an attention-free stack has no pages (require_ported): take
        # the hybrid's instead
        jcfg, pcfg = get_config("zamba2-1.2b"), port_config("zamba2-1.2b")
    shape = MESHES[mesh]
    if layout == "dense":
        jshapes = jax.eval_shape(lambda: jax_init_cache(jcfg, BATCH,
                                                        MAX_LEN))
        pshapes = port_cache_spec(pcfg, BATCH, MAX_LEN)
    else:
        jshapes = jax.eval_shape(lambda: jax_paged_cache(
            jcfg, SLOTS, MAX_LEN, BLOCKS, 16))
        pshapes = port_paged_cache(pcfg, SLOTS, MAX_LEN, BLOCKS, 16,
                                   device="meta")
    ref = jsh.cache_specs(jshapes, jcfg, FakeMesh(shape),
                          jsh.ParallelismConfig(), BATCH)
    got = psh.cache_specs(pshapes, pcfg, Mesh(shape),
                          psh.ParallelismConfig(), BATCH)
    assert_same_specs(got, ref)


def _paged_cfgs(kv):
    kw = dict(name="t-paged", family="dense", num_layers=2, d_model=8 * kv,
              num_heads=kv, num_kv_heads=kv, head_dim=8, d_ff=32,
              vocab_size=97, dtype="float32")
    return JaxConfig(**kw), PortConfig(**kw)


@pytest.mark.parametrize("kv,want", [(8, (None, None, "model", None)),
                                     (3, (None, None, None, None))])
def test_paged_head_sharding_and_indivisible_heads(kv, want):
    """The reference's paged cases (``tests/test_sharding.py``): kv 8
    shards the page arrays' head axis at tp 2, kv 3 replicates them;
    ``pos`` and ``block_tables`` stay whole.  The port's sharded pool
    holds 4 or all 3 heads a rank."""
    jcfg, pcfg = _paged_cfgs(kv)
    shape = {"data": 1, "model": 2}
    jshapes = jax.eval_shape(lambda: jax_paged_cache(jcfg, 4, 128, 33, 16))
    ref = jsh.cache_specs(jshapes, jcfg, FakeMesh(shape),
                          jsh.ParallelismConfig(), 4)
    pshapes = port_paged_cache(pcfg, 4, 128, 33, 16, device="meta")
    got = psh.cache_specs(pshapes, pcfg, Mesh(shape),
                          psh.ParallelismConfig(), 4)
    assert_same_specs(got, ref)
    assert tuple(got["pos"]) == (None,)
    assert tuple(got["block_tables"]) == (None, None)
    for layer in got["layers"]:
        assert tuple(layer["k"]) == tuple(layer["v"]) == want
    for r in range(2):
        mine = port_paged_cache(pcfg, 4, 128, 33, 16, device="meta",
                                mesh=Mesh(shape, rank=r))
        assert mine["layers"][0]["k"].shape == \
            (33, 16, kv // 2 if kv % 2 == 0 else kv, 8)
        assert mine["block_tables"].shape == (4, 8)


def arithmetic(shape, spec, mesh_shape):
    """A leaf's per-rank shape from a JAX spec: each dim over the product
    of its axes' sizes."""
    out = []
    for d, n in enumerate(shape):
        axes = spec[d] if d < len(spec) else None
        if axes is None:
            out.append(n)
            continue
        axes = (axes,) if isinstance(axes, str) else axes
        out.append(n // math.prod(mesh_shape[a] for a in axes))
    return tuple(out)


@pytest.mark.parametrize("mesh", SMALL)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_shard_shapes_equal_spec_arithmetic(arch, mesh):
    """``shard_params`` under the port's specs, and the sharded
    ``init_paged_cache``, give each rank the shapes the JAX specs'
    arithmetic gives (serving parallelism: tp on "model", no FSDP)."""
    shape = MESHES[mesh]
    jcfg, pcfg = get_config(arch), port_config(arch)
    jpar, ppar = jsh.ParallelismConfig(fsdp=False), \
        psh.ParallelismConfig(fsdp=False)
    jspecs = flat_jax(jsh.param_specs(jax_params(arch), jcfg,
                                      FakeMesh(shape), jpar))
    full = port_params(arch)
    tp = shape["model"]
    paged = bool(jcfg.attn_layers)
    if paged:
        jcache = jax.eval_shape(lambda: jax_paged_cache(jcfg, SLOTS, MAX_LEN,
                                                        BLOCKS, 16))
        jcspecs = flat_jax(jsh.cache_specs(jcache, jcfg, FakeMesh(shape),
                                           jpar, SLOTS))
        jcache = flat_jax(jcache)
    for rank in (0, tp - 1):
        mesh_r = Mesh(shape, rank=rank)
        mine = flat_port(psh.shard_params(
            full, psh.param_specs(full, pcfg, mesh_r, ppar), mesh_r))
        for path, leaf in flat_port(full).items():
            assert tuple(mine[path].shape) == \
                arithmetic(leaf.shape, jspecs[path], shape), path
        if paged:
            pages = flat_port(port_paged_cache(pcfg, SLOTS, MAX_LEN, BLOCKS,
                                               16, device="meta",
                                               mesh=mesh_r))
            for path, leaf in jcache.items():
                assert tuple(pages[path].shape) == \
                    arithmetic(leaf.shape, jcspecs[path], shape), path


@pytest.mark.parametrize("arch", ["qwen2.5-7b", "qwen3-1.7b", "dbrx-132b",
                                  "starcoder2-3b"])
@pytest.mark.parametrize("mesh", SMALL)
def test_placement_holds_whole_heads(arch, mesh):
    """``placement_specs`` departs from the rules only where they would
    cut a head (attention whole on every rank) or gather experts at each
    call (the baseline MoE branch: experts whole); where q and kv heads
    both divide tp it keeps the rules' head split."""
    shape = MESHES[mesh]
    cfg = port_config(arch)
    tp = shape["model"]
    par = psh.ParallelismConfig(fsdp=False)
    full = port_params(arch)
    mesh_r = Mesh(shape, rank=tp - 1)
    specs = psh.param_specs(full, cfg, mesh_r, par)
    placed = psh.placement_specs(specs, cfg, mesh_r, par)
    attn = placed["layers"][0]["attn"]
    split = cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0
    assert heads_split(cfg, tp) == split
    if split:
        assert attn == specs["layers"][0]["attn"]
    else:
        assert all(all(e is None for e in s) for s in attn.values())
    mine = psh.shard_params(full, placed, mesh_r)["layers"][0]["attn"]
    hd = cfg.head_dim
    heads = (cfg.num_heads // tp, cfg.num_kv_heads // tp) if split \
        else (cfg.num_heads, cfg.num_kv_heads)
    assert mine["wq"].shape[1] == heads[0] * hd
    assert mine["wk"].shape[1] == heads[1] * hd
    if cfg.moe is not None:
        for ep in (True, False):
            p = psh.ParallelismConfig(fsdp=False, expert_parallel=ep)
            moe = psh.placement_specs(psh.param_specs(full, cfg, mesh_r, p),
                                      cfg, mesh_r, p)["layers"][0]["moe"]
            n = cfg.moe.num_experts
            assert psh.local_shape(full["layers"][0]["moe"]["w_gate"].shape,
                                   moe["w_gate"], mesh_r)[0] == \
                (n // tp if ep and n % tp == 0 else n)


def test_mesh_paths_not_ported_raise():
    """What the mesh does not run raises before any rank would wait on
    another: a fleet of engines on different meshes (no counterpart in
    the reference) names ROADMAP M11b.  An engine on a data axis > 1
    runs now (``tests/test_torch_mesh_engine_data*.py``): on a
    shape-only mesh it gets as far as its first message to the other
    ranks, for which such a mesh has no process group.  Training under a
    mesh and a multi-codebook model under tp do run now
    (``tests/test_torch_mesh_train*.py``): on a 1 x 1 mesh they give the
    single-device logits bit for bit, and on a shape-only 1 x 2 mesh they
    get as far as their first collective, for which such a mesh has no
    process group.  The dense layout raises as the JAX engine does (so
    Mamba2 alone, whose engine is dense-only, has no mesh path), and a
    fleet runs on rank 0 only."""
    import torch
    from repro_torch.configs import get_reduced as port_reduced
    from repro_torch.engine.engine import Engine
    from repro_torch.models.model import forward_full, init_params
    from repro_torch.models.moe import ShardingCtx
    mesh = Mesh({"data": 1, "model": 2}, rank=0)
    ctx = ShardingCtx(mesh=mesh)
    cfg = dataclasses.replace(port_reduced("qwen3-1.7b"), dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    audio = dataclasses.replace(port_reduced("musicgen-medium"),
                                dtype="float32")
    audio_params = init_params(audio, seed=0, device="cpu")
    audio_toks = torch.zeros((1, 4, audio.num_codebooks), dtype=torch.int32)
    one = ShardingCtx(mesh=Mesh({"data": 1, "model": 1}, rank=0),
                      fsdp_axes=("data",))
    for c, p, t in ((cfg, params, toks), (audio, audio_params, audio_toks)):
        want = forward_full(p, c, tokens=t, remat=True)[0]
        assert torch.equal(forward_full(p, c, tokens=t, remat=True,
                                        ctx=one)[0], want)
        mine = psh.shard_params(p, psh.rank_specs(
            c, mesh, psh.ParallelismConfig(fsdp=False)), mesh)
        with pytest.raises(ValueError, match="no process group"):
            forward_full(mine, c, tokens=t, remat=True, ctx=ctx)
    with pytest.raises(ValueError, match="paged"):
        Engine(cfg, params, device="cpu", paged=False, mesh=mesh)
    ssm = dataclasses.replace(port_reduced("mamba2-780m"), dtype="float32")
    with pytest.raises(ValueError, match="paged"):
        Engine(ssm, init_params(ssm, seed=0, device="cpu"), device="cpu",
               mesh=mesh)
    with pytest.raises(ValueError, match="process group"):
        Engine(cfg, params, device="cpu",
               mesh=Mesh({"data": 2, "model": 2}, rank=0))
    from repro_torch.serving import EngineFleet
    engines = [Engine(cfg, params, device="cpu", max_slots=2,
                      max_seq_len=64) for _ in range(3)]
    engines[0].mesh = mesh          # as rank 0 of a tp 2 mesh holds it
    engines[1].mesh = Mesh({"data": 1, "model": 2}, rank=0)
    with pytest.raises(NotImplementedError, match="M11b"):
        EngineFleet(engines[:2])
    with pytest.raises(NotImplementedError, match="M11b"):
        EngineFleet([engines[0], engines[2]])
    engines[1].mesh = Mesh({"data": 1, "model": 2}, rank=1)
    with pytest.raises(RuntimeError, match="rank 0"):
        EngineFleet(engines[1:2])


@pytest.mark.parametrize("mesh", SMALL)
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-1.2b"])
def test_placement_mla_and_hybrid(arch, mesh):
    """MLA: where the heads divide tp (16 at 2, 4, 8), ``wq``, ``w_uk``
    and ``w_uv`` hold whole heads' columns and ``wo`` their rows; the
    latent's weights (``w_dkv``, ``w_krope``, ``kv_norm``) whole.  The
    hybrid: the shared block split by whole heads (32 q and kv heads),
    every SSM weight whole (FSDP-only in the rules, no FSDP here)."""
    shape = MESHES[mesh]
    cfg = port_config(arch)
    tp = shape["model"]
    par = psh.ParallelismConfig(fsdp=False)
    full = port_params(arch)
    mesh_r = Mesh(shape, rank=tp - 1)
    placed = psh.placement_specs(psh.param_specs(full, cfg, mesh_r, par),
                                 cfg, mesh_r, par)
    mine = psh.shard_params(full, placed, mesh_r)
    assert heads_split(cfg, tp)
    h = cfg.num_heads // tp
    if cfg.mla is not None:
        m = cfg.mla
        attn = mine["layers"][0]["attn"]
        assert attn["wq"].shape[1] == h * (m.qk_nope_head_dim
                                           + m.qk_rope_head_dim)
        assert attn["w_uk"].shape[1] == h * m.qk_nope_head_dim
        assert attn["w_uv"].shape[1] == h * m.v_head_dim
        assert attn["wo"].shape[0] == h * m.v_head_dim
        for name in ("w_dkv", "w_krope", "kv_norm"):
            assert attn[name].shape == \
                full["layers"][0]["attn"][name].shape, name
        return
    attn = mine["shared_block"]["attn"]
    hd = cfg.head_dim
    assert attn["wq"].shape[1] == attn["wk"].shape[1] == h * hd
    assert attn["wo"].shape[0] == h * hd
    ssm = [i for i, kind in enumerate(cfg.layer_pattern) if kind == "ssm"]
    for i in ssm:
        for path, leaf in flat_port(mine["layers"][i]).items():
            assert leaf.shape == flat_port(full["layers"][i])[path].shape


def test_placement_mla_indivisible_heads():
    """3 MLA heads at tp 2: the rules cut ``wq``'s 3 x 24 columns in two
    (mid-head); the rank holds the whole attention block, which runs
    replicated."""
    from repro_torch.models.config import MLAConfig
    cfg = PortConfig(name="t-mla3", family="dense", num_layers=2,
                     d_model=48, num_heads=3, num_kv_heads=3, head_dim=16,
                     d_ff=96, vocab_size=96, dtype="float32",
                     mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                                   qk_nope_head_dim=16, qk_rope_head_dim=8,
                                   v_head_dim=16))
    full = port_init_params(cfg, device="meta")
    mesh_r = Mesh({"data": 1, "model": 2}, rank=1)
    par = psh.ParallelismConfig(fsdp=False)
    specs = psh.param_specs(full, cfg, mesh_r, par)
    assert tuple(specs["layers"][0]["attn"]["wq"]) == (None, "model")
    placed = psh.placement_specs(specs, cfg, mesh_r, par)
    assert not heads_split(cfg, 2)
    assert all(all(e is None for e in s)
               for s in placed["layers"][0]["attn"].values())


@pytest.mark.parametrize("batch", [1, 3, 16, 128])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_input_sharding_matches_reference(mesh, batch):
    shape = MESHES[mesh]
    for fsdp in (True, False):
        want = jsh.input_sharding(get_config("qwen2.5-7b"), FakeMesh(shape),
                                  jsh.ParallelismConfig(fsdp=fsdp), batch)
        got = psh.input_sharding(port_config("qwen2.5-7b"), Mesh(shape),
                                 psh.ParallelismConfig(fsdp=fsdp), batch)
        assert got == want


def test_shard_leaf_copies_what_it_splits():
    """A split slice is a copy holding no reference to the whole tensor
    (a row slice would otherwise be a view keeping all of its memory
    alive on the rank); an unsplit leaf is passed through."""
    import torch
    t = torch.arange(16.0).reshape(4, 4)
    mesh = Mesh({"data": 1, "model": 2}, rank=1)
    for spec, want in ((psh.P("model", None), t[2:]),
                       (psh.P(None, "model"), t[:, 2:])):
        got = psh.shard_leaf(t, spec, mesh)
        assert torch.equal(got, want) and got.is_contiguous()
        assert got.untyped_storage().data_ptr() != \
            t.untyped_storage().data_ptr()
    assert psh.shard_leaf(t, psh.P(None, None), mesh) is t
