"""The ``attn_sharding="auto"`` placement (``sharding.placement_specs``)
without a process: each rank computes every GQA head for its rows of
the sequence, so the GQA projections (``wq``, ``wk``, ``wv``, ``wo``,
the qk-norm scales; a hybrid's ``shared_block`` too) are whole over tp,
while FSDP still shards them over ``data`` exactly as under ``"none"``.
Every other leaf (MLP, MoE, embedding, head, SSM blocks) and MLA's
attention, which the reference keeps off the sequence path, are placed
as under ``"none"``.  ``rank_specs`` and ``fsdp_dims`` agree with it, and
the reference's ``param_specs`` are unchanged (it column-shards the GQA
weights under ``"auto"`` too, and GSPMD moves them)."""
import pytest

from repro_torch.configs import get_config
from repro_torch.distributed import sharding as psh
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import init_params

ARCHS = ("qwen3-1.7b", "qwen2.5-7b", "h2o-danube-1.8b", "dbrx-132b",
         "deepseek-v2-lite-16b", "zamba2-1.2b")
MESHES = {"2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4},
          "16x16": {"data": 16, "model": 16}}


def named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from named(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def specs_of(arch, mesh, attn, fsdp=True):
    cfg = get_config(arch)
    par = psh.ParallelismConfig(fsdp=fsdp, attn_sharding=attn)
    m = Mesh(MESHES[mesh])
    full = init_params(cfg, device="meta")
    rules = psh.param_specs(full, cfg, m, par)
    placed = psh.placement_specs(rules, cfg, m, par)
    return cfg, par, m, full, dict(named(rules)), dict(named(placed)), \
        dict(named(psh.rank_specs(cfg, m, par)))


def gqa_leaf(cfg, path):
    return cfg.mla is None and ".attn." in path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_auto_places_gqa_whole_over_tp_and_keeps_fsdp(arch, mesh):
    cfg, par, m, full, rules, auto, ranked = specs_of(arch, mesh, "auto")
    _, npar, _, _, nrules, none, _ = specs_of(arch, mesh, "none")
    assert rules == nrules          # the reference's rules: no change
    assert ranked == auto           # rank_specs is the placement
    for path, spec in auto.items():
        if gqa_leaf(cfg, path):
            assert spec == psh._drop_axis(rules[path], "model"), path
            assert "model" not in {a for e in spec if e is not None
                                   for a in psh._axes(e)}, path
        else:
            assert spec == none[path], path
        # FSDP shards the same dim of every leaf under both
        assert psh.fsdp_dim(spec, par) == psh.fsdp_dim(none[path], npar), \
            path
    shapes = {p: psh.local_shape(t.shape, auto[p], m)
              for p, t in named(full)}
    dp = MESHES[mesh]["data"]
    for path, t in named(full):
        if gqa_leaf(cfg, path) and path.endswith(("wq", "wk", "wv")):
            want = t.shape[0] // dp if t.shape[0] % dp == 0 else t.shape[0]
            assert shapes[path] == (want, t.shape[1]), path


def test_fsdp_dims_follow_the_auto_placement():
    cfg, par, m, *_ = specs_of("qwen3-1.7b", "2x2", "auto")
    dims = dict(named(psh.fsdp_dims(psh.rank_specs(cfg, m, par), par)))
    assert dims["layers[0].attn.wq"] == 0
    assert dims["layers[0].attn.wo"] == 1
    assert dims["layers[0].attn.q_norm"] is None
    assert dims["layers[0].mlp.w_down"] == 1
    assert dims["embed"] is None
