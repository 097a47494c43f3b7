"""The dry run's measured step (``repro_torch.launch.dryrun.measure``) on
the CPU, training, and the count it rests on
(``repro_torch.kernels.cost``).

* Every ``ASSIGNED`` arch (reduced, float32) on a fake world of (2, 2)
  and of 16 x 16 ranks: one ``train_step(..., ctx=, remat=True)`` whose
  collectives equal :func:`~repro_torch.launch.dryrun.collectives`'
  prediction and whose allocated params, moments and inputs equal
  :func:`~repro_torch.launch.dryrun.memory`'s bytes, exactly.
* With remat off the step's FLOPs are three times the forward's
  product FLOPs (each product's input and weight gradients) plus the
  kernels' forward formulas and their backward formulas (dq and dk/dv,
  the SSD scan's gradient).
* Every count is affine in the periods of the layer pattern, so the
  out-of-memory fall-back's extrapolation from two depths gives the
  whole depth's count and collectives exactly.
* A kernel wrapper counts its formula and none of its plain version's
  aten ops.
* For the record, the JAX package's own per-device FLOPs of one tiny
  prefill at (2, 2) (XLA's ``cost_analysis()``, in a subprocess) are
  printed beside the port's count of the same case: not bounded (XLA
  counts elementwise ops and masked attention pairs, the port products
  and kernels only).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ASSIGNED
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.distributed.sharding import make_ctx
from repro_torch.kernels import cost, ops
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, fake_world
from repro_torch.models.config import SSM
from repro_torch.train.train_step import lm_loss, loss_and_grads

HERE = pathlib.Path(__file__).resolve().parent
SMALL = {"train_4k": dict(kind="train", seq=32, batch=8),
         "prefill_32k": dict(kind="prefill", seq=64, batch=8),
         "decode_32k": dict(kind="decode", seq=64, batch=8),
         "long_500k": dict(kind="decode", seq=200, batch=1)}
MESHES = {"2x2": (2, 2), "16x16": (16, 16)}
ATTN_BWD = ("flash_attention_dq", "flash_attention_dkv")


@pytest.fixture(scope="module")
def jax_flops():
    """The JAX package's tiny prefill, compiled in a subprocess started
    before the module's tests."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(HERE.parent / "src"))
    env.pop("XLA_FLAGS", None)
    sh = SMALL["prefill_32k"]
    proc = subprocess.Popen(
        [sys.executable, str(HERE / "helpers" / "jax_dryrun_flops.py"),
         str(sh["batch"]), str(sh["seq"])], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def small():
    """The cut shapes; one thread (the steps are tiny: more threads only
    contend with the other test workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dryrun, "SHAPES", SMALL)
        yield
    torch.set_num_threads(threads)


def cfg_of(arch):
    return dataclasses.replace(port_reduced(arch), dtype="float32")


def record(cfg, shape, data_tp, par=None):
    mesh = Mesh(dict(zip(("data", "model"), data_tp)))
    kind = SMALL[shape]["kind"]
    par = dryrun.step_parallelism(
        par or dryrun.default_parallelism(cfg, shape, False), kind)
    rec = dryrun.memory(cfg, shape, mesh, par)
    coll, counts = dryrun.collectives(cfg, kind, mesh, par,
                                      SMALL[shape]["batch"],
                                      SMALL[shape]["seq"])
    rec.update(collective_bytes_per_device=coll, collective_counts=counts)
    rec.update(dryrun.measure(cfg, shape, mesh, par, device="cpu"))
    return rec


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_step_matches_the_arithmetic(small, arch, mesh_name):
    cfg = cfg_of(arch)
    rec = record(cfg, "train_4k", MESHES[mesh_name])
    assert dryrun.check_measured(rec) == []
    assert rec["oom"] is None and rec["peak_bytes"] is None
    assert rec["held"]["moment_bytes"] > 2 * rec["held"]["param_bytes"]
    assert rec["pool_bytes"] == 0 and rec["flops_per_device"] > 0
    # the backward's kernels counted once a layer, the forward's twice
    # (the remat re-forward)
    kernels = rec["count"]["kernels"]
    n_gqa = 0 if cfg.mla is not None else len(cfg.attn_layers)
    for name, per in (("flash_attention_fwd_lse", 2),
                      ("flash_attention_dq", 1), ("flash_attention_dkv", 1)):
        assert kernels.get(name, {"calls": 0})["calls"] == per * n_gqa
    n_ssm = sum(k == SSM for k in cfg.layer_pattern)
    assert kernels.get(ss.BWD, {"calls": 0})["calls"] == n_ssm


def _pairs(s, window):
    return sum(min(i, window) if window else i for i in range(1, s + 1))


class _GradSplit(cost.CostCounter):
    """A counter that also sums the product FLOPs whose inputs need no
    gradient (M-RoPE's angle product), which the backward does not
    repeat."""

    def __init__(self):
        super().__init__()
        self.constant_flops = 0

    def _count(self, func, args, kwargs, out):
        before = self.product_flops
        super()._count(func, args, kwargs, out)
        if not any(t.requires_grad for t in cost._tensors(args)):
            self.constant_flops += self.product_flops - before


@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_flops_are_three_forwards_plus_the_kernels(small, arch):
    """Remat off, at (2, 2): the step's FLOPs equal 3 x the forward's
    product FLOPs (the grouped MoE product's included; a product of
    inputs that need no gradient once) + the kernels' forward formulas +
    dq and dk/dv (6 and 8 hd flops a pair) per GQA layer + the SSD
    scan's gradient per SSM layer."""
    cfg = cfg_of(arch)
    sh = SMALL["train_4k"]
    data, tp = MESHES["2x2"]
    mesh = Mesh({"data": data, "model": tp})
    par = dryrun.step_parallelism(
        dryrun.default_parallelism(cfg, "train_4k", False), "train")
    _, _, rpar = dryrun._runtime(mesh, par)
    with fake_world(data, tp, device="cpu") as rmesh:
        ctx = make_ctx(rmesh, rpar)
        params = dryrun.draw_params(cfg, rmesh, rpar, torch.device("cpu"))
        batch = dryrun.draw_inputs(cfg, "train_4k", mesh, par,
                                   torch.device("cpu"))
        batch.pop("positions", None)
        leaves = [t for _, t in dryrun._paths(params)]
        for t in leaves:
            t.requires_grad_(True)
        with _GradSplit() as fwd:
            lm_loss(params, cfg, batch.get("tokens"), batch["labels"],
                    embeds=batch.get("embeds"), ctx=ctx, remat=False)
        for t in leaves:
            t.requires_grad_(False)
        with cost.CostCounter() as step:
            loss_and_grads(cfg, params, batch, remat=False, ctx=ctx)
    rows = sh["batch"] // data
    s = sh["seq"]
    fwd_kernels = fwd.flops - fwd.product_flops - \
        fwd.kernel_flops("ragged_dot")
    products = fwd.product_flops - fwd.constant_flops + \
        fwd.kernel_flops("ragged_dot")
    bwd = 0
    n_gqa = 0 if cfg.mla is not None else len(cfg.attn_layers)
    if n_gqa:
        split = tp > 1 and cfg.num_heads % tp == 0 and \
            cfg.num_kv_heads % tp == 0 and cfg.num_kv_heads >= tp
        h = cfg.num_heads // tp if split else cfg.num_heads
        bwd += n_gqa * (6 + 8) * rows * h * cfg.head_dim * \
            _pairs(s, cfg.sliding_window)
        assert step.kernel_flops(*ATTN_BWD) == n_gqa * 14 * rows * h * \
            cfg.head_dim * _pairs(s, cfg.sliding_window)
    n_ssm = sum(k == SSM for k in cfg.layer_pattern)
    if n_ssm:
        sc = cfg.ssm
        bwd += n_ssm * cost.ssd_bwd_flops(rows, s, sc.n_heads(cfg.d_model),
                                          sc.head_dim, sc.d_state)
    assert step.flops == 3 * products + fwd.constant_flops + fwd_kernels + \
        bwd
    assert fwd.constant_flops == 0 or cfg.mrope_sections


@pytest.mark.parametrize("arch,shape", [
    ("dbrx-132b", "train_4k"), ("deepseek-v2-lite-16b", "decode_32k"),
    ("zamba2-1.2b", "prefill_32k")])
def test_counts_are_affine_in_the_layer_periods(small, arch, shape):
    """The out-of-memory fall-back: the counts and collectives of two
    depths one pattern period apart, taken to the whole depth, equal the
    whole depth's."""
    base = cfg_of(arch)
    pattern = {"dbrx-132b": None, "deepseek-v2-lite-16b": None,
               "zamba2-1.2b": ("ssm", "ssm", "attn") * 2}[arch]
    n = 4 if pattern is None else len(pattern)
    cfg = dataclasses.replace(
        base, num_layers=n,
        layer_pattern=pattern or (base.layer_pattern[0],) * n,
        moe=None if base.moe is None else dataclasses.replace(
            base.moe, dense_layers=(0,) if base.moe.dense_layers else ()))
    whole = record(cfg, shape, MESHES["2x2"])
    n1, n2 = dryrun.repeat_depths(cfg)
    cut = [record(dryrun._at_depth(cfg, k), shape, MESHES["2x2"])
           for k in (n1, n2)]
    t = (cfg.num_layers - n1) / (n2 - n1)
    for key in ("count", "tally", "held"):
        assert dryrun._extrapolate(cut[0][key], cut[1][key], t) == \
            whole[key], key


def test_a_wrapper_counts_its_formula_not_its_plain_version():
    """On the CPU the wrappers run their plain versions; under a counter
    each adds its kernel's formula once, and no aten op of the plain
    version is counted (no product FLOPs, no bytes of its own)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 40, 4, 64), generator=g)
    k = torch.randn((2, 40, 2, 64), generator=g)
    v = torch.randn((2, 40, 2, 64), generator=g)
    with cost.CostCounter() as c:
        ops.flash_attention(q, k, v, window=16)
    assert c.product_flops == 0 and c.aten_bytes == 0
    assert c.by_kernel == {"flash_attention": [
        1, *map(int, cost.flash_work(q, k, 16))]}
    assert c.flops == 4 * 2 * 4 * 64 * _pairs(40, 16)
    # the paged decode: the formula reads the lengths
    pages = torch.randn((9, 16, 2, 64), generator=g)
    bt = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    ln = torch.tensor([5, 64], dtype=torch.int32)
    with cost.CostCounter() as c:
        ops.decode_attention_paged(q[:, 0], pages, pages, bt, ln)
    assert c.product_flops == 0 and c.aten_bytes == 0
    assert c.flops == 4 * 4 * 64 * (5 + 64)
    # the SSD scan and its gradient, through autograd
    x = torch.randn((1, 40, 3, 8), generator=g, requires_grad=True)
    dt = torch.rand((1, 40, 3), generator=g)
    A = -torch.linspace(1.0, 2.0, 3)
    B = torch.randn((1, 40, 16), generator=g)
    with cost.CostCounter() as c:
        y, _ = ops.ssd_scan(x, dt, A, B, B, chunk=16)
        y.sum().backward()
    assert set(c.by_kernel) == {ss.NAME, ss.BWD}
    assert c.kernel_flops(ss.NAME) == cost.ssd_flops(1, 40, 3, 8, 16, 32)
    assert c.kernel_flops(ss.BWD) == cost.ssd_bwd_flops(1, 40, 3, 8, 16)
    # the grouped MoE product: 2 rows k n for the rows in its groups
    xr = torch.randn((10, 8), generator=g)
    w = torch.randn((3, 8, 5), generator=g)
    with cost.CostCounter() as c:
        ops.ragged_dot(xr, w, torch.tensor([4, 0, 3]))
    assert c.product_flops == 0 and c.kernel_flops("ragged_dot") == \
        2 * 7 * 8 * 5
    # outside a counter nothing is counted and nothing changes
    assert torch.equal(ops.flash_attention(q, k, v, window=16),
                       ops.flash_attention(q, k, v, window=16))
    assert cost.active() is None


def test_grouped_products_count_their_groups_forward_and_backward():
    """``torch._grouped_mm`` (the card's MoE product; its backward is two
    more of it): 2 rows k n for the rows in groups, each call, with the
    group ends passed as the dispatcher passes them."""
    x = torch.randn((16, 8), requires_grad=True)
    w = torch.randn((3, 8, 8), requires_grad=True)
    with cost.CostCounter() as c:
        y = torch._grouped_mm(x, w, offs=torch.tensor([4, 4, 7],
                                                      dtype=torch.int32))
        y.backward(torch.ones((16, 8)))
    assert c.by_op["_grouped_mm"][0] == 3
    assert c.product_flops == 3 * 2 * 7 * 8 * 8


def test_views_factories_and_scatters_are_counted_as_documented():
    a = torch.randn((64, 32))
    with cost.CostCounter() as c:
        a.t()
        a[3:5]
        torch.empty_like(a)
        torch.zeros(4)
    assert c.bytes == 0 and c.flops == 0
    idx = torch.tensor([1, 2])
    val = torch.ones((2, 32))
    with cost.CostCounter() as c:
        a[idx] = val                       # index_put_: indices, values
    assert c.bytes == idx.numel() * 8 + 2 * val.numel() * 4
    with cost.CostCounter() as c:
        torch.embedding(a, idx)            # indices, the gathered rows
    assert c.bytes == idx.numel() * 8 + 2 * 2 * 32 * 4
    with cost.CostCounter() as c:
        a @ a.t()
    assert c.flops == 2 * 64 * 32 * 64
    assert c.bytes == (a.numel() * 2 + 64 * 64) * 4


def test_jax_flops_of_a_tiny_prefill_for_the_record(small, jax_flops):
    """Printed, not bounded: the JAX package's per-device FLOPs and bytes
    (XLA's cost analysis) of reduced Qwen3-1.7B's tiny prefill at (2, 2)
    beside the port's count of the same case."""
    out, err = jax_flops.communicate(timeout=300)
    assert jax_flops.returncode == 0, err.decode()[-3000:]
    ref = json.loads(out.decode().strip().splitlines()[-1])
    cfg = cfg_of("qwen3-1.7b")
    rec = record(cfg, "prefill_32k", MESHES["2x2"],
                 par=dryrun.ParallelismConfig(fsdp=False))
    print(f"tiny prefill at (2, 2), per device: JAX (XLA cost analysis) "
          f"flops {ref['flops']:.6g}, bytes accessed "
          f"{ref['bytes_accessed']:.6g}; port flops "
          f"{rec['flops_per_device']:.6g}, bytes "
          f"{rec['bytes_accessed_per_device']:.6g}")
    assert ref["flops"] > 0 and np.isfinite(ref["flops"])
