"""The dry run's measured step (``repro_torch.launch.dryrun.measure``) on
the CPU, serving kinds: every ``ASSIGNED`` arch (reduced, float32) x
prefill / decode / the windowed long decode, on a fake world of (2, 2)
and of 16 x 16 ranks, the shapes cut to a few rows of 64 tokens.

* The rank's collectives, tallied by ``layers.collective_counts``,
  equal :func:`~repro_torch.launch.dryrun.collectives`' prediction
  exactly, and its allocated params and inputs equal
  :func:`~repro_torch.launch.dryrun.memory`'s bytes exactly.
* Its FLOPs equal a closed form the test computes from the config for
  the dense GQA decoders and DBRX's MoE (the active experts): 2mnk for
  each projection, MLP and (active) expert product over the rank's
  tokens and heads (and M-RoPE's angle product), the head over the last
  position, and the attention kernel's 4 hd flops a (q head, key)
  pair.
* ``run_one(device="cpu")`` is the spec arithmetic alone: the four
  measured fields stay null.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh

# the production shapes cut to what the CPU runs in seconds
SMALL = {"train_4k": dict(kind="train", seq=32, batch=8),
         "prefill_32k": dict(kind="prefill", seq=64, batch=8),
         "decode_32k": dict(kind="decode", seq=64, batch=32),
         "long_500k": dict(kind="decode", seq=200, batch=1)}
SMALL_WINDOW = 48
MESHES = {"2x2": (2, 2), "16x16": (16, 16)}
SERVE = ("prefill_32k", "decode_32k", "long_500k")
# the archs whose FLOPs the closed form below covers
GQA = ("qwen2-vl-7b", "musicgen-medium", "starcoder2-3b", "phi4-mini-3.8b",
       "h2o-danube-1.8b", "qwen3-1.7b", "dbrx-132b")


@pytest.fixture(scope="module")
def small():
    """The cut shapes; one thread (the steps are tiny: more threads only
    contend with the other test workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dryrun, "SHAPES", SMALL)
        mp.setattr(dryrun, "STREAM_WINDOW", SMALL_WINDOW)
        yield
    torch.set_num_threads(threads)


def cfg_of(arch):
    return dataclasses.replace(port_reduced(arch), dtype="float32")


def measured(arch, shape, mesh_name):
    """The record ``run_one`` builds, its measured part on the CPU."""
    cfg = cfg_of(arch)
    mesh = Mesh(dict(zip(("data", "model"), MESHES[mesh_name])))
    kind = SMALL[shape]["kind"]
    par = dryrun.step_parallelism(
        dryrun.default_parallelism(cfg, shape, False), kind)
    rec = dryrun.memory(cfg, shape, mesh, par)
    coll, counts = dryrun.collectives(cfg, kind, mesh, par,
                                      SMALL[shape]["batch"],
                                      SMALL[shape]["seq"])
    rec.update(collective_bytes_per_device=coll, collective_counts=counts)
    rec.update(dryrun.measure(cfg, shape, mesh, par, device="cpu"))
    return cfg, MESHES[mesh_name], rec


def pairs(s, window):
    """(q, key) pairs of causal attention over ``s`` positions."""
    return sum(min(i, window) if window else i for i in range(1, s + 1))


def closed_form(cfg, shape, data_tp):
    """FLOPs of one serving step of a GQA decoder (DBRX: with its MoE's
    active experts) on one rank, from the config alone."""
    data, tp = data_tp
    sh = SMALL[shape]
    rows = sh["batch"] // data if sh["batch"] % data == 0 else sh["batch"]
    s = sh["seq"] if sh["kind"] == "prefill" else 1
    t = rows * s
    d, hd = cfg.d_model, cfg.head_dim
    split = (tp > 1 and cfg.num_heads % tp == 0
             and cfg.num_kv_heads % tp == 0 and cfg.num_kv_heads >= tp)
    h = cfg.num_heads // tp if split else cfg.num_heads
    kv = cfg.num_kv_heads // tp if split else cfg.num_kv_heads
    attn = 2 * t * d * (h + 2 * kv) * hd + 2 * t * h * hd * d
    if cfg.mrope_sections:
        # each layer's M-RoPE angles: the 3 position ids picked per
        # frequency by a product with a one-hot [hd/2, 3]
        attn += 2 * t * 3 * (hd // 2)
    if sh["kind"] == "prefill":
        attn += 4 * rows * h * hd * pairs(s, cfg.sliding_window)
    else:
        ring = min(sh["seq"], cfg.sliding_window or sh["seq"])
        if shape == "long_500k" and not cfg.sliding_window:
            ring = SMALL_WINDOW
        attn += 4 * rows * h * hd * ring
    if cfg.moe is None:
        ff = cfg.d_ff // tp if tp > 1 and cfg.d_ff % tp == 0 else cfg.d_ff
        n_mats = 3 if cfg.mlp_type == "swiglu" else 2
        ffn = n_mats * 2 * t * d * ff
    else:
        e = cfg.moe
        sliced = tp > 1 and s > 1 and s % tp == 0
        tk = t // tp if sliced else t
        ffn = 2 * tk * d * e.num_experts \
            + 3 * 2 * tk * e.top_k * d * e.d_ff_expert
    vocab = cfg.vocab_size // tp if tp > 1 and cfg.vocab_size % tp == 0 \
        else cfg.vocab_size
    heads = max(1, cfg.num_codebooks)
    return cfg.num_layers * (attn + ffn) + heads * 2 * rows * d * vocab


@pytest.mark.parametrize("shape", SERVE)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_serving_step_matches_the_arithmetic(small, arch, mesh_name, shape):
    cfg, data_tp, rec = measured(arch, shape, mesh_name)
    assert dryrun.check_measured(rec) == []
    assert rec["oom"] is None and rec["counted_at"] == cfg.num_layers
    # no card: nothing about memory is measured
    assert rec["peak_bytes"] is None and rec["temp_bytes"] is None
    assert rec["held"]["moment_bytes"] == 0
    assert rec["pool_bytes"] > 0 or not cfg.attn_layers
    assert rec["bytes_accessed_per_device"] > 0
    if arch in GQA:
        assert rec["flops_per_device"] == closed_form(cfg, shape, data_tp)
    kernel = {"prefill_32k": "flash_attention"}.get(
        shape, "decode_attention_paged")
    if cfg.attn_layers and cfg.mla is None:
        assert rec["count"]["kernels"][kernel]["calls"] == \
            len(cfg.attn_layers)


def test_run_one_on_the_cpu_is_the_arithmetic_alone():
    """``device="cpu"``: the spec arithmetic, the four measured fields
    null and no process group left behind."""
    rec = dryrun.run_one("qwen3-1.7b", "decode_32k", False, save=False,
                         verbose=False, device="cpu")
    for key in ("flops_per_device", "bytes_accessed_per_device",
                "temp_bytes", "peak_bytes", "lower_s", "compile_s"):
        assert rec[key] is None
    assert "held" not in rec and not torch.distributed.is_initialized()
    assert rec["param_count"] == get_config("qwen3-1.7b").param_count()


def test_without_a_card_the_measured_run_raises(monkeypatch):
    """The default device is the card: without one ``run_one`` raises and
    nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_one("qwen3-1.7b", "decode_32k", False, save=False,
                       verbose=False)
