"""The port's train launcher on the CPU on every arch family the JAX
launcher trains beyond the dense decoders: a VLM on float32 ``embeds``,
a K-codebook model on ``[B, S, K]`` tokens, Mamba2, the Zamba2 hybrid
and DeepSeek-V2-Lite's MoE + MLA (reduced, float32, 2 steps), and the
batches it draws against the JAX launcher's."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from repro.configs import get_reduced
from repro.data.synthetic import token_stream
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.launch.train import make_batch

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "musicgen-medium",
                                  "mamba2-780m", "zamba2-1.2b",
                                  "deepseek-v2-lite-16b"])
def test_train_cli_runs_two_steps(arch):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--reduced", "--steps", "2", "--batch", "2", "--seq", "24",
         "--device", "cpu"], env=dict(os.environ, PYTHONPATH=SRC),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    losses = [float(x) for x in re.findall(r"^step +\d+ loss (\S+) ",
                                           out.stdout, re.M)]
    assert len(losses) == 2 and all(np.isfinite(losses)), out.stdout


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "musicgen-medium",
                                  "mamba2-780m"])
def test_batches_are_the_jax_launchers(arch):
    """``make_batch`` draws what ``repro/launch/train.py`` draws from
    ``np.random.default_rng(0)`` (its code, step by step)."""
    jcfg, tcfg = get_reduced(arch), torch_get_reduced(arch)
    B, S = 2, 8
    rng_t, rng_j = np.random.default_rng(0), np.random.default_rng(0)
    for step in range(2):
        got = make_batch(tcfg, B, S, step, rng_t)
        if jcfg.uses_extra_embeds:
            want = {"embeds": np.asarray(rng_j.normal(
                0, 1, (B, S, jcfg.d_model)), np.float32),
                "labels": np.asarray(rng_j.integers(
                    0, jcfg.vocab_size, (B, S)), np.int32)}
        elif jcfg.num_codebooks:
            toks = np.asarray(rng_j.integers(
                0, jcfg.vocab_size, (B, S, jcfg.num_codebooks)), np.int32)
            want = {"tokens": toks, "labels": toks}
        else:
            toks = token_stream(S, jcfg.vocab_size, seed=step, batch=B)
            want = {"tokens": toks, "labels": toks}
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
