"""The port's serve CLI runs on the CPU when asked — batch mode, the
streaming loop (overlapped and synchronous; also on reduced
DeepSeek-V2-Lite, MLA + MoE) and a two-engine fleet, routed
least-loaded or by the annealed mapper (Algorithm 2 on the batched
annealer) — and ``chip_smoke.py`` refuses to report without a card."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import serve

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="2")


def test_serve_cli_batch_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-1.7b", "--reduced", "--n", "4", "--mode", "batch",
         "--policy", "fcfs", "--device", "cpu"], env=_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("policy=fcfs ") and "device=cpu" in last
    assert "attainment=" in last and "/4" in last


CPU_ARGS = ["--arch", "qwen3-1.7b", "--reduced", "--n", "4", "--policy",
            "fcfs", "--device", "cpu", "--arrival-rate", "50"]


@pytest.mark.parametrize("overlap", [True, False])
def test_serve_cli_stream_on_cpu(capsys, overlap):
    """``--mode stream`` is the default: the ServeLoop serves every
    request and prints measured wall-clock metrics."""
    torch.set_num_threads(2)
    serve.main(CPU_ARGS + ([] if overlap else ["--no-overlap"]))
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("policy=fcfs mode=stream ")
    assert f"overlap={overlap}" in last and "device=cpu" in last
    assert "completed=4/4" in last and "ttft_mean=" in last \
        and "tbt_p90=" in last


def test_serve_cli_fleet_on_cpu(capsys):
    torch.set_num_threads(2)
    serve.main(CPU_ARGS + ["--instances", "2", "--mapper", "least-loaded"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert "mode=fleet2:least-loaded" in last and "completed=4/4" in last


def test_serve_cli_annealed_mapper_runs(capsys):
    """``--mapper annealed`` is the paper's Algorithm 2 on the batched
    annealer, here on the CPU the engines run on."""
    torch.set_num_threads(2)
    serve.main(CPU_ARGS + ["--n", "2", "--instances", "2", "--mapper",
                           "annealed"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert "mode=fleet2:annealed" in last and "completed=2/2" in last


def test_serve_cli_stream_deepseek_on_cpu(capsys):
    """MLA + MoE (reduced DeepSeek-V2-Lite) through the streaming loop."""
    torch.set_num_threads(2)
    serve.main(["--arch", "deepseek-v2-lite-16b"] + CPU_ARGS[2:])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("policy=fcfs mode=stream ")
    assert "arch=deepseek-v2-lite-16b-reduced" in last \
        and "completed=4/4" in last


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke would run")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
