"""The port's serve CLI runs on the CPU when asked, the not-yet-ported
modes refuse, and ``chip_smoke.py`` refuses to report without a card."""
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


@pytest.mark.parametrize("flags", [["--mode", "stream"],
                                   ["--instances", "2"]])
def test_serve_cli_unported_modes_refuse(flags):
    with pytest.raises(SystemExit, match="ROADMAP M6"):
        serve.main(["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
                    *flags])


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke would run")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
