"""The port stands alone: importing ``repro_torch`` and every submodule
loads neither ``jax`` nor the JAX package ``repro``, and no source file
of the port, nor ``chip_smoke.py``, imports them."""
import os
import pathlib
import re
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for name in mods:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
print(len(mods), bad, *mods)
sys.exit(1 if bad else 0)
"""

# modules whose import must be covered by name (the dense layout, the
# int8 caches, the decode kernels' wrappers; training: the flash
# backward, the loss and step, AdamW, checkpoints, the launcher; the
# Mamba2 block and the SSD scan kernel's wrapper)
NEW_MODULES = ("repro_torch.kernels.decode_attention",
               "repro_torch.kernels.decode_attention_q8",
               "repro_torch.kernels.decode_attention_paged",
               "repro_torch.kernels.ops", "repro_torch.models.cache",
               "repro_torch.models.attention", "repro_torch.models.model",
               "repro_torch.engine.engine",
               "repro_torch.kernels.flash_attention_bwd",
               "repro_torch.train.train_step",
               "repro_torch.train.optimizer",
               "repro_torch.train.checkpoint",
               "repro_torch.launch.train", "repro_torch.bridge",
               "repro_torch.models.ssm", "repro_torch.kernels.ssd_scan")


def test_import_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_mods = int(out.stdout.split()[0])
    assert n_mods >= 30, out.stdout        # every submodule was imported
    imported = set(out.stdout.split()[2:])
    assert set(NEW_MODULES) <= imported, out.stdout


_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|ml_dtypes|repro)(?:\.|\s|$)"
    r"|import_module\(\s*f?[\"'](?:jax|repro)\."
    r"|\brepro\.(?!_)", re.M)


def test_sources_import_no_jax_and_no_reference():
    hits = []
    for path in sorted((SRC / "repro_torch").rglob("*.py")):
        for m in _IMPORT.finditer(path.read_text()):
            hits.append(f"{path.relative_to(SRC)}: {m.group(0).strip()}")
    assert not hits, hits


def test_chip_smoke_imports_no_jax_and_no_reference():
    text = (SRC.parent / "chip_smoke.py").read_text()
    assert not [m.group(0) for m in _IMPORT.finditer(text)]
