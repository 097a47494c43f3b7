"""The port's training step under a ``(data, tp)`` mesh with FSDP against
the JAX package's single-device step, as ``tests/test_torch_mesh_train.py``
holds the dense decoders and the VLM, on the other archs the JAX
launcher trains: reduced ``mamba2-780m`` (its SSM layers whole on every
tp rank, on the data rank's rows, through the differentiable SSD scan:
K4 forward, K4b backward, plain on the CPU; every 2-D SSM weight
FSDP-sharded), ``zamba2-1.2b`` at four layers (SSM, ATTN, SSM, ATTN: the
shared block split by heads like any GQA block and gathered at both
uses) and ``musicgen-medium`` (4 codebooks: the ``[K, V, d]`` tables and
``[K, d, V]`` heads split on V), each at (data 2, tp 1) and (1, 2),
Zamba2 also at (2, 2).  The bounds and the checks of that file."""
import pytest

from test_torch_mesh_train import (MESHES, check_checkpoint,
                                   check_loss_and_grads, check_slices,
                                   check_steps, jax_reference, run_port)

ARCHS = ("mamba2-780m", "zamba2-1.2b", "musicgen-medium")
CASES = [(a, m) for m in ("2x1", "1x2") for a in ARCHS] + \
    [("zamba2-1.2b", "2x2")]


@pytest.fixture(scope="module")
def refs():
    return {a: jax_reference(a) for a in ARCHS}


@pytest.fixture(scope="module")
def port(refs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh-train-archs")
    return run_port(refs, CASES, MESHES, tmp), tmp


@pytest.mark.parametrize("arch,mesh", CASES)
def test_mesh_loss_and_grads_match_jax(refs, port, arch, mesh):
    check_loss_and_grads(refs[arch], port[0][(arch, mesh)])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_mesh_three_steps_match_jax(refs, port, arch, mesh):
    check_steps(refs[arch], port[0][(arch, mesh)])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_mesh_slices_and_replicas(refs, port, arch, mesh):
    check_slices(refs[arch]["cfg"], MESHES[mesh], port[0][(arch, mesh)])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_mesh_checkpoint_round_trip(port, arch, mesh):
    check_checkpoint(port[0][(arch, mesh)], port[1], f"{arch}-{mesh}")
