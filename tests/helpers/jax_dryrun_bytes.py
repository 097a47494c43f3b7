"""Per-device argument bytes of every dry-run case by the JAX package's own
shardings: for each ``ASSIGNED`` arch x shape x production mesh, the
``NamedSharding(mesh, spec).shard_shape`` of every param (``param_specs``),
AdamW moment and step counter (train), cache leaf (``cache_specs`` of
``cache_struct``; prefill / decode) and input (split over the data axes
where they divide the batch), under ``run_one``'s default
``ParallelismConfig``.  ``jax.eval_shape`` only: nothing is lowered or
compiled.

    PYTHONPATH=src python tests/helpers/jax_dryrun_bytes.py OUT.json

(``repro.launch.dryrun`` sets the 512 host devices itself.)  ``OUT.json``
maps ``<arch>_<shape>_<mesh>`` to ``{"param_bytes", "moment_bytes",
"cache_bytes", "input_bytes", "leaves": {path: bytes}}``, the leaves
being the params' by dotted path."""
import json
import sys

from repro.launch import dryrun  # noqa: I001  (sets the device count)

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ASSIGNED, get_config  # noqa: E402
from repro.distributed.sharding import (ParallelismConfig,  # noqa: E402
                                        cache_specs, param_specs)
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.models.model import init_params  # noqa: E402


def _path(keys):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in keys)


def _bytes(mesh, spec, sds):
    shape = NamedSharding(mesh, spec).shard_shape(sds.shape)
    return int(np.prod(shape)) * np.dtype(sds.dtype).itemsize


def case(arch, shape_name, multi_pod):
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    sh = dryrun.SHAPES[shape_name]
    tp_resident_gb = cfg.param_count() * 2 / 16 / 2**30
    par = ParallelismConfig(
        dp_axes=("pod", "data") if multi_pod else ("data",),
        fsdp=(sh["kind"] == "train" or tp_resident_gb > 8.0))
    params = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
    specs = param_specs(params, cfg, mesh, par)
    is_p = lambda x: isinstance(x, P)                    # noqa: E731
    leaves = {}
    for (keys, sds), spec in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree.leaves(specs, is_leaf=is_p)):
        leaves[_path(keys)] = (_bytes(mesh, spec, sds),
                               _bytes(mesh, spec, jax.ShapeDtypeStruct(
                                   sds.shape, np.float32)))
    out = {"param_bytes": sum(a for a, _ in leaves.values()),
           "moment_bytes": 0, "cache_bytes": 0,
           "leaves": {k: a for k, (a, _) in leaves.items()}}
    if sh["kind"] == "train":
        # mu and nu float32 on the params' specs, the step replicated
        out["moment_bytes"] = 2 * sum(m for _, m in leaves.values()) + 4
        out["moments"] = {k: m for k, (_, m) in leaves.items()}
    else:
        cache = dryrun.cache_struct(cfg, shape_name)
        cspecs = cache_specs(cache, cfg, mesh, par, sh["batch"])
        out["cache_bytes"] = sum(
            _bytes(mesh, s, c) for c, s in zip(
                jax.tree.leaves(cache), jax.tree.leaves(cspecs, is_leaf=is_p)))
    dp = par.dp_axes
    size = int(np.prod([mesh.shape[a] for a in dp]))
    bspec = dp if sh["batch"] % size == 0 else None
    out["input_bytes"] = sum(
        _bytes(mesh, P(bspec, *(None,) * (len(s.shape) - 1)), s)
        for s in dryrun.input_specs(cfg, shape_name).values())
    return out


def main(dst):
    out = {}
    for arch in ASSIGNED:
        for shape_name in dryrun.SHAPES:
            for multi_pod in (False, True):
                mesh = "2x16x16" if multi_pod else "16x16"
                out[f"{arch}_{shape_name}_{mesh}"] = case(arch, shape_name,
                                                          multi_pod)
    with open(dst, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
