"""The JAX package's ``lm_loss`` and its gradients under a ``(data, model)``
mesh of host devices, jitted with the FSDP shardings of the dry run's
train branch (``src/repro/launch/dryrun.py``): ``param_specs`` under the
case's ``ParallelismConfig``, the batch split over ``data`` where it
divides.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/helpers/jax_mesh_train.py IN.npz OUT.npz

``IN.npz`` holds ``spec`` (JSON: the arch, the config fields to replace,
and the cases, each a name, ``mesh`` [data, model], ``ep``, ``fsdp``,
the batch's name and optionally ``attn``, the ``attn_sharding``
(default ``"none"``), and ``logits``: also run ``forward_full`` under
the mesh), the params' leaves ``p0``, ``p1``, ... in
``jax.tree.flatten`` order, and each batch's ``<batch>/tokens`` and
``<batch>/labels``.  ``OUT.npz`` holds per case ``<name>/loss``,
``/lm_loss``, ``/aux`` and the gradients ``<name>/g0``, ... in the same
order, and ``<name>/logits`` where asked.

The mesh is built as ``Mesh(np.array(jax.devices()[:n]).reshape(data,
model), ...)``: under jax 0.9.0 the sharded step fails on a mesh of
``jax.make_mesh`` with a ``ShardingTypeError`` (at the embedding
lookup: "Use `.at[...].get(out_sharding=)` to provide output
PartitionSpec for the gather indexing")."""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_reduced
from repro.distributed.sharding import (ParallelismConfig, input_sharding,
                                        make_ctx, named, param_specs)
from repro.models import forward_full, init_params
from repro.train.train_step import lm_loss


def run(src: str, dst: str):
    z = np.load(src)
    spec = json.loads(str(z["spec"]))
    cfg = dataclasses.replace(get_reduced(spec["arch"]), **{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in spec["replace"].items()})
    shapes = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
    treedef = jax.tree.structure(shapes)
    params = jax.tree.unflatten(treedef, [jnp.asarray(z[f"p{i}"]) for i in
                                          range(treedef.num_leaves)])
    out = {}
    for case in spec["cases"]:
        data, tp = case["mesh"]
        mesh = Mesh(np.array(jax.devices()[:data * tp]).reshape(data, tp),
                    ("data", "model"))
        par = ParallelismConfig(fsdp=case["fsdp"],
                                expert_parallel=case["ep"],
                                attn_sharding=case.get("attn", "none"))
        ctx = make_ctx(mesh, par)
        psh = named(mesh, param_specs(params, cfg, mesh, par))
        batch = {k: jnp.asarray(z[f"{case['batch']}/{k}"])
                 for k in ("tokens", "labels")}
        bspec = input_sharding(cfg, mesh, par, batch["tokens"].shape[0])
        bsh = {k: NamedSharding(mesh, P(bspec, None)) for k in batch}

        def fn(p, b):
            (loss, m), g = jax.value_and_grad(
                lambda q: lm_loss(q, cfg, b["tokens"], b["labels"], ctx=ctx,
                                  remat=True), has_aux=True)(p)
            return loss, m["lm_loss"], m["aux_loss"], g

        step = jax.jit(fn, in_shardings=(psh, bsh),
                       out_shardings=(None, None, None, psh))
        loss, lm, aux, grads = step(jax.device_put(params, psh),
                                    jax.device_put(batch, bsh))
        name = case["name"]
        if case.get("logits"):
            full = jax.jit(lambda p, t: forward_full(p, cfg, tokens=t,
                                                     ctx=ctx)[0],
                           in_shardings=(psh, bsh["tokens"]))
            out[f"{name}/logits"] = np.asarray(full(
                jax.device_put(params, psh),
                jax.device_put(batch["tokens"], bsh["tokens"])))
        out.update({f"{name}/loss": np.asarray(loss),
                    f"{name}/lm_loss": np.asarray(lm),
                    f"{name}/aux": np.asarray(aux)})
        for i, g in enumerate(jax.tree.leaves(grads)):
            out[f"{name}/g{i}"] = np.asarray(g)
    np.savez(dst, **out)


if __name__ == "__main__":
    run(sys.argv[1], sys.argv[2])
