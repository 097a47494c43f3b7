"""The JAX package's own FLOPs of one tiny dry-run case, for the record
beside the port's count: reduced Qwen3-1.7B in float32, one prefill of a
few rows of 64 tokens (the shapes given on the command line) on a (2, 2)
("data", "model") mesh of host devices, lowered and compiled as
``repro.launch.dryrun.run_one`` does it; prints ``cost_analysis()``'s
per-device "flops" and "bytes accessed" as one JSON line.

    PYTHONPATH=src python tests/helpers/jax_dryrun_flops.py BATCH SEQ

(``repro.launch.dryrun`` sets the 512 host devices itself; four of them
make the mesh.)"""
import dataclasses
import json
import sys

from repro.launch import dryrun  # noqa: I001  (sets the device count)

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get_reduced  # noqa: E402
from repro.distributed.sharding import ParallelismConfig  # noqa: E402


def main(batch: int, seq: int):
    dryrun.SHAPES["prefill_32k"] = dict(kind="prefill", seq=seq,
                                        batch=batch)
    cfg = dataclasses.replace(get_reduced("qwen3-1.7b"), dtype="float32")
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    par = ParallelismConfig(dp_axes=("data",), fsdp=False)
    fn, args, in_sh, out_sh = dryrun.build_step(cfg, "prefill_32k", mesh,
                                                par)
    compiled = jax.jit(fn, in_shardings=in_sh,
                       out_shardings=out_sh).lower(*args).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    print(json.dumps({"flops": cost.get("flops"),
                      "bytes_accessed": cost.get("bytes accessed")}))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]))
