"""Serving launcher: the engine's batch admission loop on a synthetic
mixed workload, on the GPU by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-7b \
      --n 8 --policy slo-reanneal --mode batch

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --reduced --n 4 --policy fcfs --device cpu

``--policy`` accepts any ``repro_torch.core.policies.make`` registry
name (``fcfs``, ``priority``, ``slo-reanneal``, ``slo-preempt``, …) plus
``slo``/``planned`` for the offline Algorithm 1/2 planner (plan batches,
score them under both disciplines, dispatch).  The streaming serving
loop (``--mode stream``) and engine fleets (``--instances > 1``) are not
ported yet (ROADMAP M6) and raise.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config, get_reduced
from repro_torch.core import SAParams, SLOAwareScheduler
from repro_torch.core.policies import make, make_discipline
from repro_torch.core.profiler import LatencyProfiler
from repro_torch.data.synthetic import sample_serve_workload
from repro_torch.device import resolve_device
from repro_torch.engine.engine import Engine
from repro_torch.engine.request import RuntimeRequest
from repro_torch.models.model import init_params


def _to_rts(pairs):
    return [RuntimeRequest(request=r, prompt_tokens=p,
                           max_new_tokens=r.output_len)
            for r, p in pairs]


def fit_latency_model(cfg, params, max_batch, rng, n_warm=8, device=None):
    """Fit the linear latency model on a short profiled warmup run.

    ``n_warm`` defaults to 8 (the JAX launcher uses 6): the profiler
    fits only from 8 prefill samples on and otherwise returns the
    paper's V100 table, which says nothing about this device.  The fit
    is non-negative: the policies project slack with it, and a few
    noisy samples must not extrapolate a negative step cost."""
    prof = LatencyProfiler()
    warm = Engine(cfg, params, max_slots=max_batch, max_seq_len=256,
                  profiler=prof, device=device)
    warm.run_fcfs(_to_rts(sample_serve_workload(n_warm, cfg.vocab_size,
                                                rng=rng)))
    return prof.fit(nonneg=True)


def run_planner(eng, rts, model, discipline, max_batch, respect):
    """Offline Algorithm 1/2: plan batches, score, dispatch."""
    reqs = [rt.request for rt in rts]
    for rt, r in zip(rts, reqs):
        r.predicted_output_len = rt.max_new_tokens
    sched = SLOAwareScheduler(model, num_instances=1, max_batch=max_batch,
                              sa_params=SAParams(seed=0))
    outcome = sched.schedule(reqs)
    for disc in ("stall", f"chunked:{discipline.chunk_size or 32}"):
        ev = sched.evaluate_plan(outcome, discipline=disc)
        print(f"plan under {disc:<12}: predicted G={ev.G:.4f} "
              f"attainment={ev.attainment:.2f}")
    by_id = {rt.req_id: rt for rt in rts}
    planned = [[by_id[r.req_id] for r in b]
               for b in outcome.queues[0].batches]
    return eng.run_planned(planned, discipline=discipline, model=model,
                           respect_arrivals=respect)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--policy", default="slo",
                    help="any policies.make registry name (fcfs, priority, "
                         "slo-reanneal, slo-preempt, ...) or slo/planned "
                         "for the offline planner")
    ap.add_argument("--mode", choices=("stream", "batch"), default="batch",
                    help="batch: engine admission loop; stream: not "
                         "ported yet")
    ap.add_argument("--discipline", default="stall",
                    help="stall | chunked | chunked:<size>")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="requests/s; 0 = all submitted at t=0")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--instances", type=int, default=1,
                    help="engine fleet size; only 1 is ported")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch kernels)")
    args = ap.parse_args(argv)
    if args.mode == "stream" or args.instances > 1:
        raise SystemExit("--mode stream and --instances > 1 are not yet "
                         "ported (ROADMAP M6)")
    device = resolve_device(args.device)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.uses_extra_embeds:
        raise SystemExit("VLM serving needs an embedding frontend")
    params = init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    pairs = sample_serve_workload(args.n, cfg.vocab_size, rng=rng,
                                  arrival_rate=args.arrival_rate)
    discipline = make_discipline(args.discipline)
    model = fit_latency_model(cfg, params, args.max_batch, rng,
                              device=device)

    eng = Engine(cfg, params, max_slots=args.max_batch, max_seq_len=256,
                 device=device)
    rts = _to_rts(pairs)
    respect = args.arrival_rate > 0
    if args.policy in ("slo", "planned"):
        out = run_planner(eng, rts, model, discipline, args.max_batch,
                          respect)
    else:
        pol = make(args.policy, model=model, max_batch=args.max_batch)
        # a policy that carries its own discipline (dynamic-chunk) wins
        # over the flag
        discipline = getattr(pol, "discipline", None) or discipline
        out = eng.run_policy(rts, pol, discipline=discipline, model=model,
                             respect_arrivals=respect)
    met = sum(v["met"] for v in out.values())
    tot = sum(v["e2e"] for v in out.values())
    npre = sum(v["preemptions"] for v in out.values())
    print(f"policy={args.policy} discipline={discipline!r} arch={cfg.name} "
          f"device={device} G={met / tot if tot else 0:.4f} "
          f"attainment={met}/{len(out)} avg={tot / len(out):.2f}s "
          f"preemptions={npre}")


if __name__ == "__main__":
    main()
