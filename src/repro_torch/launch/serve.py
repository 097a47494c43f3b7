"""Serving launcher: live streaming loop (default) or the engine's
batch admission loop on a synthetic mixed workload, on the GPU by
default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-7b \
      --n 8 --policy slo-reanneal --arrival-rate 4

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --reduced --n 4 --policy fcfs --device cpu --instances 2

``--policy`` accepts any ``repro_torch.core.policies.make`` registry
name (``fcfs``, ``priority``, ``slo-reanneal``, ``slo-preempt``, …) plus
``slo``/``planned`` for the offline Algorithm 1/2 planner (plan batches,
score them under both disciplines, dispatch).  Streaming mode drives the
:class:`repro_torch.serving.ServeLoop` — arrival-timed ingestion,
per-token wall-clock streams, overlapped host scheduling + device
execution — and reports *measured* TTFT/TBT/attainment; ``--mode
batch`` runs the engine's batch admission loop on its internal clock
instead (the planner policies always use batch mode: their plan needs
the whole workload up front).  ``--instances N`` scales streaming mode
data-parallel: an :class:`repro_torch.serving.EngineFleet` of N engines
sharing one params dict, routed by ``--mapper`` (least-loaded default;
``annealed`` is the paper's Algorithm 2: memory-greedy assignment, then
each instance's queue annealed by the batched annealer on the engines'
device).  ``--policy slo-reanneal:jax`` re-anneals the waiting queue on
that annealer at every admission event.
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
from repro_torch.serving import EngineFleet, ServeLoop


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
    ap.add_argument("--mode", choices=("stream", "batch"), default="stream",
                    help="stream: live ServeLoop with measured wall-clock "
                         "metrics; batch: engine admission loop")
    ap.add_argument("--discipline", default="stall",
                    help="stall | chunked | chunked:<size> — both modes; "
                         "streaming runs chunks in the tick plan "
                         "alongside decode dispatches")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="requests/s; 0 = all submitted at t=0")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--no-overlap", action="store_true",
                    help="stream mode: synchronous reference loop")
    ap.add_argument("--instances", type=int, default=1,
                    help="stream mode: data-parallel EngineFleet size "
                         "(N engines behind one front door, ticked in "
                         "turn by one host thread: on one card a fleet "
                         "serves no faster than one loop while the "
                         "decode round is host-bound)")
    ap.add_argument("--mapper", default="least-loaded",
                    help="fleet routing: round-robin | least-loaded | "
                         "slo-affinity | memory-greedy | annealed "
                         "(Algorithm 2 on the batched annealer)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch kernels)")
    args = ap.parse_args(argv)
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
    planner = args.policy in ("slo", "planned")
    if args.mode == "stream" and not planner:
        pol = make(args.policy, model=model, max_batch=args.max_batch,
                   device=device)
        # a policy that carries its own discipline (dynamic-chunk) wins
        # over the flag, as in batch mode below
        disc = getattr(pol, "discipline", None) or discipline
        if args.instances > 1:
            engines = [eng] + [Engine(cfg, params, max_slots=args.max_batch,
                                      max_seq_len=256, device=device)
                               for _ in range(args.instances - 1)]
            loop = EngineFleet(engines, args.policy, mapper=args.mapper,
                               model=model, discipline=disc,
                               overlap=not args.no_overlap)
        else:
            loop = ServeLoop(eng, pol, model=model, discipline=disc,
                             overlap=not args.no_overlap)
        loop.start(warm_lengths=[len(p) for _, p in pairs])
        loop.submit_trace(pairs)
        loop.serve()
        s = loop.metrics.summary()
        where = f"fleet{args.instances}:{args.mapper}" \
            if args.instances > 1 else "stream"
        print(f"policy={args.policy} mode={where} arch={cfg.name} "
              f"device={device} discipline={disc!r} "
              f"overlap={not args.no_overlap} G={s['G']:.4f} "
              f"attainment={s['attainment']:.2f} "
              f"completed={s['n']}/{len(pairs)} "
              f"ttft_mean={s['ttft_mean'] * 1e3:.1f}ms "
              f"tbt_p90={s['tbt_p90'] * 1e3:.2f}ms "
              f"tok/s={s['tokens_per_s']:.0f} "
              f"preemptions={s['preemptions']}")
        return
    rts = _to_rts(pairs)
    respect = args.arrival_rate > 0
    if planner:
        out = run_planner(eng, rts, model, discipline, args.max_batch,
                          respect)
    else:
        pol = make(args.policy, model=model, max_batch=args.max_batch,
                   device=device)
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
