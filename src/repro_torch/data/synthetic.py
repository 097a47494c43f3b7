"""Synthetic ShareGPT-style workloads.

The paper mixes two datasets with distinct task domains and SLO kinds:
  * Python-Code-23k-ShareGPT  [hf:ajibawa-2023/Python-Code-23k-ShareGPT]
      code generation — e2e-latency SLO (h=1).  SLO: 30 s (10× the ~3 s
      single-request time, per §5.1).
  * ShareGPT_Vicuna_unfiltered [hf:anon8231489123/ShareGPT_Vicuna_unfiltered]
      chat — TTFT (10 s) + TPOT (50 ms) SLOs (h=0).

This container is offline, so we model the two sources with length
distributions matching their published statistics (lognormal fits; lengths
clipped to < 2k tokens exactly as the paper restricts for latency-predictor
validity), tagged with task types and the paper's SLOs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.slo import SLO, Request

CODE_SLO = SLO(e2e=30.0)
CHAT_SLO = SLO(ttft=10.0, tpot=0.050)


@dataclasses.dataclass(frozen=True)
class TaskProfile:
    name: str
    slo: SLO
    in_mu: float      # lognormal params for input length
    in_sigma: float
    out_mu: float
    out_sigma: float
    max_len: int = 2000


# Length statistics: ShareGPT chat turns skew short-in/medium-out; the
# Python-code set has short prompts and longer completions (whole files).
CODE_TASK = TaskProfile("code", CODE_SLO,
                        in_mu=4.6, in_sigma=0.7,     # median ~100 tokens
                        out_mu=5.8, out_sigma=0.45)  # median ~330 tokens
CHAT_TASK = TaskProfile("chat", CHAT_SLO,
                        in_mu=5.0, in_sigma=1.0,     # median ~150 tokens
                        out_mu=5.2, out_sigma=0.6)   # median ~180 tokens


def sample_requests(n: int, seed: int = 0,
                    profiles: Optional[List[TaskProfile]] = None,
                    mix=None) -> List[Request]:
    """Evenly mixed (paper §5.1) then shuffled with the run's seed."""
    profiles = profiles or [CODE_TASK, CHAT_TASK]
    mix = mix or [1.0 / len(profiles)] * len(profiles)
    rng = np.random.default_rng(seed)
    counts = (np.array(mix) * n).astype(int)
    counts[0] += n - counts.sum()
    reqs = []
    rid = 0
    for prof, c in zip(profiles, counts):
        li = np.clip(rng.lognormal(prof.in_mu, prof.in_sigma, c), 8,
                     prof.max_len).astype(int)
        lo = np.clip(rng.lognormal(prof.out_mu, prof.out_sigma, c), 4,
                     prof.max_len).astype(int)
        for a, b in zip(li, lo):
            reqs.append(Request(req_id=rid, task_type=prof.name,
                                input_len=int(a), output_len=int(b),
                                slo=prof.slo))
            rid += 1
    order = rng.permutation(len(reqs))
    reqs = [reqs[i] for i in order]
    for i, r in enumerate(reqs):
        r.req_id = i
    return reqs


def token_stream(n_tokens: int, vocab: int, seed: int = 0,
                 batch: int = 1) -> np.ndarray:
    """Synthetic token ids for engine/training runs."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(batch, n_tokens), dtype=np.int32)


# ------------------------------------------------------------------ serving
def sample_serve_workload(n: int, vocab: int, seed: int = 0,
                          scale: float = 1.0, arrival_rate: float = 0.0,
                          rng: Optional[np.random.Generator] = None,
                          in_range=(16, 96), out_range=(8, 48)):
    """Small mixed chat/code token workload for live serving runs.

    Returns ``[(Request, prompt_tokens)]`` (the token-workload
    convention): alternating code (e2e SLO) and chat (TTFT+TPOT SLO)
    requests with uniform prompt/output lengths — launcher- and
    CI-sized, unlike the paper-statistics :func:`sample_requests`.
    ``scale`` loosens/tightens every SLO together; ``arrival_rate`` > 0
    spaces arrivals by an exponential (Poisson process) clock, 0 means
    everything arrives at t=0.
    """
    if rng is None:
        rng = np.random.default_rng(seed)
    out = []
    t = 0.0
    for i in range(n):
        code = i % 2 == 0
        slo = SLO(e2e=8.0 * scale) if code else SLO(ttft=3.0 * scale,
                                                    tpot=0.5 * scale)
        lin = int(rng.integers(*in_range))
        lout = int(rng.integers(*out_range))
        if arrival_rate > 0:
            t += float(rng.exponential(1.0 / arrival_rate))
        req = Request(req_id=i, task_type="code" if code else "chat",
                      input_len=lin, slo=slo, output_len=lout,
                      arrival_time=t)
        out.append((req, rng.integers(0, vocab, lin).astype(np.int32)))
    return out


# --------------------------------------------------------------- multi-turn
def sample_multiturn_requests(n_conversations: int, turns: int = 3,
                              seed: int = 0,
                              profile: Optional[TaskProfile] = None,
                              system_prompt_len: int = 128,
                              think_time: float = 2.0,
                              block_size: int = 16) -> List[Request]:
    """Request-level multi-turn chat workload (simulator/planner input).

    Each conversation opens with a shared system prompt and grows turn
    over turn: turn ``k``'s prompt is the full prior context (system
    prompt + earlier prompts and replies) plus fresh user tokens, so its
    ``cached_prefix`` — the block-aligned span a prefix-caching server
    already holds — covers everything but the new tail.  Turn 0 of every
    conversation after the first reuses the system prompt itself.
    Arrivals are spaced by exponential user think time; requests come
    back sorted by arrival with contiguous ids.
    """
    prof = profile or CHAT_TASK
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    for c in range(n_conversations):
        ctx = system_prompt_len          # tokens already in the convo
        t = float(rng.exponential(think_time))
        for k in range(turns):
            li_new = int(np.clip(rng.lognormal(prof.in_mu, prof.in_sigma),
                                 8, prof.max_len))
            lo = int(np.clip(rng.lognormal(prof.out_mu, prof.out_sigma),
                             4, prof.max_len))
            input_len = min(ctx + li_new, prof.max_len)
            if k > 0 or c > 0:
                # prior context (or the shared system prompt) is cached
                # at block granularity
                cached = (min(ctx, input_len - 1)
                          // block_size) * block_size
            else:
                cached = 0
            reqs.append(Request(req_id=0, task_type=prof.name,
                                input_len=input_len, output_len=lo,
                                slo=prof.slo, arrival_time=t,
                                cached_prefix=cached))
            ctx = input_len + lo
            t += float(rng.exponential(think_time))
    reqs.sort(key=lambda r: r.arrival_time)
    for i, r in enumerate(reqs):
        r.req_id = i
    return reqs


def sample_multiturn_token_requests(
        n_conversations: int, turns: int = 3, vocab: int = 97,
        seed: int = 0, system_prompt_len: int = 48,
        n_system_prompts: int = 2, user_len=(8, 24), reply_len: int = 8,
        max_new_tokens: int = 8, think_time: float = 0.05,
        profile: Optional[TaskProfile] = None):
    """Token-level multi-turn workload for engine-backed runs.

    Returns ``[(Request, prompt_tokens)]`` sorted by arrival.  Turn
    ``k``'s prompt is turn ``k-1``'s prompt followed by a synthetic
    assistant reply and fresh user tokens, and every conversation opens
    with one of ``n_system_prompts`` *shared* system prompts — so a
    prefix-caching engine serves the repeated span from cached pages.
    ``cached_prefix`` is left 0: the engine's radix index discovers the
    true cached span itself (the actual reply tokens it generated, not
    the synthetic stand-ins, decide what re-matches).
    """
    prof = profile or CHAT_TASK
    rng = np.random.default_rng(seed)
    sys_prompts = [rng.integers(0, vocab, system_prompt_len,
                                dtype=np.int32)
                   for _ in range(max(n_system_prompts, 1))]
    out = []
    for c in range(n_conversations):
        ctx = sys_prompts[c % len(sys_prompts)]
        t = float(rng.exponential(think_time))
        for k in range(turns):
            u = rng.integers(0, vocab,
                             int(rng.integers(user_len[0], user_len[1])),
                             dtype=np.int32)
            prompt = np.concatenate([ctx, u]).astype(np.int32)
            req = Request(req_id=0, task_type=prof.name,
                          input_len=len(prompt),
                          output_len=max_new_tokens, slo=prof.slo,
                          arrival_time=t)
            out.append((req, prompt))
            reply = rng.integers(0, vocab, reply_len, dtype=np.int32)
            ctx = np.concatenate([prompt, reply])
            t += float(rng.exponential(think_time))
    out.sort(key=lambda p: p[0].arrival_time)
    for i, (r, _) in enumerate(out):
        r.req_id = i
    return out
