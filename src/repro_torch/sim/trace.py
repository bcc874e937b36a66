"""Workload traces (§7.1).

The paper replays a production T2I trace [38] and, for burstiness control,
slices it into windows and refits arrivals to a Gamma process parameterized
by the coefficient of variation (CV) — the Clockwork/AlpaServe methodology.
We generate statistically matching traces:

* Poisson / Gamma arrival processes with controllable rate and CV;
* skewed workflow popularity (production traces show the top backbones in
  nearly all workflows and the top-5 ControlNets serving 95% of requests);
* a diurnal "production-like" rate envelope with bursts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class TraceRequest:
    arrival: float
    workflow: str
    inputs: Dict[str, object]


def gamma_interarrivals(
    rate: float, n: int, cv: float, rng: np.random.Generator
) -> np.ndarray:
    """Interarrival times with mean 1/rate and the given CV.

    CV=1 reduces to Poisson; CV>1 is burstier (matches [23, 39]).
    """
    if rate <= 0:
        raise ValueError("rate must be positive")
    shape = 1.0 / (cv * cv)
    scale = cv * cv / rate
    return rng.gamma(shape, scale, size=n)


def skewed_popularity(workflows: Sequence[str], alpha: float = 1.2) -> np.ndarray:
    """Zipf-like popularity over workflow variants (production skew, [38,41])."""
    ranks = np.arange(1, len(workflows) + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return p / p.sum()


def generate_trace(
    workflows: Sequence[str],
    rate: float,
    duration: float,
    cv: float = 1.0,
    seed: int = 0,
    popularity_alpha: float = 1.2,
    prompt_pool: Optional[Sequence[str]] = None,
) -> List[TraceRequest]:
    rng = np.random.default_rng(seed)
    n = max(16, int(rate * duration * 2))
    gaps = gamma_interarrivals(rate, n, cv, rng)
    arrivals = np.cumsum(gaps)
    arrivals = arrivals[arrivals < duration]
    pop = skewed_popularity(workflows, popularity_alpha)
    choices = rng.choice(len(workflows), size=len(arrivals), p=pop)
    prompts = list(prompt_pool or _DEFAULT_PROMPTS)
    out = []
    for t, w in zip(arrivals, choices):
        out.append(
            TraceRequest(
                arrival=float(t),
                workflow=workflows[int(w)],
                inputs={
                    "prompt": prompts[int(rng.integers(len(prompts)))],
                    "seed": int(rng.integers(2**31)),
                },
            )
        )
    return out


def diurnal_trace(
    workflows: Sequence[str],
    base_rate: float,
    duration: float,
    burst_factor: float = 3.0,
    burst_period: float = 120.0,
    burst_width: float = 15.0,
    cv: float = 1.5,
    seed: int = 0,
) -> List[TraceRequest]:
    """Production-like envelope: baseline Gamma traffic + periodic bursts."""
    rng = np.random.default_rng(seed)
    reqs = generate_trace(workflows, base_rate, duration, cv=cv, seed=seed)
    t = burst_period / 2
    pop = skewed_popularity(workflows)
    prompts = list(_DEFAULT_PROMPTS)
    while t < duration:
        n_burst = rng.poisson(base_rate * burst_factor * burst_width)
        for _ in range(n_burst):
            at = float(t + rng.uniform(0, burst_width))
            w = int(rng.choice(len(workflows), p=pop))
            reqs.append(
                TraceRequest(
                    arrival=at,
                    workflow=workflows[w],
                    inputs={"prompt": prompts[int(rng.integers(len(prompts)))],
                            "seed": int(rng.integers(2**31))},
                )
            )
        t += burst_period
    reqs.sort(key=lambda r: r.arrival)
    return reqs


_DEFAULT_PROMPTS = [
    "a watercolor fox in a snowy forest",
    "cyberpunk street market at night, neon rain",
    "portrait of an astronaut, rembrandt lighting",
    "isometric cutaway of a tiny cozy bookshop",
    "macro photo of a dew drop on a fern",
    "paper-cut style mountain landscape at dawn",
    "art nouveau poster of a hummingbird",
    "low-poly render of a desert caravan",
]
