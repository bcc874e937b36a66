"""The port's workload traces (``repro_torch.sim.trace``) against the JAX
package's: the same arguments give the same trace exactly (every arrival
float, workflow and ``inputs`` dict), since both draw from numpy's
``default_rng`` in the same order.  No tolerance: equality."""

import numpy as np
import pytest

import repro.sim as jsim
import repro.sim.trace as jtrace
import repro_torch.sim as tsim
import repro_torch.sim.trace as ttrace

WORKFLOWS = ["sd3:basic", "sd3:cn1", "sd3:cn2"]


def _rows(trace):
    return [(r.arrival, r.workflow, r.inputs) for r in trace]


@pytest.mark.parametrize("rate,duration,cv,seed,alpha", [
    (1.0, 120.0, 2.0, 0, 1.2),       # the launcher's defaults
    (0.5, 60.0, 1.0, 3, 1.2),        # Poisson
    (2.5, 90.0, 2.0, 4, 0.8),
    (8.0, 30.0, 4.0, 11, 2.0),
    (0.05, 10.0, 0.5, 7, 1.2),       # fewer arrivals than the 16 drawn
])
@pytest.mark.parametrize("pool", [None, ["a fox", "two foxes", "a tram"]])
def test_generate_trace_equals_reference(rate, duration, cv, seed, alpha, pool):
    kw = dict(cv=cv, seed=seed, popularity_alpha=alpha, prompt_pool=pool)
    want = jtrace.generate_trace(WORKFLOWS, rate, duration, **kw)
    got = ttrace.generate_trace(WORKFLOWS, rate, duration, **kw)
    assert _rows(got) == _rows(want)
    assert all(type(r.arrival) is float for r in got)


@pytest.mark.parametrize("base_rate,duration,burst_factor,burst_period,"
                         "burst_width,cv,seed", [
    (0.5, 300.0, 3.0, 120.0, 15.0, 1.5, 0),   # the defaults
    (1.0, 200.0, 5.0, 60.0, 10.0, 2.0, 5),
    (0.2, 90.0, 2.0, 30.0, 5.0, 1.0, 9),
])
def test_diurnal_trace_equals_reference(base_rate, duration, burst_factor,
                                        burst_period, burst_width, cv, seed):
    kw = dict(burst_factor=burst_factor, burst_period=burst_period,
              burst_width=burst_width, cv=cv, seed=seed)
    want = jtrace.diurnal_trace(WORKFLOWS, base_rate, duration, **kw)
    got = ttrace.diurnal_trace(WORKFLOWS, base_rate, duration, **kw)
    assert _rows(got) == _rows(want)
    assert [r.arrival for r in got] == sorted(r.arrival for r in got)


@pytest.mark.parametrize("rate,cv", [(1.0, 1.0), (3.0, 2.5), (0.2, 0.4)])
def test_interarrivals_and_popularity_equal_reference(rate, cv):
    want = jtrace.gamma_interarrivals(rate, 64, cv, np.random.default_rng(1))
    got = ttrace.gamma_interarrivals(rate, 64, cv, np.random.default_rng(1))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ttrace.skewed_popularity(WORKFLOWS, cv),
                                  jtrace.skewed_popularity(WORKFLOWS, cv))
    assert ttrace._DEFAULT_PROMPTS == jtrace._DEFAULT_PROMPTS
    with pytest.raises(ValueError, match="rate must be positive"):
        ttrace.gamma_interarrivals(0.0, 4, cv, np.random.default_rng(0))


def test_sim_package_exports_the_reference_names():
    want = {n for n in vars(jsim) if not n.startswith("_")} - {
        "invariants", "metrics", "monolithic", "trace"}
    got = {n for n in vars(tsim) if not n.startswith("_")}
    assert want <= got, want - got
