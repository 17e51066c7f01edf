"""The port's ISL routing substrate is bit-equal to the JAX package's.

``repro_torch.orbits.routing`` is a copy of ``repro.orbits.routing``
(held to its source in ``test_torch_plan.py``), and the engine's routing
methods are the reference's bodies. Here both engines, built from one
config, answer the same routing queries with equal arrays
(``np.array_equal``): sink elections (one at a time and batched), routed
cross-plane exits, station-upload pricing with and without lost-upload
retries, earliest arrivals and routed paths. Three configs: ``haps:2``
alone, with a fault plane (satellite outages, ISL drops, upload
losses), and with ``isl_grid_max_bytes`` small enough to stitch the
horizon from at least three windows; in the stitched case the port's windowed answers also
match its own whole-horizon oracle.

The constellation is 2 planes of 8: at 2,000 km, a plane of 4 has no
intra-plane line of sight (neighbours 90 degrees apart are hidden by
the Earth below the 80 km grazing altitude), so every election of a
2x4 shell scores inf and nothing routes.
"""
import functools

import numpy as np
import pytest
import torch

from repro.orbits.routing import WindowedRouter as JaxRouter
from repro.orbits.routing import earliest_arrival as jax_earliest_arrival
from repro.sim import RoundEngine as JaxEngine, SimConfig as JaxConfig
from repro_torch.orbits.routing import WindowedRouter, earliest_arrival
from repro_torch.sim import RoundEngine, SimConfig

torch.set_num_threads(2)

ROUTED = dict(num_orbits=2, sats_per_orbit=8, stations="haps:2",
              model_kind="mlp", num_samples=1500, eval_samples=300,
              local_steps=2, horizon_h=36.0, time_step_s=120.0)
FAULTS = "faults:sat_outage=0.02,isl_drop=0.05,upload_loss=0.3"
# (S, S, W) bytes for W = 128 steps of the 1082-step grid: >= 3 windows.
STITCH_BUDGET = 16 * 16 * 3 * 128
CASES = {
    "haps2": dict(),
    "faults": dict(faults=FAULTS),
    "stitched": dict(isl_grid_max_bytes=STITCH_BUDGET),
}
TIMES = (0.0, 3600.0, 7321.5, 40_000.0, 100_000.0, 125_000.0)


@functools.cache
def _engines(case):
    kw = dict(ROUTED, **CASES[case])
    return JaxEngine(JaxConfig(**kw)), RoundEngine(SimConfig(device="cpu",
                                                            **kw))


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _eq_election(a, b, what):
    for f in ("sinks", "sink_slots", "scores", "lam", "delivery",
              "all_scores"):
        _eq(getattr(a, f), getattr(b, f), f"{what}: {f}")


def test_haps2_sinks_are_finite():
    """The configs really route: some election has a finite score."""
    _, port = _engines("haps2")
    assert any(np.isfinite(port.elect_sinks(t).scores).all()
               for t in TIMES)


@pytest.mark.parametrize("case", list(CASES))
def test_routing_state_bit_equal(case):
    ref, port = _engines(case)
    assert port._window_steps == ref._window_steps
    _eq(port._onehot_lam, ref._onehot_lam, "onehot chain weights")
    _eq(port._same_plane, ref._same_plane, "same-plane mask")
    assert (port._isl_fault is None) == (ref._isl_fault is None)
    if ref._isl_fault is not None:
        _eq(port._isl_fault, ref._isl_fault, "ISL fault mask")
    stitched = case == "stitched"
    assert isinstance(ref.contact_graph(0.0), JaxRouter) == stitched
    assert isinstance(port.contact_graph(0.0), WindowedRouter) == stitched


@pytest.mark.parametrize("case", list(CASES))
def test_elect_sinks_bit_equal(case):
    ref, port = _engines(case)
    for t in TIMES:
        _eq_election(port.elect_sinks(t), ref.elect_sinks(t), f"t={t}")
        for l in range(ROUTED["num_orbits"]):
            _eq_election(port.elect_sinks(t, orbits=(l,)),
                         ref.elect_sinks(t, orbits=(l,)), f"t={t} l={l}")


@pytest.mark.parametrize("case", list(CASES))
def test_elect_sinks_batch_bit_equal(case):
    ref, port = _engines(case)
    rng = np.random.default_rng(3)
    ls = rng.integers(0, ROUTED["num_orbits"], 12)
    ts = np.concatenate([rng.uniform(0.0, 120_000.0, 10), [3600.0, 3600.0]])
    _eq_election(port.elect_sinks_batch(ls, ts),
                 ref.elect_sinks_batch(ls, ts), "batch")


@pytest.mark.parametrize("case", list(CASES))
def test_route_exit_ends_bit_equal(case):
    ref, port = _engines(case)
    n = ref.n_sats
    rng = np.random.default_rng(5)
    sats = rng.integers(0, n, 10)
    ts = np.concatenate([rng.uniform(0.0, 125_000.0, 8), [np.inf, np.nan]])
    _eq(port.route_exit_ends(sats, ts), ref.route_exit_ends(sats, ts),
        "route_exit_ends")
    for sat, t in zip(sats[:3], ts[:3]):
        assert port.route_exit_end(int(sat), float(t)) == \
            ref.route_exit_end(int(sat), float(t))
    got, want = port.route_exit_plan(3, 7200.0), ref.route_exit_plan(3,
                                                                     7200.0)
    assert got == want


@pytest.mark.parametrize("case", list(CASES))
def test_upload_pricing_bit_equal(case):
    ref, port = _engines(case)
    sats = np.arange(ref.n_sats)[:, None]
    ts = np.array([0.0, 1234.5, 50_000.0, 120_000.0, 129_000.0,
                   np.inf])[None, :]
    _eq(port.station_upload_end(sats, ts), ref.station_upload_end(sats, ts),
        "station_upload_end")
    _eq(port.upload_end(sats, ts), ref.upload_end(sats, ts), "upload_end")
    assert port.upload_end(3, 600.0) == ref.upload_end(3, 600.0)
    _eq(port.upload_survives(sats, ts[:, :-1]),
        ref.upload_survives(sats, ts[:, :-1]), "upload_survives")


@pytest.mark.parametrize("case", list(CASES))
def test_earliest_arrival_bit_equal(case):
    ref, port = _engines(case)
    srcs = [0, 5, 11]
    for t0 in (0.0, 3600.0, 100_000.0):
        _eq(earliest_arrival(port.contact_graph(t0), srcs, t0),
            jax_earliest_arrival(ref.contact_graph(t0), srcs, t0),
            f"contact graph t0={t0}")
        for l in range(ROUTED["num_orbits"]):
            _eq(earliest_arrival(port.orbit_subgraph(l, t0), [0, 2], t0),
                jax_earliest_arrival(ref.orbit_subgraph(l, t0), [0, 2], t0),
                f"orbit {l} subgraph t0={t0}")


def test_stitched_router_matches_its_oracle():
    """Within the port: the stitched router spans >= 3 windows and routes
    exactly like the whole-horizon graph, and its sink elections equal
    those of an engine whose one graph fits the budget."""
    _, port = _engines("stitched")
    router = port.contact_graph(0.0)
    assert isinstance(router, WindowedRouter)
    assert len(router.window_starts(0.0)) >= 3
    oracle = port.full_contact_graph()
    for t0 in (0.0, 3600.0, 40_000.0, 100_000.0):
        got = earliest_arrival(router, [0, 5, 11], t0)
        want = earliest_arrival(oracle, [0, 5, 11], t0)
        np.testing.assert_allclose(np.nan_to_num(got, posinf=1e18),
                                   np.nan_to_num(want, posinf=1e18),
                                   rtol=1e-12, atol=1e-9)
    _, whole = _engines("haps2")
    assert not isinstance(whole.contact_graph(0.0), WindowedRouter)
    for t in TIMES:
        a, b = port.elect_sinks(t), whole.elect_sinks(t)
        np.testing.assert_array_equal(a.sinks, b.sinks)
        np.testing.assert_allclose(a.scores, b.scores)
        np.testing.assert_allclose(a.delivery, b.delivery)
