"""The rest of the port's ``core/`` and the sim shims against the JAX
package: ``core/aggregation.py`` (Eq. 14 in ``paper`` and ``exact``
modes, the Eq. 15 set cover, the Eq. 16 tree), ``core/strategies.py``
(``TABLE2_SETUPS``) and the ``sim/timeline.py`` deprecation shim.

Mirrors ``tests/test_aggregation.py``, ``test_aggregation_properties.py``
(whose ``hypothesis`` draws become seeded cases here, so they run
without the optional extra) and ``test_timeline_shim.py``. Models are
the port's param trees (``{"w": tensor}``) in float64, so the recursions
hold to the JAX package's own ``rtol=1e-9``; weights and segments are
numpy on both sides and must be bit-equal.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core.strategies import TABLE2_SETUPS as JAX_SETUPS
from repro_torch.core import aggregation as agg
from repro_torch.core.strategies import TABLE2_SETUPS

torch.set_num_threads(2)

TINY = dict(strategy="fedhap", stations="one_hap", model_kind="mlp",
            num_samples=1500, eval_samples=300, local_steps=2,
            horizon_h=24.0, time_step_s=120.0, max_rounds=2, device="cpu")


def _m(x):
    return {"w": torch.as_tensor(np.asarray(x, np.float64))}


def _w(tree):
    return tree["w"].numpy()


def test_core_exports_match_the_reference():
    import repro.core as jcore
    import repro_torch.core as core
    assert core.__all__ == jcore.__all__
    for name in core.__all__:
        assert hasattr(core, name), name


def test_paper_mode_is_order_dependent():
    """Documented deviation: Eq. 14 weights depend on fold order."""
    sizes = [10.0, 10.0, 10.0]
    lam = agg.chain_weights(sizes, m_orbit_total=30.0, mode="paper")
    assert not np.allclose(lam, 1.0 / 3.0)
    np.testing.assert_array_equal(
        lam, jagg.chain_weights(sizes, m_orbit_total=30.0, mode="paper"))
    lam_e = agg.chain_weights(sizes, 30.0, mode="exact")
    np.testing.assert_allclose(lam_e, 1.0 / 3.0)


@pytest.mark.parametrize("visible,sizes,mode,want_end", [
    ([0, 0, 0, 0], [1, 1, 1, 1], "paper", [-1, -1, -1, -1]),
    ([1, 1, 1, 1], [1, 1, 1, 1], "paper", [1, 2, 3, 0]),
    ([0, 0, 1, 0], [1, 2, 3, 4], "paper", [2, 2, 2, 2]),
    ([1, 0, 1, 0, 0, 1], [3, 1, 4, 1, 5, 9], "exact", None),
], ids=["none_visible", "all_visible", "one_visible", "mixed_exact"])
def test_segment_upload_weights(visible, sizes, mode, want_end):
    visible = np.array(visible, bool)
    sizes = np.array(sizes, float)
    got = agg.segment_upload_weights(visible, sizes, mode)
    want = jagg.segment_upload_weights(visible, sizes, mode)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    lam, seg_end, seg_mass = got
    if want_end is not None:
        np.testing.assert_array_equal(seg_end, want_end)
    if not visible.any():
        assert lam.sum() == 0.0
    elif visible.sum() == 1:
        np.testing.assert_allclose(seg_mass, sizes.sum())
        np.testing.assert_allclose(lam.sum(), 1.0, rtol=1e-12)


def test_no_visible_orbit_gates_global_weights():
    from repro_torch.core import mu_weights
    vis = np.array([True, False, True, False, False, False, False, False])
    mu = mu_weights(vis, np.ones(8), 4, "paper", "paper", xp=np)
    assert (mu[4:] == 0.0).all()
    np.testing.assert_allclose(mu[:4].sum(), 0.5, rtol=1e-12)


@pytest.mark.parametrize("parts,want_kept,want_cover", [
    ([({0, 1}, "m01"), ({1, 2}, "m12"), ({2, 3}, "m23")],
     ["m01", "m23"], {0, 1, 2, 3}),
    ([({0, 1, 2}, "a"), ({2, 3, 4}, "b"), ({3, 4}, "c"), ({3}, "d")],
     ["a", "c"], {0, 1, 2, 3, 4}),
    ([], [], set()),
], ids=["overlap", "first_arrival", "empty"])
def test_dedup_set_cover(parts, want_kept, want_cover):
    partials = [(frozenset(ids), float(len(ids)), m) for ids, m in parts]
    kept, covered = agg.dedup_set_cover(partials)
    assert [m for _, _, m in kept] == want_kept
    assert covered == want_cover
    assert (kept, covered) == jagg.dedup_set_cover(partials)


@pytest.mark.parametrize("mode", ["global", "paper"])
def test_full_aggregate_matches_eq16(mode):
    per_orbit = {0: [(1.0, [1.0]), (3.0, [2.0])], 1: [(4.0, [10.0])]} \
        if mode == "global" else {0: [(1.0, [0.0])], 1: [(100.0, [10.0])]}
    want_value = (1 * 1 + 3 * 2 + 4 * 10) / 8.0 if mode == "global" else 5.0
    got = agg.full_aggregate(
        {l: [(m, _m(x)) for m, x in ps] for l, ps in per_orbit.items()},
        mode)
    want = jagg.full_aggregate(
        {l: [(m, np.array(x)) for m, x in ps] for l, ps in per_orbit.items()},
        mode)
    np.testing.assert_allclose(_w(got), [want_value])
    np.testing.assert_allclose(_w(got), want, rtol=1e-12)


@pytest.mark.parametrize("bad", ["empty", "unknown_weighting"])
def test_full_aggregate_raises(bad):
    with pytest.raises(ValueError):
        if bad == "empty":
            agg.full_aggregate({})
        else:
            agg.full_aggregate({0: [(1.0, _m([1.0]))]}, "nope")


def test_partial_aggregate_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown partial"):
        agg.partial_aggregate(_m([1.0]), _m([2.0]), 1.0, 2.0, 1.0, "nope")


# The property tests' draws as seeded cases.
def _sizes(seed, lo, hi, max_size):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=int(rng.integers(1, max_size + 1)))


@pytest.mark.parametrize("mode", ["paper", "exact"])
@pytest.mark.parametrize("seed", range(6))
def test_chain_weights_sum_to_one(seed, mode):
    sizes = _sizes(seed, 1.0, 1000.0, 8).tolist()
    lam = agg.chain_weights(sizes, m_orbit_total=sum(sizes) * 2.0, mode=mode)
    assert lam.shape == (len(sizes),)
    np.testing.assert_allclose(lam.sum(), 1.0, rtol=1e-12)
    assert (lam >= 0).all()
    np.testing.assert_array_equal(
        lam, jagg.chain_weights(sizes, sum(sizes) * 2.0, mode=mode))


def _recursion(module, models, sizes, m_orbit, mode, wrap):
    acc, m_acc = wrap(models[0]), sizes[0]
    for w_new, m_new in zip(models[1:], sizes[1:]):
        acc, m_acc = module.partial_aggregate(
            acc, wrap(w_new), m_new, m_orbit, m_acc, mode=mode)
    return acc


@pytest.mark.parametrize("seed", range(6))
def test_paper_recursion_matches_chain_weights(seed):
    """chain_weights reproduces the literal Eq.-14 recursion; the port's
    recursion matches the JAX package's."""
    sizes = _sizes(100 + seed, 1.0, 100.0, 6).tolist()
    m_orbit = sum(sizes) * 1.5
    rng = np.random.default_rng(0)
    models = [rng.normal(size=4) for _ in sizes]
    got = _w(_recursion(agg, models, sizes, m_orbit, "paper", _m))
    lam = agg.chain_weights(sizes, m_orbit, mode="paper")
    np.testing.assert_allclose(
        got, sum(l * m for l, m in zip(lam, models)), rtol=1e-9)
    want = _recursion(jagg, models, sizes, m_orbit, "paper", np.asarray)
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_exact_recursion_is_weighted_mean(seed):
    """The beyond-paper 'exact' recursion telescopes to the weighted
    mean — the property the paper's recursion lacks."""
    sizes = _sizes(200 + seed, 1.0, 100.0, 6).tolist()
    rng = np.random.default_rng(1)
    models = [rng.normal(size=3) for _ in sizes]
    got = _w(_recursion(agg, models, sizes, sum(sizes), "exact", _m))
    want = sum(m * w for m, w in zip(sizes, models)) / sum(sizes)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    np.testing.assert_allclose(
        got, _recursion(jagg, models, sizes, sum(sizes), "exact",
                        np.asarray), rtol=1e-12)


@pytest.mark.parametrize("mode", ["paper", "exact"])
@pytest.mark.parametrize("seed", range(5))
def test_full_coverage_when_any_visible(seed, mode):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 9))
    visible = rng.random(k) < 0.4
    if not visible.any():
        visible[rng.integers(k)] = True
    sizes = rng.uniform(1, 50, size=k)
    lam, seg_end, seg_mass = agg.segment_upload_weights(visible, sizes, mode)
    assert (seg_end >= 0).all()
    assert visible[seg_end].all()
    for end in np.unique(seg_end):
        members = seg_end == end
        np.testing.assert_allclose(lam[members].sum(), 1.0, rtol=1e-9)
        np.testing.assert_allclose(
            seg_mass[members], sizes[members].sum(), rtol=1e-9)


@pytest.mark.parametrize("seed", range(5))
def test_full_aggregate_weights_sum_to_one(seed):
    rng = np.random.default_rng(seed)
    per_orbit = {}
    for l in range(rng.integers(1, 4)):
        per_orbit[l] = [(float(rng.uniform(1, 10)), _m(np.ones(3)))
                        for _ in range(rng.integers(1, 4))]
    for mode in ("paper", "global"):
        out = agg.full_aggregate(per_orbit, mode)
        np.testing.assert_allclose(_w(out), np.ones(3), rtol=1e-9)


def test_table2_setups_match_the_reference():
    """The port's Table II setups are the JAX package's, field for field
    (the port's ``SimConfig`` adds ``device``, left at its default);
    building them touches no device."""
    assert list(TABLE2_SETUPS) == list(JAX_SETUPS)
    for name, cfg in TABLE2_SETUPS.items():
        want = JAX_SETUPS[name]
        for f in dataclasses.fields(want):
            if f.name != "mesh":
                assert getattr(cfg, f.name) == getattr(want, f.name), \
                    (name, f.name)
        assert cfg.device == "cuda"


def test_timeline_import_warns_deprecation():
    with pytest.warns(DeprecationWarning, match="repro_torch.sim.timeline"):
        from repro_torch.sim.timeline import SatcomSimulator  # noqa: F401


def test_timeline_legacy_names_forward():
    import repro_torch.sim.timeline as tl
    from repro_torch.sim import engine
    with pytest.warns(DeprecationWarning):
        for name in ("RoundEngine", "SatcomSimulator", "SimConfig",
                     "SimResult", "_make_stations"):
            assert getattr(tl, name) is getattr(engine, name)
    assert engine.SatcomSimulator is engine.RoundEngine
    with pytest.raises(AttributeError):
        tl.no_such_symbol


def test_timeline_shim_results_bit_identical():
    """A run through the shim import equals a run through the registry
    entry point, event for event, bit for bit."""
    from repro_torch.sim import RoundEngine, SimConfig
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro_torch.sim.timeline import SatcomSimulator as LegacySim
        from repro_torch.sim.timeline import SimConfig as LegacyConfig
    legacy = LegacySim(LegacyConfig(**TINY)).run()
    fresh = RoundEngine(SimConfig(**TINY)).run()
    assert legacy.history == fresh.history
    assert legacy.final_accuracy == fresh.final_accuracy
    assert legacy.rounds == fresh.rounds
    assert legacy.sim_hours == fresh.sim_hours
