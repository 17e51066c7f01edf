"""The port's numpy plan half is bit-equal to the JAX package's.

The modules copied into ``repro_torch`` differ from their originals only
in their import lines (checked on the source), and the engines built
from one config agree bit for bit: dataset and partitions, visibility
and delay tables, next-contact tables, client-plane index tables and a
chain of FedHAP round plans.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.sim import RoundEngine as JaxEngine, SimConfig as JaxConfig
from repro.sim.strategies import FedHap as JaxFedHap
from repro_torch.sim import RoundEngine, SimConfig
from repro_torch.sim.strategies import FedHap

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent

# Copied as they are; only `from repro.` / `import repro.` lines change.
COPIED = [
    "configs/paper_cnn.py", "configs/paper_mlp.py",
    "configs/base.py", "configs/qwen3_0_6b.py",
    "data/digits.py", "data/partition.py", "data/loader.py",
    "data/tokens.py",
    "core/weights.py",
    "orbits/constellation.py", "orbits/visibility.py", "orbits/links.py",
    "faults/plane.py", "faults/__init__.py",
    "clients/partitioners.py", "clients/plane.py",
    "sim/strategies/fedhap.py",
    "orbits/routing.py",
    "sim/strategies/fedisl.py", "sim/strategies/fedsink.py",
    "sim/strategies/fedhap_async.py", "sim/strategies/fedhap_buffered.py",
    "data/eo.py", "data/__init__.py", "clients/registry.py",
]

SMALL = dict(num_orbits=2, sats_per_orbit=4, num_samples=1500,
             eval_samples=300, local_steps=2, horizon_h=36.0,
             time_step_s=120.0, model_kind="mlp")


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_differs_only_in_imports(rel):
    ref = (ROOT / "src" / "repro" / rel).read_text()
    port = (ROOT / "src" / "repro_torch" / rel).read_text()
    rewritten = re.sub(r"\b(from|import) repro\.", r"\1 repro_torch.", ref)
    assert port == rewritten


# The plan-phase methods of modules that are not copied whole (their
# execute halves differ): each method's source is the reference's.
PLAN_METHODS = [
    ("sim/strategies/fedsat.py", "FedSat", "_plan_tick"),
    ("sim/strategies/fedspace.py", "FedSpace", "_flush_size"),
]


@pytest.mark.parametrize("rel,cls,method", PLAN_METHODS,
                         ids=[f"{c}.{m}" for _, c, m in PLAN_METHODS])
def test_plan_method_verbatim(rel, cls, method):
    import ast

    def source(root):
        text = (ROOT / "src" / root / rel).read_text()
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.ClassDef) and node.name == cls:
                for fn in node.body:
                    if isinstance(fn, ast.FunctionDef) and fn.name == method:
                        return ast.get_source_segment(text, fn)
        raise AssertionError(f"{root}/{rel}: no {cls}.{method}")
    assert source("repro_torch") == source("repro")


def _engines(**overrides):
    kw = dict(SMALL, **overrides)
    return JaxEngine(JaxConfig(**kw)), RoundEngine(SimConfig(device="cpu",
                                                            **kw))


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("stations,faults,clients,table_bytes", [
    ("one_hap", "", "static", 512 * 2**20),
    ("two_hap", "", "static", 512 * 2**20),
    ("two_hap", "", "static", 0),           # lazy per-column delay path
    ("haps:3", "", "sampled:0.5x40", 512 * 2**20),
    ("one_hap", "", "geo:4x40@0.5", 512 * 2**20),
    ("one_hap", "faults:sat_outage=0.05,upload_loss=0.3,hap_outage=0.05",
     "static", 512 * 2**20),
])
def test_engine_plan_half_bit_equal(stations, faults, clients, table_bytes):
    ref, port = _engines(stations=stations, faults=faults, clients=clients,
                         delay_table_max_bytes=table_bytes)
    _eq(ref.fd.images, port.fd.images, "train images")
    _eq(ref.fd.labels, port.fd.labels, "train labels")
    _eq(ref.eval_images, port.eval_images, "eval images")
    _eq(ref.eval_labels, port.eval_labels, "eval labels")
    assert len(ref.fd.client_indices) == len(port.fd.client_indices)
    for i, (a, b) in enumerate(zip(ref.fd.client_indices,
                                   port.fd.client_indices)):
        _eq(a, b, f"partition {i}")
    _eq(ref.sizes, port.sizes, "sizes")
    for name in ("vis", "shl_table", "orbit_next", "sat_next", "grid_t"):
        _eq(getattr(ref, name), getattr(port, name), name)
    assert ref.model_bits == port.model_bits
    assert ref.isl_delay() == port.isl_delay()
    assert ref.ring_delay() == port.ring_delay()
    assert ref.train_time() == port.train_time()
    assert ref.orbit_slice(1) == port.orbit_slice(1)
    for t_s in (0.0, 4321.0, 1e9):
        _eq(ref.vis_at(t_s), port.vis_at(t_s), "vis_at")
        _eq(ref.first_orbit_contacts(t_s), port.first_orbit_contacts(t_s),
            "first_orbit_contacts")
        assert ref.shl_delay(0, 3, t_s) == port.shl_delay(0, 3, t_s)

    # A chain of plans, each followed by the round's index resolve (the
    # order both execution paths consume the engine rng in).
    t_r = t_p = 0.0
    for _ in range(5):
        pr, pp = JaxFedHap().plan_round(ref, t_r), FedHap().plan_round(
            port, t_p)
        assert (pr is None) == (pp is None)
        if pr is None:
            break
        _eq(pr.orbit_t, pp.orbit_t, "orbit_t")
        _eq(pr.mu, pp.mu, "mu")
        assert pr.round_end == pp.round_end and pr.t_next == pp.t_next
        sats = np.arange(ref.n_sats)
        _eq(ref.sample_indices(sats, t_r), port.sample_indices(sats, t_p),
            "sample_indices")
        t_r, t_p = pr.t_next, pp.t_next


def test_fault_plane_tables_bit_equal():
    spec = "faults:sat_outage=0.05,isl_drop=0.1,upload_loss=0.3," \
           "hap_outage=0.05"
    ref, port = _engines(stations="two_hap", faults=spec)
    for name in ("st_up", "sat_up", "upload_ok", "isl_fault"):
        _eq(getattr(ref.fault_plane, name), getattr(port.fault_plane, name),
            name)


def test_weights_engine_bit_equal():
    from repro.core import weights as jw
    from repro_torch.core import weights as tw
    rng = np.random.default_rng(3)
    vis = rng.random((6, 8)) < 0.3
    sizes = rng.integers(100, 2000, (6, 8)).astype(np.float64)
    for mode in ("paper", "exact"):
        lam_r, seg_r = jw.chain_stats(vis, sizes, mode)
        lam_p, seg_p = tw.chain_stats(vis, sizes, mode)
        _eq(lam_r, lam_p, "lam")
        _eq(seg_r, seg_p, "seg_mass")
        for ow in ("paper", "global"):
            _eq(jw.mu_from_chain(lam_r, seg_r, sizes, ow),
                tw.mu_from_chain(lam_p, seg_p, sizes, ow), "mu")
    _eq(jw.segment_ends(vis), tw.segment_ends(vis), "segment_ends")
