"""The port's dataset registry equals the JAX package's: the same names,
and ``tokens`` and ``synthetic_eo`` (with ``data/eo.py`` copied into the
port) bit-equal to ``repro.clients.load_dataset``'s for two seeds; an
engine of each config stages the same arrays."""
import numpy as np
import pytest
import torch

from repro.clients import available_datasets as ref_available
from repro.clients import load_dataset as ref_load
from repro.data import make_eo_dataset_with_latitude as ref_eo_lat
from repro.sim import RoundEngine as JaxEngine, SimConfig as JaxConfig
from repro_torch.clients import available_datasets, load_dataset
from repro_torch.data import make_eo_dataset_with_latitude
from repro_torch.sim import RoundEngine, SimConfig

torch.set_num_threads(2)


def test_registry_names_equal_the_reference():
    assert available_datasets() == ref_available()
    assert {"digits", "tokens", "synthetic_eo"} <= set(available_datasets())


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("spec,kw", [
    ("tokens", dict(num_samples=500)),
    ("tokens", dict(num_samples=300, seq_len=16, vocab_size=512,
                    num_classes=8)),
    ("synthetic_eo", dict(num_samples=400)),
    ("synthetic_eo:250", dict(num_classes=5, noise=0.0)),
    ("digits:150", {}),
], ids=["tokens", "tokens_small_vocab", "eo", "eo_inline", "digits"])
def test_arrays_bit_equal_to_reference(spec, kw, seed):
    x, y = load_dataset(spec, seed=seed, **kw)
    rx, ry = ref_load(spec, seed=seed, **kw)
    assert x.dtype == rx.dtype and y.dtype == ry.dtype
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)


def test_eo_latitudes_bit_equal():
    got = make_eo_dataset_with_latitude(600, seed=3)
    want = ref_eo_lat(600, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_unknown_dataset_raises():
    with pytest.raises(KeyError, match="available"):
        load_dataset("nope")


@pytest.mark.parametrize("dataset", ["tokens", "synthetic_eo"])
def test_engine_stages_the_reference_arrays(dataset):
    """``SimConfig(dataset=...)`` builds in both packages (it raised
    KeyError in the port before), with the same train shards and eval
    set."""
    kw = dict(dataset=dataset, num_orbits=2, sats_per_orbit=4,
              num_samples=800, eval_samples=160, horizon_h=6.0,
              model_kind="mlp")
    eng = RoundEngine(SimConfig(device="cpu", **kw))
    ref = JaxEngine(JaxConfig(**kw))
    np.testing.assert_array_equal(eng.fd.images, ref.fd.images)
    np.testing.assert_array_equal(eng.fd.labels, ref.fd.labels)
    np.testing.assert_array_equal(eng.eval_images, ref.eval_images)
    np.testing.assert_array_equal(eng.sizes, ref.sizes)
