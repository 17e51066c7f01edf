"""``examples/quickstart_torch.py`` runs its ``main`` on the CPU at a tiny
size and prints an accuracy per round."""
import importlib.util
import pathlib

import pytest
import torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("sampled", [False, True])
def test_main_on_the_cpu(sampled, capsys):
    _quickstart().main(sampled=sampled, device="cpu", num_samples=1200,
                       eval_samples=240, local_steps=2, max_rounds=2)
    out = capsys.readouterr().out
    assert "device cpu" in out
    rows = [line.split() for line in out.splitlines()
            if line.strip() and line.split()[0].replace(".", "").isdigit()]
    assert [int(r[1]) for r in rows] == [1, 2]
    assert all(0.0 <= float(r[2]) <= 1.0 for r in rows)
    assert "final accuracy" in out


def test_default_device_is_the_card():
    """Without ``--cpu`` the quickstart asks for the card: here, where
    there is none, the engine raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="is_available"):
        _quickstart().main(num_samples=1200, eval_samples=240,
                           local_steps=2, max_rounds=1)
