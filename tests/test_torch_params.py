"""The port's initializer draws a large leaf in blocks of rows
(``models/params.py``, ``DRAW_BYTES``), so that a leaf's f32 draw never
exists whole on the device (a stacked leaf of deepseek-coder-33b is
34 GB in f32). On the CPU the blocks draw what one call over the leaf
draws (the generator fills normals 16 at a time and every block but
the last is a whole number of 16s): the same seed gives the same
weights, bit for bit, whatever the block size. Checked here with the
block size cut to a few rows; no JAX."""
import pytest
import torch

from repro_torch.models import params as params_lib

torch.set_num_threads(2)


@pytest.mark.parametrize("shape", [(100, 24), (1000, 7), (37, 5, 3),
                                   (17, 16), (9, 33, 2), (9, 1, 2, 50)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_draws_equal_one_draw(monkeypatch, shape, dtype):
    d = params_lib.ParamDef(shape, scale=0.3)
    cpu = torch.device("cpu")
    whole = params_lib._init_leaf(d, torch.Generator().manual_seed(5), cpu,
                                  dtype)
    monkeypatch.setattr(params_lib, "DRAW_BYTES", 4 * 40)
    blocks = params_lib._row_blocks(shape)
    assert len(blocks) > 1 and blocks[0].start == 0
    assert blocks[-1].stop == shape[0]
    assert all(a.stop == b.start for a, b in zip(blocks, blocks[1:]))
    row = torch.Size(shape[1:]).numel()
    assert all((b.stop - b.start) * row % 16 == 0 for b in blocks[:-1])
    sliced = params_lib._init_leaf(d, torch.Generator().manual_seed(5), cpu,
                                   dtype)
    assert sliced.dtype == dtype and torch.equal(sliced, whole)


def test_block_bounds_the_f32_draw(monkeypatch):
    """Each block's f32 draw holds at most DRAW_BYTES, or one row where a
    row alone is larger (rounded up to whole 16s)."""
    monkeypatch.setattr(params_lib, "DRAW_BYTES", 1 << 12)
    for shape in [(62, 7168, 3), (4096, 128), (7, 5000)]:
        row = torch.Size(shape[1:]).numel()
        for b in params_lib._row_blocks(shape):
            rows = b.stop - b.start
            assert 4 * rows * row <= max(1 << 12, 4 * row) + 4 * 16 * row
