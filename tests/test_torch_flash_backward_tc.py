"""The numerics of the flash backward's tensor-core kernels
(``csrc/flash_attention_bwd.cu``, the ``tc`` variant), emulated on the
CPU.

The kernels run only on the card. Their arithmetic is the plain
backward's (``flash_attention_bwd_plain``: f32 scores, probabilities,
dP, Δ and dS, f32 sums) except for one thing: the three products that
take P or dS as their A operand (dV = Pᵀ·dO, dK = dSᵀ·Q, dQ = dS·K) need
it in bf16. ``_tc_bwd_emulation`` reproduces that rounding, where the
kernels make it, and these tests hold it to the tolerance that
``chip_smoke.py`` holds the kernels to (``BWD_BF16_TOL``) and to
``jax.grad`` of the JAX package's oracle ``ref.flash_attention_ref``.
They show why P and dS go in as two bf16 parts (hi = bf16(x), lo =
bf16(x − hi)) on every tile: rounded once, on every tile or only on the
tiles that cross a mask edge (the forward's rule), they break it.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import build, flash_attention as fa_mod

from _torch_jamba import chip_smoke

torch.set_num_threads(2)

# The tc kernels' tiles: a dK/dV consumer group takes 64 keys against
# 64-row query tiles; a dQ consumer group 64 query rows against 128-key
# tiles.
DKDV_ROWS, DKDV_KEYS = 64, 64
DQ_ROWS, DQ_KEYS = 64, 128
SPLITS = ("all", "edge", "none")


def _edge(sq: int, sk: int, causal: bool, window: int | None, rows: int,
          keys: int) -> torch.Tensor:
    """(Sq, Sk) bool: whether the (rows x keys) block of a pair holds a
    masked pair (the causal diagonal, a window's edge, ragged Sq or Sk),
    as the kernels decide per consumer group and tile."""
    nq, nk = -(-sq // rows), -(-sk // keys)
    ok = torch.zeros(nq * rows, nk * keys, dtype=torch.bool)
    ok[:sq, :sk] = fa_mod._mask(sq, sk, causal, window, torch.device("cpu"))
    edge = ~ok.view(nq, rows, nk, keys).all(3).all(1)
    return (edge.repeat_interleave(rows, 0).repeat_interleave(keys, 1)
            [:sq, :sk])


def _operand(x: torch.Tensor, split: str, edge: torch.Tensor) -> torch.Tensor:
    """x (f32) as a product's A operand: bf16(x), or bf16(x) + bf16(x −
    bf16(x)) where the kernel splits it (``split`` "all", or "edge" on the
    tiles of ``edge``)."""
    hi = x.to(torch.bfloat16).float()
    if split == "none":
        return hi
    two = hi + (x - hi).to(torch.bfloat16).float()
    return two if split == "all" else torch.where(edge, two, hi)


def _tc_bwd_emulation(q, k, v, o, lse, do, causal=True, window=None,
                      split="all"):
    """The tc kernels' arithmetic in PyTorch on the CPU -> (dq, dk, dv) in
    q's dtype: f32 S = Q·Kᵀ of the inputs, P = exp(S·scale − lse) (0 where
    masked), f32 dP = dO·Vᵀ, Δ = rowsum(dO ⊙ O) and dS = P ⊙ (dP − Δ);
    then P and dS as the products' bf16 A operands (``split``: "all"
    splits each into hi + lo on every tile, as the kernels do; "edge" only
    on the tiles that cross a mask edge; "none" rounds once), f32 sums,
    dK and dQ scaled, dK and dV summed over each KV head's query heads,
    each gradient rounded once."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = 1.0 / math.sqrt(d)
    kq = k.repeat_interleave(group, 1).float()
    vq = v.repeat_interleave(group, 1).float()
    s, ok = fa_mod._scores(q, k, causal, window)
    p = torch.where(ok, torch.exp(s - lse.float()[..., None]),
                    torch.zeros_like(s))
    dof = do.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vq)
    ds = p * (dp - (dof * o.float()).sum(-1, keepdim=True))
    kv_edge = _edge(sq, sk, causal, window, DKDV_ROWS, DKDV_KEYS)
    q_edge = _edge(sq, sk, causal, window, DQ_ROWS, DQ_KEYS)
    dv = torch.einsum("bhqk,bhqd->bhkd", _operand(p, split, kv_edge), dof)
    dk = torch.einsum("bhqk,bhqd->bhkd", _operand(ds, split, kv_edge),
                      q.float()) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", _operand(ds, split, q_edge),
                      kq) * scale
    dk = dk.view(b, hkv, group, sk, d).sum(2)
    dv = dv.view(b, hkv, group, sk, v.shape[3]).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _train_like(seed, b=1, h=8, hkv=4, s=1024, d=128, dv=None):
    """The training shape's rows (S=1024, qwen3's D=128 and group of 2, or
    MLA's (96, 64) with ``dv``) at reduced heads, bf16, with the
    forward's o and lse from the plain version."""
    dv = d if dv is None else dv
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16) for shape in (
        (b, h, s, d), (b, hkv, s, d), (b, hkv, s, dv), (b, h, s, dv)))
    o = fa_mod.flash_attention_plain(q, k, v)
    lse = fa_mod.flash_attention_lse_plain(q, k)
    return q, k, v, o, lse, do


def _breaks(got, want, tol) -> bool:
    return any(not torch.allclose(g.float(), w.float(), **tol)
               for g, w in zip(got, want))


@pytest.mark.parametrize("seed", [30, 31])
def test_tc_bwd_numerics_fit_bwd_tolerance(seed):
    """The kernels' rounding (P and dS as hi + lo on every tile) meets
    the tolerance chip_smoke.py holds them to at the training shape."""
    tol = chip_smoke().BWD_BF16_TOL
    q, k, v, o, lse, do = _train_like(seed)
    got = _tc_bwd_emulation(q, k, v, o, lse, do)
    want = fa_mod.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   **tol, err_msg=name)


@pytest.mark.parametrize("seed,h,hkv", [(32, 4, 4), (33, 4, 2)])
def test_tc_bwd_split_numerics_fit_bwd_tolerance(seed, h, hkv):
    """The same at MLA's (96, 64) training rows (S=1024, minicpm3-4b's
    group of 1, and a group of 2): the n128 products over q's and k's zero
    half add exact zeros, so the rounding is the D = Dv kernels'."""
    tol = chip_smoke().BWD_BF16_TOL
    q, k, v, o, lse, do = _train_like(seed, h=h, hkv=hkv, d=96, dv=64)
    got = _tc_bwd_emulation(q, k, v, o, lse, do)
    want = fa_mod.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   **tol, err_msg=name)


@pytest.mark.parametrize("split", ["none", "edge"])
def test_bf16_p_and_ds_break_bwd_tolerance(split):
    """Why the kernels split P and dS on every tile: rounded once to bf16
    ("none"), or split only on the tiles that cross a mask edge as the
    forward does for P ("edge"), they move gradients near 0 past the
    tolerance's atol. The large P of the early rows (few keys) reaches
    the gradients of every key they see, far from the diagonal."""
    tol = chip_smoke().BWD_BF16_TOL
    q, k, v, o, lse, do = _train_like(30)
    want = fa_mod.flash_attention_bwd_plain(q, k, v, o, lse, do)
    assert _breaks(_tc_bwd_emulation(q, k, v, o, lse, do, split=split),
                   want, tol)


# (B, H, Hkv, Sq, Sk, D, causal, window): the tc variant's head dims,
# GQA groups 1, 2, 4 and 8, causal and not, windows, Sq != Sk both ways
# (tests/test_torch_flash_backward.py's cases at D >= 16).
JAX_CASES = [
    (2, 4, 2, 33, 33, 16, True, None),
    (1, 8, 2, 40, 40, 32, True, 7),
    (1, 8, 1, 24, 24, 64, False, None),
    (1, 4, 4, 20, 37, 16, False, None),
    (1, 4, 1, 37, 20, 32, True, None),
    (2, 4, 2, 30, 30, 128, False, 12),
    (1, 16, 8, 48, 48, 128, True, None),
    (1, 4, 4, 40, 40, 96, True, None),
    (1, 4, 2, 33, 70, 96, False, 9),
]
JAX_IDS = [f"B{b}H{h}G{h // hkv}Sq{sq}Sk{sk}D{d}{'c' if c else 'n'}w{w}"
           for b, h, hkv, sq, sk, d, c, w in JAX_CASES]
# Dv of each case's v and dO: MLA's 64 where D is 96.
JAX_DV = {96: 64}
F32 = dict(atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("case", JAX_CASES, ids=JAX_IDS)
def test_tc_bwd_emulation_matches_jax_grad(case):
    """In f32 (no final rounding) the split products carry P and dS to
    ~2^-17 of each term: the emulation meets the f32 tolerance the plain
    backward meets against jax.grad of the oracle."""
    b, h, hkv, sq, sk, d, causal, window = case
    dv = JAX_DV.get(d, d)
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((b, h, sq, d), (b, hkv, sk, d),
                                 (b, hkv, sk, dv), (b, h, sq, dv)))
    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda a, b_, c: ref.flash_attention_ref(
            a, b_, c, causal, window), jnp.asarray(q), jnp.asarray(k),
            jnp.asarray(v))
        want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = fa_mod.flash_attention_plain(tq, tk, tv, causal, window)
    lse = fa_mod.flash_attention_lse_plain(tq, tk, causal, window)
    got = _tc_bwd_emulation(tq, tk, tv, o, lse, tdo, causal, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, **F32, err_msg=name)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", sorted({d for d, _ in fa_mod.KERNEL_DIMS}))
def test_kernel_variant_for_backward(dname, d):
    """The backward's C launcher chooses its variant by the forward's
    rule, which kernel_variant mirrors: bf16 with D a multiple of k16 (16,
    32, 64, 96, 128) on the wgmma kernels, f32 and D in {8, 24} on the
    mma.sync kernels. The wrapper counts each, and the split pairs apart."""
    dtype = getattr(torch, dname)
    want = "tc" if dname == "bfloat16" and d % 16 == 0 else "mma"
    assert fa_mod.kernel_variant(dtype, d) == want
    fn = fa_mod.flash_attention
    assert all(isinstance(getattr(fn, f"launches_bwd{x}"), int)
               for x in ("", "_tc", "_mma", "_split"))


@pytest.mark.parametrize("b,h,sq", [(1, 1, 1), (2, 16, 1024), (4, 16, 4096),
                                    (1, 8, 129), (3, 2, 300)])
def test_bwd_scratch_covers_both_variants(b, h, sq):
    """The scratch holds the tc kernels' lse·log2e and Δ rows, padded to
    whole 128-row dQ blocks (and so to the dK/dV kernel's 64-row tiles),
    and the mma kernels' (B, H, Sq) Δ."""
    n = fa_mod.bwd_scratch_floats(b, h, sq)
    pad = -(-sq // fa_mod.BWD_ROW_PAD) * fa_mod.BWD_ROW_PAD
    assert pad % DQ_ROWS == 0 and pad % DKDV_ROWS == 0 and pad >= sq
    assert n == 2 * b * h * pad >= b * h * sq


def test_library_path_follows_the_headers(tmp_path, monkeypatch):
    """Both flash sources include csrc/tc_common.cuh: an edited header
    gives each a new library name, so a stale build is never loaded."""
    for p in build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    names = ("flash_attention", "flash_attention_bwd")
    before = [build.library_path(n).name for n in names]
    header = tmp_path / "tc_common.cuh"
    header.write_text(header.read_text() + "\n// edit\n")
    assert all(build.library_path(n).name != was
               for n, was in zip(names, before))
