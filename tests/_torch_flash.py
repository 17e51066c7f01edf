"""Shared by the flash tests: the kernel launchers of
``repro_torch.kernels.flash_attention`` replaced by their plain versions,
so that ``FlashAttentionFn``'s wiring can be checked on the CPU (the
kernels run only on the card); chip_smoke.py loaded as a module, for its
tolerances, sweeps and planted faults; and the tensor-core flash kernel's
arithmetic emulated on the CPU. No JAX here."""
import functools
import importlib.util
import math
import pathlib

import torch

from repro_torch.kernels import flash_attention as fa_mod


def plain_launchers(monkeypatch) -> list:
    """Replace ``flash_attention_fwd`` and ``flash_attention_bwd`` by
    plain versions with their signatures (the backward checks its inputs
    as the kernel's wrapper does); returns the list of calls, recorded as
    ``("fwd", with_lse)`` and ``("bwd", causal, window)``."""
    calls = []

    def fwd(q, k, v, causal=True, window=None, with_lse=False):
        calls.append(("fwd", with_lse))
        out = fa_mod.flash_attention_plain(q, k, v, causal, window)
        lse = (fa_mod.flash_attention_lse_plain(q, k, causal, window)
               if with_lse else None)
        return out, lse

    def bwd(q, k, v, o, lse, do, causal=True, window=None):
        calls.append(("bwd", causal, window))
        fa_mod.check_bwd_inputs(q, k, v, o, lse, do, window)
        return fa_mod.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                                window)

    monkeypatch.setattr(fa_mod, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fa_mod, "flash_attention_bwd", bwd)
    return calls


@functools.cache
def chip_smoke():
    """chip_smoke.py at the repository's root, loaded as a module (its
    ``main`` is not run)."""
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The tensor-core kernel's tiling (csrc/flash_attention.cu, namespace tc):
# 128-key tiles, blocks of 128 query rows in two consumer groups of 64.
TC_BLOCK_K, TC_GROUP_Q, TC_BLOCK_Q = 128, 64, 128


def tc_emulation(q, k, v, causal=True, window=None, split_masked=True):
    """The tensor-core kernel's arithmetic in PyTorch on the CPU: f32
    scores of bf16 inputs, an online softmax over 128-key tiles (m from
    -1e30, masked scores -1e30), l summed from the f32 probabilities, P
    rounded to bf16 before P·V with f32 sums, and one rounding of the
    output. With ``split_masked`` the remainder P - bf16(P) is added as a
    second bf16 product on the tiles that cross a mask edge for a group
    of 64 query rows, as the kernel does. v may be narrower than q and k
    (MLA's (96, 64)); the scale is 1/sqrt(D) of q and k."""
    b, h, sq, d = q.shape
    group = h // k.shape[1]
    kq = k.repeat_interleave(group, 1).float()
    vq = v.repeat_interleave(group, 1).float()
    qf = q.float()
    sk = k.shape[2]
    m = torch.full((b, h, sq, 1), fa_mod.NEG_INF)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, v.shape[-1])
    groups = -(-sq // TC_GROUP_Q)
    qpos = torch.arange(groups * TC_GROUP_Q)[:, None]   # rows of whole groups
    for k0 in range(0, sk, TC_BLOCK_K):
        kpos = torch.arange(k0, k0 + TC_BLOCK_K)[None, :]
        ok = (kpos < sk).expand(len(qpos), TC_BLOCK_K)
        if causal:
            ok = ok & (qpos >= kpos)
        if window is not None:
            ok = ok & (qpos - kpos < window)
        # A group of 64 rows is on a mask edge where any of its (row, key)
        # pairs is masked, as the kernel decides per consumer group.
        edge = ~ok.reshape(groups, TC_GROUP_Q * TC_BLOCK_K).all(1)
        edge = edge.repeat_interleave(TC_GROUP_Q)[:sq, None]
        ok = ok[:sq]
        kt = kq[:, :, k0:k0 + TC_BLOCK_K]
        vt = vq[:, :, k0:k0 + TC_BLOCK_K]
        pad = TC_BLOCK_K - kt.shape[2]
        kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
        vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt) * (1.0 / math.sqrt(d))
        s = torch.where(ok, s, torch.full_like(s, fa_mod.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        p_hi = p.to(torch.bfloat16).float()
        if split_masked:
            p_lo = (p - p_hi).to(torch.bfloat16).float()
            p_hi = torch.where(edge, p_hi + p_lo, p_hi)
        acc = alpha * acc + torch.einsum("bhqk,bhkd->bhqd", p_hi, vt)
        m = m_new
    return (acc / l.clamp(min=1e-30)).to(q.dtype)


# The mma kernels' arithmetic (csrc/mma_common.cuh): f32 as 3xTF32, bf16
# with the head dims zero-padded to k16 and P, dS as two bf16 parts.
MMA_K = {torch.float32: 8, torch.bfloat16: 16}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x truncated to TF32 (10 explicit mantissa bits): its low 13 bits
    cleared, as the kernels form hi and as the tensor core reads a TF32
    operand."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor, dtype: torch.dtype):
    """x as the kernels' two parts, each returned as f32: for f32 hi =
    tf32(x) and lo = x - hi (exact) as the tensor core reads it, tf32(x -
    hi); for bf16 hi = bf16(x), lo = bf16(x - hi)."""
    rnd = tf32 if dtype == torch.float32 else (
        lambda y: y.to(torch.bfloat16).float())
    hi = rnd(x.float())
    return hi, rnd(x.float() - hi)


def mma_product(eq: str, a: torch.Tensor, b: torch.Tensor,
                dtype: torch.dtype, a_split: bool) -> torch.Tensor:
    """One contraction as the mma kernels issue it, f32 sums: f32 inputs
    as (lo·hi + hi·lo) + hi·hi of their TF32 parts (the two correction
    products summed apart, as the kernels do for S and dP; lo·lo
    dropped); bf16
    inputs exact, with an A computed in f32 (``a_split``: P, dS) as its
    bf16 hi and lo parts, each times B."""
    if dtype == torch.float32:
        (ah, al), (bh, bl) = split(a, dtype), split(b, dtype)
        return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
                + torch.einsum(eq, ah, bh))
    if a_split:
        ah, al = split(a, dtype)
        return torch.einsum(eq, al, b.float()) + torch.einsum(eq, ah,
                                                             b.float())
    return torch.einsum(eq, a.float(), b.float())


def _rz(x: torch.Tensor) -> torch.Tensor:
    """f64 x to f32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def mma_add(c: torch.Tensor, prods: torch.Tensor) -> torch.Tensor:
    """One mma's ``c + Σ_k prods[..., k]`` as a model of the tensor core's
    adder (the products exact, in f64): every addend, c included, aligned
    to the largest one's exponent and truncated to f32's 24 bits there,
    the exact sum of what is left rounded toward zero to f32. Each add
    then loses up to an ulp of the largest addend per addend, always
    toward zero: a bias that grows with the number of adds into one
    accumulator."""
    terms = torch.cat([c.double().unsqueeze(-1), prods], -1)
    _, e = torch.frexp(terms.abs().amax(-1, keepdim=True))
    quantum = torch.pow(2.0, (e - 24).double())
    return _rz((torch.trunc(terms / quantum) * quantum).sum(-1))


#: Rows (or keys) of one streamed tile of the mma kernels' walks, the most
#: that ``mma::accumulate`` sums in fresh registers before an f32 add.
MMA_CHUNK = 64


def mma_walk(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype,
             chunk: int | None = MMA_CHUNK) -> torch.Tensor:
    """``a @ b`` (a (..., M, K) computed in f32, b (..., K, N) in
    ``dtype``), summed over K as ``mma::accumulate`` sums a walk: the
    mma steps of k (8 for f32, 16 for bf16) one after another, each
    product an :func:`mma_add` (f32: lo·hi, hi·lo, hi·hi of the TF32
    parts, three mma's; bf16: a's bf16 lo and hi parts times b, two), in
    a fresh accumulator for each ``chunk`` of k indices that then joins
    the running sum by an f32 add, rounded to nearest. ``chunk=None``
    accumulates the whole walk in the mma's own accumulator, the form
    the kernels do not use."""
    kk = MMA_K[dtype]
    pad = -a.shape[-1] % kk
    a = torch.nn.functional.pad(a.float(), (0, pad))
    b = torch.nn.functional.pad(b.float(), (0, 0, 0, pad))
    (ah, al) = split(a, dtype)
    if dtype == torch.float32:
        bh, bl = split(b, dtype)
        pairs = ((al, bh), (ah, bl), (ah, bh))
    else:
        pairs = ((al, b), (ah, b))
    n_k = a.shape[-1]
    chunk = chunk or n_k
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for c0 in range(0, n_k, chunk):
        tmp = torch.zeros_like(acc)
        for k0 in range(c0, min(c0 + chunk, n_k), kk):
            for x, y in pairs:
                tmp = mma_add(tmp, x[..., :, None, k0:k0 + kk].double()
                              * y[..., None, k0:k0 + kk, :]
                              .transpose(-1, -2).double())
        acc = acc + tmp
    return acc


def _tiles(x: torch.Tensor, axis: int) -> torch.Tensor:
    """x zero-padded along ``axis`` to whole :data:`MMA_CHUNK` tiles, so
    that a walk's chunks start where the kernels' tiles do."""
    pad = [0, 0] * (x.dim() - 1 - axis % x.dim()) + [0, -x.shape[axis]
                                                     % MMA_CHUNK]
    return torch.nn.functional.pad(x, pad)


def _pad_k(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x's last dim zero-padded to a whole k step (bf16 D in {8, 24} to 16
    and 32), as the kernels pad their shared-memory tiles."""
    pad = -x.shape[-1] % MMA_K[dtype]
    return torch.nn.functional.pad(x.float(), (0, pad))


def _visible(sq, sk, causal, window):
    qp, kp = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    ok = kp < sk
    if causal:
        ok = ok & (qp >= kp)
    if window is not None:
        ok = ok & (qp - kp < window)
    return ok


def mma_emulation(q, k, v, causal=True, window=None, one_product=False):
    """The mma forward's arithmetic on the CPU -> (out in q's dtype, lse
    f32): S = Q·Kᵀ by :func:`mma_product` over the zero-padded depth, the
    -1e30 mask, P = exp(S - m) and l in f32, O = P·V with P split, divided
    by max(l, 1e-30); lse = m + log(max(l, 1e-30)). ``one_product`` takes
    f32 as one TF32 product (hi·hi), the rounding 3xTF32 removes."""
    dt = q.dtype
    group = q.shape[1] // k.shape[1]
    kq = k.repeat_interleave(group, 1)
    vq = v.repeat_interleave(group, 1)
    if one_product:
        s = torch.einsum("bhqd,bhkd->bhqk", tf32(q), tf32(kq))
    else:
        s = mma_product("bhqd,bhkd->bhqk", _pad_k(q, dt), _pad_k(kq, dt),
                        dt, False)
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    s = torch.where(_visible(q.shape[2], k.shape[2], causal, window), s,
                    torch.full_like(s, fa_mod.NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True).clamp(min=1e-30)
    if one_product:
        o = torch.einsum("bhqk,bhkd->bhqd", tf32(p), tf32(vq))
    else:
        o = mma_product("bhqk,bhkd->bhqd", p, vq, dt, True)
    return (o / denom).to(dt), (m + torch.log(denom))[..., 0]


def mma_bwd_emulation(q, k, v, o, lse, do, causal=True, window=None,
                      chunk=MMA_CHUNK):
    """The mma backward's arithmetic on the CPU -> (dq, dk, dv) in the
    inputs' dtype: S = Q·Kᵀ and dP = dO·Vᵀ by :func:`mma_product` over the
    zero-padded depths (the dK/dV kernel's Sᵀ = K·Qᵀ takes the same three
    terms), P = exp(S·scale − lse) (0 where masked), Δ = rowsum(dO ⊙ O),
    dS = P ⊙ (dP − Δ), then dV = Pᵀ·dO, dK = scale·dSᵀ·Q, dQ = scale·dS·K
    with P and dS split, each a walk (:func:`mma_walk`, in ``chunk``s):
    dK and dV over each KV head's query heads one after another, each
    head's rows in tiles, and dQ over the keys."""
    dt = q.dtype
    b, h, sq, d = q.shape
    hkv, sk, d_v = k.shape[1], k.shape[2], v.shape[3]
    group = h // hkv
    scale = 1.0 / math.sqrt(d)
    kq = k.repeat_interleave(group, 1)
    vq = v.repeat_interleave(group, 1)
    s = mma_product("bhqd,bhkd->bhqk", _pad_k(q, dt), _pad_k(kq, dt), dt,
                    False)
    dp = mma_product("bhqd,bhkd->bhqk", _pad_k(do, dt), _pad_k(vq, dt), dt,
                     False)
    ok = _visible(sq, sk, causal, window)
    p = torch.where(ok, torch.exp(s * scale - lse.float()[..., None]),
                    torch.zeros_like(s))
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)

    def by_kv_head(x):      # (b, h, rows, n) -> (b, hkv, group * rows, n)
        x = _tiles(x, 2)
        return x.reshape(b, hkv, group * x.shape[2], x.shape[3])

    pt = by_kv_head(p).transpose(2, 3)
    dst = by_kv_head(ds).transpose(2, 3)
    dv = mma_walk(pt, by_kv_head(do), dt, chunk)
    dk = mma_walk(dst, by_kv_head(q), dt, chunk) * scale
    dq = mma_walk(_tiles(ds, 3), _tiles(kq, 2), dt, chunk) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)
