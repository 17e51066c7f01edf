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
