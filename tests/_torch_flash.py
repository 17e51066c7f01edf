"""Shared by the flash tests: the kernel launchers of
``repro_torch.kernels.flash_attention`` replaced by their plain versions,
so that ``FlashAttentionFn``'s wiring can be checked on the CPU (the
kernels run only on the card)."""
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
