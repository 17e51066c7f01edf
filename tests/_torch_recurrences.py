"""Shared by the WKV and scan tests: the kernel launchers of
``repro_torch.kernels.rwkv6_wkv`` and ``repro_torch.kernels.selective_scan``
replaced by their plain versions, so that ``RwkvWkvFn`` and
``SelectiveScanFn`` can be checked on the CPU (the kernels run only on
the card)."""
from repro_torch.kernels import rwkv6_wkv as wkv_mod
from repro_torch.kernels import selective_scan as scan_mod


def wkv_plain_launchers(monkeypatch) -> list:
    """Replace ``rwkv6_wkv_fwd``, ``rwkv6_wkv_fwd_ckpt`` and
    ``rwkv6_wkv_bwd`` by plain versions with their signatures (each checks
    its inputs as the launcher does; the backward takes the checkpoints
    or, given none, makes them as the launcher does); returns the list of
    calls, recorded as "fwd", "fwd_ckpt" and "bwd". ``calls.ckpts`` holds
    the (ckpt, c) pairs the checkpointing forward returned and
    ``calls.bwd_ckpts`` those the backward received, in order."""
    calls = _Calls()

    def fwd(r, k, v, w, u):
        calls.append("fwd")
        wkv_mod.check_inputs(r, k, v, w, u)
        return wkv_mod.rwkv6_wkv_plain(r, k, v, w, u)

    def fwd_ckpt(r, k, v, w, u):
        calls.append("fwd_ckpt")
        wkv_mod.check_inputs(r, k, v, w, u)
        y, ckpt, c = wkv_mod.rwkv6_wkv_ckpt_plain(r, k, v, w, u)
        calls.ckpts.append((ckpt, c))
        return y, ckpt, c

    def bwd(r, k, v, w, u, dy, ckpt=None, c=None):
        calls.append("bwd")
        wkv_mod.check_bwd_inputs(r, k, v, w, u, dy)
        if ckpt is None:
            _, ckpt, c = wkv_mod.rwkv6_wkv_ckpt_plain(r, k, v, w, u)
        calls.bwd_ckpts.append((ckpt, c))
        return wkv_mod.rwkv6_wkv_bwd_ckpt_plain(r, k, v, w, u, dy, ckpt, c)

    monkeypatch.setattr(wkv_mod, "rwkv6_wkv_fwd", fwd)
    monkeypatch.setattr(wkv_mod, "rwkv6_wkv_fwd_ckpt", fwd_ckpt)
    monkeypatch.setattr(wkv_mod, "rwkv6_wkv_bwd", bwd)
    return calls


class _Calls(list):
    """A list of call names with the checkpoints seen beside it."""

    def __init__(self):
        super().__init__()
        self.ckpts, self.bwd_ckpts = [], []


def scan_plain_launchers(monkeypatch) -> list:
    """Replace ``selective_scan_fwd``, ``selective_scan_fwd_ckpt`` and
    ``selective_scan_bwd`` by plain versions with their signatures (each
    checks its inputs as the launcher does; the backward takes the
    checkpoints or, given none, makes them as the launcher does); returns
    the list of calls, recorded as "fwd", "fwd_ckpt" and "bwd".
    ``calls.ckpts`` holds the checkpoints the checkpointing forward
    returned and ``calls.bwd_ckpts`` those the backward received, in
    order."""
    calls = _Calls()

    def fwd(abar, bx, c):
        calls.append("fwd")
        scan_mod.check_inputs(abar, bx, c)
        return scan_mod.selective_scan_plain(abar, bx, c)

    def fwd_ckpt(abar, bx, c):
        calls.append("fwd_ckpt")
        scan_mod.check_inputs(abar, bx, c)
        y, ckpt = scan_mod.selective_scan_ckpt_plain(abar, bx, c)
        calls.ckpts.append(ckpt)
        return y, ckpt

    def bwd(abar, bx, c, dy, ckpt=None):
        calls.append("bwd")
        scan_mod.check_bwd_inputs(abar, bx, c, dy)
        if ckpt is None:
            ckpt = scan_mod.selective_scan_ckpt_plain(abar, bx, c)[1]
        calls.bwd_ckpts.append(ckpt)
        return scan_mod.selective_scan_bwd_ckpt_plain(abar, bx, c, dy, ckpt)

    monkeypatch.setattr(scan_mod, "selective_scan_fwd", fwd)
    monkeypatch.setattr(scan_mod, "selective_scan_fwd_ckpt", fwd_ckpt)
    monkeypatch.setattr(scan_mod, "selective_scan_bwd", bwd)
    return calls
