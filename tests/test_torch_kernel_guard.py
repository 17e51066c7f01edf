"""The kernel wrappers never drop a gradient.

``fedagg`` is forward only, so its wrappers raise ``RuntimeError`` when
grad is enabled and an input requires grad, before they look at the
device; without grad they go on to their device check.
``flash_attention``, ``rwkv6_wkv`` and ``selective_scan`` have backward
kernels: under grad their wrappers build an autograd node instead
(``FlashAttentionFn``, ``RwkvWkvFn``, ``SelectiveScanFn``; checked here
with their launchers replaced by the plain versions, since the kernels
run only on the card). The ``*_op`` dispatchers send CPU tensors to the
plain versions, which stay differentiable. The ``cuda``-marked test
shows the raise, and each backward kernel's gradient against the plain
one, on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (fedagg as fedagg_mod,
                                 flash_attention as fa_mod, ops,
                                 rwkv6_wkv as wkv_mod,
                                 selective_scan as scan_mod)
from repro_torch.kernels.guard import autograd_guard

from _torch_flash import plain_launchers
from _torch_recurrences import scan_plain_launchers, wkv_plain_launchers

torch.set_num_threads(2)


def _inputs(kernel: str, device: str = "cpu", seed: int = 0) -> list:
    """Small valid f32 inputs of each kernel, made with numpy."""
    rng = np.random.default_rng(seed)

    def t(*shape, lo=None):
        a = (rng.uniform(lo, 0.99, shape) if lo is not None
             else rng.standard_normal(shape))
        return torch.from_numpy(a.astype(np.float32)).to(device)
    if kernel in ("fedagg", "fedagg_leaves"):
        return [t(3, 10), torch.from_numpy(
            rng.random(3).astype(np.float32)).to(device)]
    if kernel == "flash_attention":
        return [t(1, 2, 8, 16), t(1, 1, 8, 16), t(1, 1, 8, 16)]
    if kernel == "rwkv6_wkv":
        return [t(1, 2, 6, 8), t(1, 2, 6, 8), t(1, 2, 6, 8),
                t(1, 2, 6, 8, lo=0.5), t(2, 8)]
    if kernel == "selective_scan":
        return [t(1, 6, 4, 4, lo=0.5), t(1, 6, 4, 4), t(1, 6, 4)]
    raise KeyError(kernel)


WRAPPERS = {
    "fedagg": lambda x, w: fedagg_mod.fedagg(x, w),
    "fedagg_leaves": lambda x, w: fedagg_mod.fedagg_leaves([x, x], w)[0],
    "flash_attention": fa_mod.flash_attention,
    "rwkv6_wkv": wkv_mod.rwkv6_wkv,
    "selective_scan": scan_mod.selective_scan,
}
OPS = {
    "fedagg": ops.fedagg_op,
    "fedagg_leaves": lambda x, w: ops.fedagg_tree({"a": x, "b": x}, w)["a"],
    "flash_attention": ops.flash_attention_op,
    "rwkv6_wkv": ops.rwkv6_wkv_op,
    "selective_scan": ops.selective_scan_op,
}
NAMES = {"fedagg_leaves": "fedagg"}
# Wrappers with a backward kernel: under grad they build an autograd node
# (named here), whose gradient must equal the plain version's autograd.
DIFFERENTIABLE = {
    "flash_attention": ("FlashAttentionFn", fa_mod.flash_attention_plain),
    "rwkv6_wkv": ("RwkvWkvFn", wkv_mod.rwkv6_wkv_plain),
    "selective_scan": ("SelectiveScanFn", scan_mod.selective_scan_plain),
}
# The calls each differentiable wrapper's patched launchers record for one
# forward and one backward.
PLAIN_CALLS = {"flash_attention": (plain_launchers,
                                   [("fwd", True), ("bwd", True, None)]),
               "rwkv6_wkv": (wkv_plain_launchers, ["fwd_ckpt", "bwd"]),
               "selective_scan": (scan_plain_launchers, ["fwd_ckpt", "bwd"])}


def _requiring_grad(args: list, which: int) -> list:
    return [a.clone().requires_grad_() if i == which else a
            for i, a in enumerate(args)]


def _check_gradient(kernel: str, args: list, which: int, tol: dict) -> None:
    """The wrapper under grad with input ``which`` requiring grad: an
    autograd node whose gradient equals the plain version's."""
    node, plain_fn = DIFFERENTIABLE[kernel]
    inputs = _requiring_grad(args, which)
    out = WRAPPERS[kernel](*inputs)
    assert node in type(out.grad_fn).__name__
    weight = torch.linspace(-1, 1, out.numel(), device=out.device).view(
        out.shape)
    (got,) = torch.autograd.grad((out * weight).sum(), [inputs[which]])
    plain = _requiring_grad(args, which)
    (want,) = torch.autograd.grad((plain_fn(*plain) * weight).sum(),
                                  [plain[which]])
    assert got.shape == inputs[which].shape
    assert torch.isfinite(got).all() and got.abs().sum() > 0
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_wrapper_raises_on_input_that_requires_grad(kernel, monkeypatch):
    args = _inputs(kernel)
    if kernel in DIFFERENTIABLE:
        patch, per_call = PLAIN_CALLS[kernel]
        calls = patch(monkeypatch)
        for which in range(len(args)):
            _check_gradient(kernel, args, which, dict(atol=1e-6, rtol=1e-6))
        assert calls == per_call * len(args)
        return
    for which in range(len(args)):
        launches = getattr(WRAPPERS[kernel], "launches", None)
        with pytest.raises(RuntimeError, match="no backward") as info:
            WRAPPERS[kernel](*_requiring_grad(args, which))
        assert NAMES.get(kernel, kernel) in str(info.value)
        assert getattr(WRAPPERS[kernel], "launches", None) == launches


@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_wrapper_without_grad_reaches_its_device_check(kernel):
    args = _requiring_grad(_inputs(kernel), 0)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            WRAPPERS[kernel](*args)


@pytest.mark.parametrize("kernel", list(OPS))
def test_op_on_cpu_keeps_its_gradient_path(kernel):
    """The plain versions differentiate: every input that requires grad
    gets a finite gradient, the same as that of the plain version."""
    args = [a.clone().requires_grad_() for a in _inputs(kernel, seed=1)]
    out = OPS[kernel](*args)
    assert out.requires_grad
    (out * torch.linspace(-1, 1, out.numel()).view(out.shape)).sum() \
        .backward()
    for a in args:
        assert a.grad is not None and torch.isfinite(a.grad).all()
        assert a.grad.abs().sum() > 0


def test_guard_reads_grad_mode_and_requires_grad():
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3)
    autograd_guard("k", y, y)                 # nothing requires grad
    with torch.no_grad():
        autograd_guard("k", x, y)             # grad disabled
    with torch.inference_mode():
        autograd_guard("k", y)
    with pytest.raises(RuntimeError, match="^k: .*has no backward"):
        autograd_guard("k", y, x)


def test_model_paths_reach_the_kernels_without_grad():
    """The fold's inputs come out of the trainer's no-grad update, so a
    CUDA round never trips the guard: they do not require grad."""
    from repro_torch.models.cnn import CNN
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.sim.trainer import LocalTrainer
    trainer = LocalTrainer(CNN(CONFIG), 0.05, 4, "cpu")
    base = trainer.init(0)
    stacked = {k: v[None].expand(2, *v.shape) for k, v in base.items()}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((2, 1, 4, 28, 28)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (2, 1, 4)))
    params, _ = trainer.multi_step(stacked, x, y)
    assert not any(p.requires_grad for p in params.values())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_wrapper_raises_on_card(kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++ and "
                    "have no CPU or interpreter mode")
    args = _inputs(kernel, "cuda")
    if kernel in DIFFERENTIABLE:
        torch.backends.cuda.matmul.allow_tf32 = False
        fn = WRAPPERS[kernel]
        n = (fn.launches, fn.launches_bwd)
        for which in range(len(args)):
            _check_gradient(kernel, args, which, dict(atol=3e-5, rtol=1e-4))
        assert (fn.launches, fn.launches_bwd) == (n[0] + len(args),
                                                  n[1] + len(args))
        return
    launches = WRAPPERS[kernel].launches if hasattr(
        WRAPPERS[kernel], "launches") else None
    with pytest.raises(RuntimeError, match="no backward"):
        WRAPPERS[kernel](*_requiring_grad(args, 0))
    with torch.no_grad():
        out = WRAPPERS[kernel](*_requiring_grad(args, 0))
    torch.cuda.synchronize()
    assert out.is_cuda and torch.isfinite(out).all()
    if launches is not None:
        assert WRAPPERS[kernel].launches == launches + 1
