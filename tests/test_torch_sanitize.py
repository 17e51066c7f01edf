"""The port's runtime sanitizer (``repro_torch.debug.sanitize``), the
counterpart of tests/test_sanitize.py: the fused block loop of every
strategy runs clean under the transfer guard, strict dtype promotion and
rank_promotion="raise", and the sanitized history equals an unsanitized
run's exactly. On the CPU the dispatch guard stands in for the card's
sync-debug mode; the card's checks are in tests/test_torch_resume_cuda.py
and chip_smoke.py's phase 26."""
import numpy as np
import pytest
import torch

from repro_torch.debug import (DtypePromotionError, ImplicitTransferError,
                               RankPromotionError, RetraceDetector,
                               RetraceError, compile_counts, sanitized,
                               sanitized_run, to_device, to_host)
from repro_torch.sim import FusedExecutor, RoundEngine, SimConfig

torch.set_num_threads(2)

QUICK = dict(model_kind="mlp", num_samples=1500, eval_samples=300,
             local_steps=2, horizon_h=36.0, time_step_s=120.0,
             max_rounds=4, device="cpu")

# tests/test_sanitize.py's scenario table: all 8 strategies.
SCENARIOS = [
    ("fedhap", "one_hap"),
    ("fedisl", "gs"),
    ("fedisl_ideal", "meo"),
    ("fedsat", "gs_np"),
    ("fedspace", "gs"),
    ("fedsink", "haps:2"),
    ("fedhap_async", "haps:2"),
    ("fedhap_buffered", "haps:2"),
]


class TestSanitizedStrategies:
    @pytest.mark.parametrize("strategy,stations", SCENARIOS)
    def test_fused_run_is_guard_clean(self, strategy, stations):
        """Every strategy's block loop: no implicit transfers, no implicit
        promotions — and the sanitized history matches an unsanitized run
        exactly (the guards observe, never perturb)."""
        cfg = dict(strategy=strategy, stations=stations, **QUICK)
        res, counts = sanitized_run(cfg)
        assert res.rounds >= 1
        assert counts == {}, "the eager executor caches no program"
        plain = RoundEngine(SimConfig(**cfg)).run(fused=True)
        assert plain.history == res.history
        assert plain.sim_hours == res.sim_hours

    @pytest.mark.parametrize("strategy,stations",
                             [("fedhap", "one_hap"),
                              ("fedhap_async", "haps:2")])
    def test_multi_block_run_is_guard_clean(self, strategy, stations):
        """12 rounds (or events) at plan_block=4: several blocks through
        run_block / cycle_block under the guard, equal to a plain run."""
        cfg = dict(strategy=strategy, stations=stations,
                   **dict(QUICK, max_rounds=12, plan_block=4))
        res, counts = sanitized_run(cfg)
        assert res.history and res.history[-1][1] > 4
        plain = RoundEngine(SimConfig(**cfg)).run(fused=True)
        assert plain.history == res.history


class TestPlantedFaults:
    """Faults planted inside the fused loop raise through sanitized_run."""

    CFG = dict(strategy="fedhap", stations="one_hap", **QUICK)

    def test_device_scalar_read_in_a_block(self, monkeypatch):
        real = FusedExecutor._device_acc

        def reads(self, params):
            acc = real(self, params)
            float(acc)
            return acc
        monkeypatch.setattr(FusedExecutor, "_device_acc", reads)
        with pytest.raises(ImplicitTransferError, match="transfer"):
            sanitized_run(self.CFG)

    def test_float64_upload_in_a_block(self, monkeypatch):
        real = FusedExecutor._h2d

        def widens(self, x, dtype):
            return real(self, x, np.float64 if dtype == np.float32
                        else dtype)
        monkeypatch.setattr(FusedExecutor, "_h2d", widens)
        with pytest.raises(DtypePromotionError, match="float64"):
            sanitized_run(self.CFG)

    def test_plain_run_does_not_check(self, monkeypatch):
        """The same fault outside the guard goes unseen: the guard, not
        the loop, raises."""
        real = FusedExecutor._device_acc

        def reads(self, params):
            acc = real(self, params)
            float(acc)
            return acc
        monkeypatch.setattr(FusedExecutor, "_device_acc", reads)
        RoundEngine(SimConfig(**self.CFG)).run(fused=True)


class TestRetraceBudget:
    def test_executor_caches_no_program(self):
        eng = RoundEngine(SimConfig(strategy="fedhap", stations="one_hap",
                                    **QUICK))
        det = RetraceDetector(eng.executor, budget=1)
        eng.run(fused=True)
        assert det.check() == {} == compile_counts(eng.executor)

    def test_detector_flags_synthetic_retrace(self):
        """A fake executor whose 'program' reports 3 traces must trip the
        budget with the offending key in the message."""
        class FakeFn:
            def _cache_size(self):
                return 3

        class FakeExec:
            _jit = {}

        ex = FakeExec()
        det = RetraceDetector(ex, budget=1)   # baseline: empty cache
        ex._jit[("round", 8, 40, 2)] = FakeFn()
        with pytest.raises(RetraceError, match="round"):
            det.check()

    def test_compile_counts_reads_the_cache(self):
        class Fn:
            def __init__(self):
                self.n = 0

            def _cache_size(self):
                return self.n

        fn = Fn()
        ex = type("E", (), {"_jit": {("k",): fn}})()
        det = RetraceDetector(ex, budget=1)
        assert compile_counts(ex) == {("k",): 0}
        fn.n = 1
        assert det.check() == {("k",): 1}
        ex._jit[("u",)] = object()     # no _cache_size: unavailable
        with pytest.raises(RetraceError, match="unavailable"):
            det.check()


class TestSanitizedContext:
    @pytest.mark.parametrize("read", [
        lambda t: float(t.sum()),
        lambda t: t.sum().item(),
        lambda t: bool(t.sum()),
        lambda t: t[t > 0],
        lambda t: torch.nonzero(t),
    ], ids=["float", "item", "bool", "mask_index", "nonzero"])
    def test_blocks_implicit_scalar_transfer(self, read):
        t = torch.ones(3)
        with pytest.raises(ImplicitTransferError, match="[Tt]ransfer"):
            with sanitized():
                read(t)

    def test_blocks_rank_promotion(self):
        a, b = torch.ones((4, 3)), torch.ones((3,))
        with pytest.raises(RankPromotionError, match="rank_promotion"):
            with sanitized(transfer=None):
                _ = a + b

    def test_rank0_and_equal_ranks_pass(self):
        a = torch.ones((4, 3))
        with sanitized():
            out = a + torch.ones(()) + torch.ones((1, 3)) + 2.0
        assert out.shape == (4, 3)

    def test_blocks_implicit_dtype_promotion(self):
        a = torch.ones((3,), dtype=torch.float32)
        b = torch.ones((3,), dtype=torch.float16)
        with pytest.raises(DtypePromotionError, match="promotion"):
            with sanitized(transfer=None):
                _ = a + b

    def test_blocks_float64_results(self):
        a = torch.ones(3)
        with pytest.raises(DtypePromotionError, match="float64"):
            with sanitized():
                a.double()
        with pytest.raises(DtypePromotionError, match="float64"):
            with sanitized():
                to_device(np.ones(3), "cpu")

    def test_where_mask_and_weak_scalars_pass(self):
        a = torch.arange(4, dtype=torch.float32)
        with sanitized():
            out = torch.where(a > 1, a, 0.5) * 2 + 1.0
        assert out.dtype == torch.float32

    def test_guard_sees_the_backward(self):
        """Ops that run only in autograd's backward go through the guard
        too: a clean forward whose backward widens to float64 raises."""
        class Widening(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x * 2

            @staticmethod
            def backward(ctx, g):
                return (g.double() * 2).float()

        w = torch.ones(3, requires_grad=True)
        with pytest.raises(DtypePromotionError, match="float64"):
            with sanitized():
                Widening.apply(w).sum().backward()

    def test_explicit_paths_stay_allowed(self):
        """The blessed idioms of the executor hot path pass: numpy cast
        then dtype-preserving upload, device math, explicit download."""
        with sanitized():
            x = to_device(np.asarray([1, 2], np.int32), "cpu")
            out = to_host(x * 2)
        assert out.tolist() == [2, 4]

    def test_none_leaves_a_knob_off(self):
        t = torch.ones(3)
        with sanitized(transfer=None, dtype_promotion=None,
                       rank_promotion=None):
            assert float(t.sum()) == 3.0
            _ = t.double() + torch.ones((2, 3))

    def test_unknown_knob_value_raises(self):
        with pytest.raises(ValueError, match="transfer"):
            with sanitized(transfer="log"):
                pass

    def test_cuda_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            with sanitized(device="cuda"):
                pass

    def test_cuda_without_sync_debug_mode_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.delattr(torch.cuda, "set_sync_debug_mode")
        with pytest.raises(RuntimeError, match="set_sync_debug_mode"):
            with sanitized(device="cuda"):
                pass

    def test_guard_is_gone_after_the_block(self):
        t = torch.ones(3)
        with sanitized():
            pass
        assert float(t.sum()) == 3.0


class TestFusedHook:
    def _engine(self, **over):
        return RoundEngine(SimConfig(strategy="fedhap", stations="one_hap",
                                     **dict(QUICK, **over)))

    def test_wraps_only_the_fused_loop(self, monkeypatch):
        """The hook is entered once per fused run, around run_fused only:
        the executor is built and the params drawn before it."""
        from repro_torch.sim.strategies import FedHap
        eng = self._engine()
        events = []

        class Cm:
            def __enter__(self):
                events.append("enter")

            def __exit__(self, *exc):
                events.append("exit")

        real_init = eng.trainer.init
        monkeypatch.setattr(eng.trainer, "init",
                            lambda seed: events.append("init")
                            or real_init(seed))
        real_run = FedHap.run_fused
        monkeypatch.setattr(FedHap, "run_fused",
                            lambda self, e, s: events.append("run_fused")
                            or real_run(self, e, s))
        eng._fused_cm = Cm
        eng.run(fused=True)
        assert events == ["init", "enter", "run_fused", "exit"]
        events.clear()
        eng.run(fused=False)                 # the per-round path: bare
        assert events == ["init"]

    def test_default_is_no_hook(self):
        eng = self._engine()
        assert eng._fused_cm is None
