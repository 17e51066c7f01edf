"""The kernels' cost functions, their wrappers' meta branches, the dry run
at full width and the roofline (``repro_torch.launch.dryrun``,
``launch.roofline``); no JAX.

- Each cost function is pinned to the figures of ``PERF.md`` §6's "Bound
  ms" column, exactly; ``visible_pairs`` to a count of the kernels'
  masks.
- On meta tensors each ``ops`` wrapper returns the kernel's output empty
  (shape, dtype, layout) and reports its cost to the installed meter;
  under grad the backward reports the backward kernel's; with no meter
  nothing is reported, and CPU tensors still take the plain versions.
- The dry run completes at full width on the combinations of
  ``tests/test_dryrun_small.py`` (granite-moe's ``prefill_32k``, which
  the JAX package's own dry run fails, included) with every output of
  the step's ops on the meta device and no kernel built: ``flops > 0``,
  and ``train_4k`` moves more than 1e6 collective bytes.
- qwen3-0.6b's ``prefill_32k`` step of one device (batch 2) counts
  exactly its projections, MLP, the flash kernel's causal pairs and the
  last position's unembedding; its ``useful_flops_ratio`` is the model
  FLOP per device over that count.
- The roofline's terms are the counts over the card's peaks; the CLIs
  write their artifacts.
"""
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import SHAPES, get_config
from repro_torch.kernels import build, meter, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rwkv6_wkv as wkv
from repro_torch.kernels import selective_scan as scan
from repro_torch.kernels.fedagg import fedagg_cost
from repro_torch.launch import dryrun, roofline

torch.set_num_threads(2)

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("what,got,exact,table", [
    ("B2 (96, 64) forward, B=4 H=40 S=4096 causal, FLOP",
     lambda: fa.flash_attention_cost((4, 40, 4096, 96), (4, 40, 4096, 96),
                                     (4, 40, 4096, 64), BF16)[0],
     429_601_587_200, "4.2960e+11"),
    ("B2' B=2 H=16 S=1024 D=128 causal, FLOP",
     lambda: fa.flash_attention_bwd_cost((2, 16, 1024, 128),
                                         (2, 8, 1024, 128),
                                         (2, 8, 1024, 128), BF16)[0],
     21_495_808_000, "2.1496e+10"),
    ("B2' (96, 64) B=2 H=40 S=1024 causal, FLOP",
     lambda: fa.flash_attention_bwd_cost((2, 40, 1024, 96),
                                         (2, 40, 1024, 96),
                                         (2, 40, 1024, 64), BF16)[0],
     34_930_688_000, "3.4931e+10"),
    ("B4' B=2 H=40 S=1024 N=64, FLOP",
     lambda: wkv.rwkv6_wkv_bwd_cost((2, 40, 1024, 64), BF16, F32)[0],
     4_781_506_560, "4.7815e+09"),
    ("B3 B=2 S=1024 D=8192 N=16, f32 abar, bf16 bx/c/y, bytes",
     lambda: scan.selective_scan_cost((2, 1024, 8192, 16), F32, BF16)[1],
     1_644_232_704, None),
    ("B1 S=4 bf16 P=596,049,920, bytes",
     lambda: fedagg_cost(4, [596_049_920], BF16)[1],
     5_960_499_216, None),
    # The rest of the table's bytes: B3' 3,254,910,976 and B4'
    # 115,363,840 at the training shapes.
    ("B3' bytes", lambda: scan.selective_scan_bwd_cost(
        (2, 1024, 8192, 16), F32, BF16)[1], 3_254_910_976, None),
    ("B4' bytes", lambda: wkv.rwkv6_wkv_bwd_cost(
        (2, 40, 1024, 64), BF16, F32)[1], 115_363_840, None),
])
def test_kernel_costs_pin_the_table(what, got, exact, table):
    value = got()
    assert value == exact, what
    if table is not None:
        assert f"{value:.4e}" == table, what


@pytest.mark.parametrize("sq,sk,causal,window", [
    (7, 7, True, None), (9, 5, True, None), (5, 9, True, None),
    (9, 9, False, None), (12, 12, True, 4), (12, 7, False, 3),
    (6, 10, True, 1), (1, 300, True, 200)])
def test_visible_pairs_count_the_masks(sq, sk, causal, window):
    ok = fa._mask(sq, sk, causal, window, torch.device("cpu"))
    assert fa.visible_pairs(sq, sk, causal, window) == int(ok.sum())


def _meta(*shape, dtype=F32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def test_meta_branches_report_each_kernel():
    with meter.metering() as m:
        q = _meta(2, 5, 4, 16, dtype=BF16).transpose(1, 2)   # (B, H, S, D)
        k = _meta(2, 5, 2, 16, dtype=BF16).transpose(1, 2)
        out = ops.flash_attention_op(q, k, k, causal=True, window=3)
        assert out.device.type == "meta" and out.shape == (2, 4, 5, 16)
        assert out.stride() == q.stride() and out.dtype == BF16
        y = ops.selective_scan_op(_meta(2, 6, 8, 4), _meta(2, 6, 8, 4),
                                  _meta(2, 6, 4))
        assert y.shape == (2, 6, 8) and y.dtype == F32
        r = _meta(1, 3, 6, 8, dtype=BF16)
        z = ops.rwkv6_wkv_op(r, r, r, _meta(1, 3, 6, 8), _meta(3, 8))
        assert z.shape == r.shape and z.dtype == BF16
        folded = ops.fedagg_tree({"a": _meta(3, 5, 2), "b": _meta(3, 7)},
                                 _meta(3))
        assert folded["a"].shape == (5, 2) and folded["b"].shape == (7,)
        assert folded["a"]._base is folded["b"]._base
    rows = m.kernels
    assert {k: v["calls"] for k, v in rows.items()} == {
        "flash_attention": 1, "selective_scan": 1, "rwkv6_wkv": 1,
        "fedagg": 1}
    assert (rows["flash_attention"]["flops"],
            rows["flash_attention"]["bytes"]) == fa.flash_attention_cost(
        (2, 4, 5, 16), (2, 2, 5, 16), (2, 2, 5, 16), BF16, True, 3)
    assert rows["flash_attention"]["flops_f32"] == 0        # tensor cores
    assert rows["selective_scan"]["flops"] == rows["selective_scan"][
        "flops_f32"] == scan.selective_scan_cost((2, 6, 8, 4), F32, F32)[0]
    assert rows["fedagg"]["bytes"] == fedagg_cost(3, [10, 7], F32)[1]


@pytest.mark.parametrize("kernel", ["flash", "scan", "wkv"])
def test_meta_backward_reports_the_backward_kernel(kernel):
    with meter.metering() as m:
        if kernel == "flash":
            q = _meta(1, 2, 8, 16, dtype=BF16, grad=True)
            out = ops.flash_attention_op(q, q, q)
            cost = fa.flash_attention_bwd_cost((1, 2, 8, 16), (1, 2, 8, 16),
                                               (1, 2, 8, 16), BF16)
            fwd = fa.flash_attention_cost((1, 2, 8, 16), (1, 2, 8, 16),
                                          (1, 2, 8, 16), BF16,
                                          with_lse=True)
            name = "flash_attention"
        elif kernel == "scan":
            a = _meta(1, 9, 4, 8, grad=True)
            out = ops.selective_scan_op(a, a, _meta(1, 9, 8, grad=True))
            cost = scan.selective_scan_bwd_cost((1, 9, 4, 8), F32, F32)
            fwd = scan.selective_scan_cost((1, 9, 4, 8), F32, F32, ckpt=True)
            name = "selective_scan"
        else:
            r = _meta(1, 2, 17, 4, grad=True)
            out = ops.rwkv6_wkv_op(r, r, r, r, _meta(2, 4, grad=True))
            cost = wkv.rwkv6_wkv_bwd_cost((1, 2, 17, 4), F32, F32)
            fwd = wkv.rwkv6_wkv_cost((1, 2, 17, 4), F32, F32, ckpt=True)
            name = "rwkv6_wkv"
        out.sum().backward()
    row, bwd = m.kernels[name], m.kernels[name + "_bwd"]
    assert (row["calls"], row["flops"], row["bytes"]) == (1, *fwd)
    assert (bwd["calls"], bwd["flops"], bwd["bytes"]) == (1, *cost)


@pytest.mark.parametrize("dtype,tf32x3", [(F32, True), (BF16, False)])
def test_flash_meters_f32_as_3xtf32(dtype, tf32x3):
    """Flash attention runs on the tensor cores in both dtypes: f32 as
    3xTF32 (the ``mma`` kernels), so its forward and backward FLOP count
    as ``flops_tf32x3``, never as work outside the tensor cores, and the
    roofline's compute term takes them at a third of TF32's rate."""
    with meter.metering() as m:
        q = _meta(1, 2, 8, 16, dtype=dtype, grad=True)
        ops.flash_attention_op(q, q, q).sum().backward()
    for name in ("flash_attention", "flash_attention_bwd"):
        row = m.kernels[name]
        assert row["flops_f32"] == 0
        assert row["flops_tf32x3"] == (row["flops"] if tf32x3 else 0)
    flops, _, f32, t3 = m.kernel_totals()
    assert f32 == 0 and t3 == (flops if tf32x3 else 0)
    rate = roofline.TF32X3_FLOP_PER_S if tf32x3 else 989e12
    assert roofline.compute_s(flops, f32, t3) == pytest.approx(flops / rate,
                                                             rel=1e-12)


def test_kernel_wrappers_refuse_meta_tensors():
    """The meta branch is ops' choice: the kernel wrappers take CUDA
    tensors only, good meta calls included."""
    from repro_torch.kernels import fedagg as fedagg_mod
    q = _meta(1, 2, 8, 16)
    r = _meta(1, 2, 6, 8)
    a = _meta(1, 6, 4, 8)
    calls = [lambda: fa.flash_attention(q, q, q),
             lambda: wkv.rwkv6_wkv(r, r, r, r, _meta(2, 8)),
             lambda: scan.selective_scan(a, a, _meta(1, 6, 8)),
             lambda: fedagg_mod.fedagg(_meta(3, 4), _meta(3))]
    with meter.metering() as m:
        for call in calls:
            with pytest.raises(ValueError, match="CUDA"):
                call()
    assert m.kernels == {}


def test_cpu_tensors_take_the_plain_versions_and_report_nothing():
    q = torch.randn(1, 2, 8, 16)
    with meter.metering() as m:
        out = ops.flash_attention_op(q, q, q)
        ops.fedagg_op(torch.randn(3, 5), [0.2, 0.3, 0.5])
    assert m.kernels == {}
    torch.testing.assert_close(out, fa.flash_attention_plain(q, q, q))
    # no meter installed: the meta branch reports to nobody
    assert meter.active() is None
    ops.flash_attention_op(*(t.to("meta") for t in (q, q, q)))


class _Devices(TorchDispatchMode):
    """Every device an op's output lands on."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.seen.update(t.device.type for t in tree_flatten(out)[0]
                         if isinstance(t, torch.Tensor))
        return out


def _no_build(*a, **k):
    raise AssertionError("the dry run built a kernel")


@pytest.mark.parametrize("arch,shape,mesh", [
    ("qwen3-0.6b", "train_4k", "single"),
    ("qwen3-0.6b", "decode_32k", "single"),
    ("rwkv6-3b", "long_500k", "single"),
    ("granite-moe-1b-a400m", "prefill_32k", "single"),
    ("whisper-small", "train_4k", "single"),
    ("qwen3-0.6b", "train_4k", "multi"),
])
def test_dryrun_at_full_width(monkeypatch, arch, shape, mesh):
    monkeypatch.setattr(build, "build", _no_build)
    monkeypatch.setattr(build, "load", _no_build)
    # The step's ops, watched inside the trace (the fake mesh's rank
    # table, a few host ints, is made before it).
    devices, real = _Devices(), dryrun.trace

    def watched(fn, *args):
        def step(*a):
            with devices:
                return fn(*a)
        return real(step, *args)

    monkeypatch.setattr(dryrun, "trace", watched)
    art = dryrun.lower_one(arch, shape, mesh == "multi")
    assert devices.seen == {"meta"}
    assert art["cost_analysis"]["flops"] > 0
    assert art["mesh"] == ("2x16x16" if mesh == "multi" else "16x16")
    assert art["model_axis"] == "sharded"
    mem = art["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    # the model axis's all-reduces, in every step
    assert art["collectives"]["all-reduce"]["count"] > 0
    if shape == "train_4k":
        assert art["collectives"]["total_bytes"] > 1e6
        assert "flash_attention_bwd" in art["kernels"]


def test_prefill_counts_exactly_at_full_width():
    """One device of 16 x 16: model = 16 does not divide the 8 KV heads,
    so attention runs whole on its gathered leaves (4 all-gathers a
    layer); the MLP runs on 1/16 of d_ff (one all-reduce a layer), the
    embedding on 1/16 of the vocab (one all-reduce), and the last
    position's logits are 1/16 of the vocab, gathered."""
    cfg = get_config("qwen3-0.6b")
    b, s = 2, SHAPES["prefill_32k"].seq_len           # 32 over data=16
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = d * h * dh + 2 * d * hkv * dh + h * dh * d
    proj = attn + 3 * d * cfg.d_ff // 16
    flash = b * h * s * (s + 1) // 2 * 4 * dh
    want = (cfg.num_layers * (2 * b * s * proj + flash)
            + 2 * b * d * cfg.vocab_size // 16)
    art = roofline.roofline_one("qwen3-0.6b", "prefill_32k")
    coll = art["per_device"]["coll_detail"]
    assert coll["all-reduce"] == {"count": 1 + cfg.num_layers,
                                  "bytes": (1 + cfg.num_layers) * 2 * b * s
                                  * d}
    assert coll["all-gather"] == {
        "count": 4 * cfg.num_layers + 1,
        "bytes": 2 * (cfg.num_layers * (2 * d * h * dh + 2 * d * hkv * dh)
                      + b * cfg.vocab_size)}
    assert art["per_device"]["flops"] == want
    assert art["per_device"]["flops_f32"] == 0
    assert art["aggregation"] is None and art["chips"] == 256
    model_flops = 2.0 * 596_049_920 * 32 * s / 256      # 2 N tokens / chips
    assert art["model_flops_per_device"] == pytest.approx(model_flops,
                                                          rel=1e-12)
    assert art["useful_flops_ratio"] == pytest.approx(model_flops / want,
                                                      rel=1e-12)
    terms = art["terms_s"]
    assert terms["compute_s"] == pytest.approx(want / 989e12, rel=1e-12)
    assert terms["memory_s"] == pytest.approx(
        art["per_device"]["bytes"] / 3.35e12, rel=1e-12)
    assert terms["collective_s"] == pytest.approx(
        art["per_device"]["coll_bytes"] / 50e9, rel=1e-12)
    assert art["dominant"] == max(terms, key=terms.get)[:-2]


def test_roofline_train_adds_the_round(tmp_path):
    roofline.main(["--arch", "rwkv6-3b", "--shape", "train_4k",
                   "--override", "num_layers=2", "--round", "fedhap_fused",
                   "--out", str(tmp_path)])
    art = json.loads((tmp_path / "rwkv6-3b_train_4k_single_fedhap_fused"
                                 ".json").read_text())
    agg, total = art["aggregation"], art["per_device"]
    assert agg["coll_bytes"] > 0
    assert set(agg["coll_detail"]) <= set(total["coll_detail"])
    # The fused round is one fedagg fold and one all-reduce of the model.
    assert total["coll_detail"]["all-reduce"]["bytes"] > 4 * 3e8 / 16
    assert art["terms_s"]["collective_s"] == pytest.approx(
        total["coll_bytes"] / 50e9)
    assert total["flops_f32"] > 0           # the WKV kernels, CUDA cores
    assert art["terms_s"]["compute_s"] == pytest.approx(
        roofline.compute_s(total["flops"], total["flops_f32"]))


def test_dryrun_cli_writes_artifacts(tmp_path):
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                 "--mesh", "both", "--out", str(tmp_path)])
    for tag, devices in (("single", 256), ("multi", 512)):
        art = json.loads((tmp_path / f"qwen3-0.6b_long_500k_{tag}.json")
                         .read_text())
        assert art["devices"] == devices and art["mode"] == "decode"
        assert art["kernels"] == {}     # decode runs no kernel
        assert art["param_count"] == 596_049_920


def test_bound_ms_reads_the_card_peaks():
    ms, by = roofline.bound_ms(989e9, 1.0, tensor_cores=True)
    assert ms == pytest.approx(1.0) and by == "operations"
    ms, by = roofline.bound_ms(0.0, 3.35e9, tensor_cores=False)
    assert ms == pytest.approx(1.0) and by == "bytes"
    assert roofline.bound_ms(67e9, 0, False)[0] == pytest.approx(1.0)
    assert roofline.bound_ms(165e9, 0, True, f32=True)[0] == pytest.approx(
        1.0)
    assert roofline.bound_ms(67e9, 0, False, f32=True)[0] == pytest.approx(
        1.0)
    assert np.isclose(roofline.compute_s(989e12 + 67e12, 67e12), 2.0)
