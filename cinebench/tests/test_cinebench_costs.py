"""Op costs, the model's closed-form FLOP and the trace folding, against
hand counts at small shapes."""

import pytest
import torch
import torch.nn.functional as F

from cinebench.costs import conv, dft_matmul, normal_apply, normal_apply_bwd
from cinebench.harness import flops, trace
from cinebench.harness.bench import Run, read_metric
from cinebench.reference import nets


def test_op_costs_by_hand():
    # x (b 1, t 2, h 3, w 4), K (1, 2, 3, 3), S (1, c 5, 3, 4)
    shapes = [(1, 2, 3, 4), (1, 2, 3, 4), (1, 2, 3, 3), (1, 2, 3, 3), (1, 5, 3, 4), (1, 5, 3, 4),
              (1,), (), ()]
    f, b = normal_apply.cost(shapes)
    assert f == 8 * 2 * 5 * 3 * 3 * 4 + 14 * 2 * 5 * 12 + 4 * 2 * 12
    assert b == 8 * (2 * 24 + 18 + 60)
    bwd = [(1, 2, 3, 4)] * 4 + [(1, 2, 3, 3)] * 2 + [(1, 5, 3, 4)] * 2 + [(1,), (), ()]
    f, b = normal_apply_bwd.cost(bwd)
    assert f == 16 * 2 * 5 * 9 * 4 + 36 * 2 * 5 * 12 + 8 * 24
    assert b == 4 * (6 * 24 + 2 * 18 + 4 * 60 + 2)
    assert dft_matmul.cost([(7, 5, 3)]) == (8 * 7 * 25 * 3, 4 * (4 * 105 + 50))
    assert conv.cost([(2, 3, 5, 5), (4, 3, 3, 3), (2, 4, 5, 5)])[0] == 2 * 2 * 4 * 25 * 27
    assert conv.transposed([(2, 8, 3, 3), (8, 4, 2, 2), (2, 4, 6, 6)])[0] == 2 * 2 * 8 * 9 * 16


def _counted_unet_flop(n, size, chans, pools):
    """FLOP of the reference U-Net's convolutions, counted as they run."""
    count = [0.0]
    conv2d, convt = F.conv2d, F.conv_transpose2d

    def c2(x, w, b=None, **kw):
        y = conv2d(x, w, b, **kw)
        count[0] += 2 * y.numel() * w[0].numel()
        return y

    def ct(x, w, b=None, **kw):
        count[0] += 2 * x.numel() * w[0].numel()
        return convt(x, w, b, **kw)

    p, ci, ch = {}, 2, chans
    names = [f"u.down.{j}" for j in range(pools)] + ["u.bottom"]
    for name in names:
        p[f"{name}.conv0.weight"] = torch.randn(ch, ci, 3, 3)
        p[f"{name}.conv1.weight"] = torch.randn(ch, ch, 3, 3)
        ci, ch = ch, ch * 2
    ch = ci
    for i in range(pools):
        p[f"u.up_transpose.{i}.conv.weight"] = torch.randn(ch, ch // 2, 2, 2)
        p[f"u.up_conv.{i}.conv0.weight"] = torch.randn(ch // 2, ch, 3, 3)
        p[f"u.up_conv.{i}.conv1.weight"] = torch.randn(ch // 2, ch // 2, 3, 3)
        ch //= 2
    p["u.final.weight"], p["u.final.bias"] = torch.randn(2, ch, 1, 1), torch.zeros(2)
    F.conv2d, F.conv_transpose2d = c2, ct
    try:
        nets.unet(torch.randn(n, 2, *size), p, "u", pools)
    finally:
        F.conv2d, F.conv_transpose2d = conv2d, convt
    return count[0]


@pytest.mark.parametrize("size", [(32, 16), (20, 15)])
def test_unet_flop_matches_a_count_of_the_reference(size):
    assert flops.unet_flop(3, size, 4, 2) == _counted_unet_flop(3, size, 4, 2)


def test_train_step_counts_three_forwards():
    cfg = {"family": "varnet", "dynamic_type": "XF", "frames": 6, "coils": 3, "height": 32,
           "width": 32, "model": {"num_cascades": 2, "chans": 4, "pools": 2, "sens_chans": 4,
                                  "sens_pools": 2}}
    assert flops.item_flop(cfg, "train") == 3 * flops.item_flop(cfg, "serve") > 0


def _trace():
    # host: (start, end, thread, correlation, name, shapes); device: (start, end, name, link)
    shapes = [(1, 2, 4, 4), (1, 2, 4, 4), (1, 2, 4, 4), (1, 2, 4, 4), (1, 3, 4, 4), (1, 3, 4, 4),
              (1,), (), ()]
    host = [(0, 1000, 1, 1, trace.ITEM, None),
            (100, 400, 1, 2, "cinemri::normal_apply", shapes),
            (150, 200, 1, 3, "aten::empty", None),      # nested: its kernel counts too
            (460, 520, 1, 4, "aten::mul", None)]
    device = [(410, 450, "normal_apply_contract_kernel", 2),
              (450, 470, "zero_kernel", 3),
              (620, 700, "vectorized_elementwise_kernel", 4)]
    t = trace.fold_device([(0, 800, "marker", 0), (900, 1000, "conv_kernel", 0)], items=1)
    return trace.fold_ops(t, host, device, ["cinemri::normal_apply"])


def test_fold_attributes_kernels_through_the_op_link():
    t = _trace()
    assert t.ops["cinemri::normal_apply"] == [(_trace().ops["cinemri::normal_apply"][0][0],
                                              pytest.approx(60e-9), 2)]
    assert t.window_s == pytest.approx(1e-6) and t.busy_s == pytest.approx(0.9e-6)
    assert t.seconds_of_kind("conv") == pytest.approx(100e-9)
    # idle inside the item span, by the innermost op open at the gap's start
    assert t.gaps[trace.ITEM] == pytest.approx((410 + 300) * 1e-9)
    assert t.gaps["aten::mul"] == pytest.approx(150e-9)


def test_roofline_is_bound_over_kernel_time():
    run = Run(kind="serve", setup_s=1.0, window_s=1.0, items=[], peak_window_bytes=0,
              item_flop=1.0, peak_flops=67e12, peak_bw=3.35e12, trace=_trace())
    f, b = normal_apply.cost(run.trace.ops["cinemri::normal_apply"][0][0])
    bound = max(f / 67e12, b / 3.35e12)
    assert read_metric("normal_apply_roofline.serve", run) == pytest.approx(100 * bound / 60e-9)
    assert read_metric("idle_pct.serve", run) == pytest.approx(10.0)
