"""The port's stage profiler (``gsplat_tpu_torch/scripts/profile_trace.py``)
on the CPU: a train step and a render of a tiny bench-kind scene traced
with ``torch.profiler``, the CPU ops of the calling thread attributed by
category.  The categories and the gaps between operations must sum to the
traced window (relative 1e-6), and the step's sorts, SSIM's matmuls and
elementwise ops must each appear.  The attribution itself is checked on
made-up intervals, and the categories on the names the card's kernels
carry.
"""

import pytest
import torch

from gsplat_tpu_torch import bench
from gsplat_tpu_torch.scripts import profile_trace as pt

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fns():
    scene = bench.build_scene(2000, 64, 48, 60.0, 2, False, "cpu")
    return pt.view0_fns(*scene)


def _sums(res):
    total = sum(res["categories"].values()) + res["gaps_ms"]
    assert abs(total - res["window_ms"]) <= 1e-6 * res["window_ms"]
    assert abs(sum(res["ops"].values()) + res["gaps_ms"]
               - res["window_ms"]) <= 1e-6 * res["window_ms"]
    assert res["window_ms"] > 0 and res["untraced_ms"] > 0


def test_train_step_categories_sum_to_the_window(fns, capsys):
    res = pt.trace_and_attribute(fns[1], device="cpu")
    assert res["device"] == "cpu" and res["reps"] == pt.REPS
    _sums(res)
    cats = res["categories"]
    for cat in ("sort/search/scan", "matmul (SSIM)",
                "elementwise/reduction", "gather/scatter/index"):
        assert cats.get(cat, 0.0) > 0, cat
    pt.report(res, "train")
    out = capsys.readouterr().out
    assert "matmul (SSIM)" in out and "(gaps between operations)" in out


def test_render_categories_sum_to_the_window(fns):
    res = pt.trace_and_attribute(fns[0], device="cpu")
    _sums(res)
    cats = res["categories"]
    assert cats.get("sort/search/scan", 0.0) > 0
    assert cats.get("elementwise/reduction", 0.0) > 0
    assert "matmul (SSIM)" not in cats       # a render has no SSIM


def test_attribute_gives_each_instant_to_the_innermost_op():
    cats, ops, gaps, window = pt.attribute([
        (0.0, 10.0, "aten::mul"),          # outer: its own time only
        (2.0, 5.0, "aten::sort"),          # nested in it
        (3.0, 4.0, "aten::index"),         # nested twice
        (12.0, 15.0, "aten::mm"),
        (14.0, 16.0, "Memset (Device)"),   # overlaps the matmul's end
    ])
    assert window == 16.0 and gaps == 2.0
    assert cats == {"elementwise/reduction": 7.0, "sort/search/scan": 2.0,
                    "gather/scatter/index": 1.0, "matmul (SSIM)": 2.0,
                    "memset": 2.0}
    assert ops["aten::mul"] == 7.0
    assert sum(cats.values()) + gaps == window
    assert pt.attribute([]) == ({}, {}, 0.0, 0.0)


@pytest.mark.parametrize("name,cat", [
    ("void (anonymous namespace)::rasterize_fwd_kernel<((anonymous "
     "namespace)::Mode)0>(void const*, void const*)", "kernel rasterize_fwd"),
    ("void (anonymous namespace)::rasterize_fwd_kernel<((anonymous "
     "namespace)::Mode)1>(void const*)", "kernel rasterize_fwd_sh"),
    ("rasterize_fwd_kernel<(Mode)2>", "kernel rasterize_fwd_preset"),
    ("rasterize_fwd_kernel<Mode::kPresetSh>",
     "kernel rasterize_fwd_preset_sh"),
    ("void (anonymous namespace)::rasterize_bwd_kernel<false>(float const*)",
     "kernel rasterize_bwd"),
    ("void (anonymous namespace)::rasterize_bwd_kernel<true>(float const*)",
     "kernel rasterize_bwd_sh"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>",
     "sort/search/scan"),
    ("void at::native::vectorized_gather_kernel<16, long>(char*)",
     "gather/scatter/index"),
    ("void (anonymous namespace)::indexing_backward_kernel_small_stride"
     "<float>(long const*)", "gather/scatter/index"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize64x64x8", "matmul (SSIM)"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy"
     "_alignedK_contig<...>", "copy"),
    ("Memset (Device)", "memset"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, std::array<char*, 1> >", "memset"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3> >",
     "elementwise/reduction"),
    ("aten::searchsorted", "sort/search/scan"),
    ("aten::cumsum", "sort/search/scan"),
    ("aten::index_put_", "gather/scatter/index"),
    ("aten::mm", "matmul (SSIM)"),
    ("aten::copy_", "copy"),
    ("aten::exp", "elementwise/reduction"),
])
def test_category_of_traced_names(name, cat):
    assert pt.category(name) == cat
