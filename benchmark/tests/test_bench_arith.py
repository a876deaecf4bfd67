"""The yardstick's arithmetic on small shapes worked by hand: the bound, the
work counts of each configuration's kernels, the models' FLOPs, the trace's
split of device time, and the roofline and MFU readers."""

import json
from types import SimpleNamespace

import pytest

from benchmark.harness.peaks import BF16_FLOPS, HBM_BPS, bound_s
from benchmark.harness.spec import load_reader
from benchmark.harness.trace import Trace, busy_us, category
from benchmark.reference import afno, sfno

TINY_SFNO = dict(img_shape_x=9, img_shape_y=16, scale_factor=2, embed_dim=2, mlp_ratio=2,
                 num_layers=2, in_channels=[0, 1, 2], model_grid_type="equiangular",
                 sht_grid_type="legendre-gauss", optimizer_moment_dtype="bfloat16")
TINY_AFNO = dict(crop_size_x=16, crop_size_y=32, patch_size=[8, 8], embed_dim=16, num_layers=2,
                 num_blocks=2, in_channels=[0, 1, 2], mlp_ratio=4.0)


def test_bound():
    assert bound_s(HBM_BPS, 0.0) == pytest.approx(1.0)
    assert bound_s(HBM_BPS, 2 * BF16_FLOPS) == pytest.approx(2.0)


def test_sfno_shapes_and_transforms():
    s = sfno.shapes(TINY_SFNO)
    assert (s["full"], s["inner"], s["L"], s["M"], s["H"]) == ((9, 16), (4, 8), 4, 5, 4)
    # block 0: analysis on the full grid, its residual and its output
    # synthesised on the inner grid; block 1 the mirror
    assert sfno._transforms(s) == [("full", "analysis"), ("inner", "synthesis"),
                                   ("inner", "synthesis"), ("inner", "analysis"),
                                   ("full", "synthesis"), ("full", "synthesis")]


def test_sfno_kernel_work_by_hand():
    w = sfno.kernel_work(TINY_SFNO, batch=1, train=True)
    # legmm, R = 2, 2M = 10, L = 4: full K = 9 moves 4 * (10*2*9 + 5*4*9 +
    # 10*2*4) = 1760 bytes and 2*10*2*9*4 = 1440 operations; inner K = 4:
    # 960 and 640; forward and backward each
    assert w["legmm"] == [(2, 1760.0, 1440.0), (2, 960.0, 640.0), (2, 960.0, 640.0),
                          (2, 960.0, 640.0), (2, 1760.0, 1440.0), (2, 1760.0, 1440.0)]
    # gridmm full analysis: rows 18, x bf16 18*16*2 = 576, table 16*10*4 =
    # 640, out 10*18*4 = 720; operations 2*18*16*10
    assert w["gridmm"][0] == (2, 576.0 + 640 + 720, 5760.0)
    # inner synthesis: rows 8, x f32 10*8*4 = 320, table 8*10*4, out 8*8*4
    assert w["gridmm"][1] == (2, 320.0 + 320 + 256, 2 * 8 * 8 * 10.0)
    # dhconv: x and out 2*1*4*2*5 floats each, w 2*4*2*2; 8*1*4*5*2*2
    assert w["dhconv_mm"] == [(4, 4.0 * (80 + 80 + 32), 640.0)]
    assert w["dhconv_dw"] == [(2, 4.0 * (80 + 80 + 32), 640.0)]
    # elements: big skip 9, encoder 6 + 2 + 4; a block's filter 32, norms
    # 4 + 4, MLP 8 + 4 + 8 + 2, outer skip 4; decoder 4 + 2 + 6: 165, each
    # p and g read, p written (f32), two bf16 moments read and written
    assert w["fused_adam"] == [(1, 20.0 * (21 + 2 * 66 + 12), 0.0)]
    # GELU: encoder and decoder 2 x 144 elements; block 0 on the inner grid
    # (2 + 4) x 32, block 1 on the full grid (2 + 4) x 144; 4 bytes forward,
    # 6 backward
    fwd = [e for i, e in enumerate(w["gelu"]) if i % 2 == 0]
    assert [b / 4 for _, b, _ in fwd] == [288.0, 288.0, 64.0, 128.0, 288.0, 576.0]


def test_sfno_parameters_count():
    spec = sfno.parameters(TINY_SFNO)
    assert len(spec) == 4 + 2 * 10 + 3
    flagship = dict(TINY_SFNO, img_shape_x=721, img_shape_y=1440, scale_factor=3,
                    embed_dim=384, num_layers=8, in_channels=list(range(73)))
    # the program's flagship: 572,507,857 elements in 87 leaves (PERF.md)
    leaves = sfno.parameters(flagship)
    assert len(leaves) == 87
    assert sum(int(__import__("math").prod(s)) for _, s, _ in leaves) == 572_507_857


def test_sfno_model_flops_by_hand():
    s = sfno.shapes(TINY_SFNO)
    E, H, C, L, M2 = 2, 4, 3, 4, 10
    dft = {"full": 2 * E * 9 * 16 * M2, "inner": 2 * E * 4 * 8 * M2}
    leg = {"full": 2 * M2 * E * 9 * L, "inner": 2 * M2 * E * 4 * L}
    f = sum(dft[g] + leg[g] for g, _ in sfno._transforms(s))
    f += 2 * 8 * L * 5 * E * E
    f += 2 * 32 * (2 * E * H + E * E) + 2 * 144 * (2 * E * H + E * E)
    f += 2 * 144 * (C * E + E * E) * 2 + 2 * 144 * C * C
    assert sfno.model_flops(TINY_SFNO, 1, False) == f
    assert sfno.model_flops(TINY_SFNO, 2, True) == 6 * f


def test_afno_work_and_flops_by_hand():
    # 2 x 4 tokens of 3*64 inputs, 8 kept modes (2 x 3), blocks of 8
    f = 2 * 8 * 192 * 16 * 2 + 2 * (2 * 8 * 6 * 2 * 8 * 8 + 2 * 8 * 2 * 16 * 64)
    assert afno.model_flops(TINY_AFNO, 1, False) == f
    assert afno.kernel_work(TINY_AFNO, 1, False) == {"gelu": [(2, 4.0 * 64 * 8, 0.0)]}
    assert len(afno.parameters(dict(TINY_AFNO, crop_size_x=720, crop_size_y=1440,
                                    embed_dim=768, num_layers=12, num_blocks=8,
                                    in_channels=list(range(73))))) == 136


def _trace(tmp_path):
    ev = [
        {"name": "bench.traced", "cat": "user_annotation", "ts": 0, "dur": 1000},
        {"name": "aten::bmm", "cat": "cpu_op", "ts": 190, "dur": 20, "args": {"External id": 7}},
        {"name": "train_step.optimizer", "cat": "gpu_user_annotation", "ts": 300, "dur": 150},
        {"name": "legmm_kernel<1>", "cat": "kernel", "ts": 0, "dur": 100, "args": {}},
        {"name": "sm90_xmma_gemm_bf16", "cat": "kernel", "ts": 200, "dur": 100,
         "args": {"External id": 7}},
        {"name": "elementwise_kernel", "cat": "kernel", "ts": 300, "dur": 100, "args": {}},
        {"name": "Memcpy DtoH (Device -> Pinned)", "cat": "gpu_memcpy", "ts": 500, "dur": 100},
        {"name": "aten::item", "cat": "cpu_op", "ts": 590, "dur": 400, "args": {}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return Trace(path)


def test_trace_split(tmp_path):
    tr = _trace(tmp_path)
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(4e-4)
    cats = tr.by_category()
    assert cats == pytest.approx({"own:legmm": 1e-4, "cublas": 1e-4, "eager": 1e-4, "d2h": 1e-4})
    assert tr.by_phase()["train_step.optimizer"] == pytest.approx(1e-4)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["aten::item", pytest.approx(4e-4)]
    assert tr.top_ops(2)[0][1] == pytest.approx(1e-4)
    assert busy_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert category({"name": "vector_fft<x>", "cat": "kernel", "args": {}}, {}) == "cufft"


def test_readers(tmp_path):
    tr = _trace(tmp_path)
    r = SimpleNamespace(trace=tr, units=2, work={"legmm": [(2, HBM_BPS * 1e-5, 0.0)]},
                        flops=BF16_FLOPS * 0.25, unit_s=1.0, peak_flops=BF16_FLOPS)
    # 2 launches of 10 us at the bound a unit, 2 units: 40 us of 100 us
    assert load_reader("legmm_roofline.train")(r, "legmm_roofline.train") == pytest.approx(40.0)
    assert load_reader("gridmm_roofline.train")(r, "gridmm_roofline.train") is None
    assert load_reader("mfu.train")(r, "mfu.train") == pytest.approx(25.0)
    assert load_reader("eager_ms.train")(r, "eager_ms.train") == pytest.approx(0.05)
    assert load_reader("cublas_ms.train")(r, "cublas_ms.train") == pytest.approx(0.05)
    assert load_reader("cufft_ms.serve")(r, "cufft_ms.serve") is None
    assert load_reader("d2h_ms.serve")(r, "d2h_ms.serve") == pytest.approx(0.05)
    assert load_reader("optimizer_ms.train")(r, "optimizer_ms.train") == pytest.approx(0.05)
    assert load_reader("device_idle_pct.train")(r, "x") == pytest.approx(60.0)
