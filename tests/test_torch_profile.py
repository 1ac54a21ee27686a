"""The device-busy measure of the port's profiling script, on a synthetic
Chrome trace: overlapping device spans count once, host spans not at all."""
import json

import pytest

from repro_torch.launch.profile_forward import busy_ms


def _span(cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": cat, "ts": ts, "dur": dur}


@pytest.mark.parametrize(
    "cats, expected_ms",
    [
        # kernels [0,100) u [50,150) u [300,400), copy [140,200), memset [500,510)
        (("kernel", "gpu_memcpy", "gpu_memset"), (200 + 100 + 10) / 1e3),
        (("kernel",), (150 + 100) / 1e3),
    ],
)
def test_busy_ms_union_of_device_spans(tmp_path, cats, expected_ms):
    events = [
        _span("kernel", 0, 100),
        _span("kernel", 50, 100),
        _span("gpu_memcpy", 140, 60),
        _span("kernel", 300, 100),
        _span("kernel", 320, 20),  # inside the previous span
        _span("gpu_memset", 500, 10),
        _span("cpu_op", 0, 1000),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 600},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert busy_ms(str(path), cats) == pytest.approx(expected_ms)


def test_lm_report_groups_kernel_time_by_name(tmp_path):
    from repro_torch.launch.profile_forward import group_kernel_ms, kernel_ms_by_name

    events = [
        _span("kernel", 0, 300), _span("kernel", 400, 100), _span("gpu_memcpy", 0, 50),
        _span("cpu_op", 0, 999),
    ]
    names = ["void flash_kernel<__nv_bfloat16, 256>(Params)", "nvjet_tst_192x8_64x3_2x1",
             "memcpy", "aten::mm"]
    for e, name in zip(events, names):
        e["name"] = name
    events.append({"ph": "X", "cat": "kernel", "name": "rmsnorm_kernel<float>", "ts": 600, "dur": 20})
    events.append({"ph": "X", "cat": "kernel", "name": "elementwise_kernel", "ts": 700, "dur": 30})
    events.append({"ph": "X", "cat": "kernel", "name": "elementwise_kernel", "ts": 800, "dur": 10})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    by_name = kernel_ms_by_name(str(path))
    assert {k: n for k, (_, n) in by_name.items()} == {
        names[0]: 1, names[1]: 1, "rmsnorm_kernel<float>": 1, "elementwise_kernel": 2}
    assert {k: ms for k, (ms, _) in by_name.items()} == pytest.approx(
        {names[0]: 0.3, names[1]: 0.1, "rmsnorm_kernel<float>": 0.02, "elementwise_kernel": 0.04})
    assert group_kernel_ms(by_name) == pytest.approx(
        {"flash attention": 0.3, "rmsnorm": 0.02, "GEMM": 0.1, "other": 0.04})


def test_host_ops_counts_top_level_operators_only():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_forward import host_ops

    a = torch.ones(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        b = a + a
        (b * 2).sum()  # sum's internals are not top-level
    assert host_ops(prof) == 3
