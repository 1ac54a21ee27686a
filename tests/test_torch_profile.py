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
