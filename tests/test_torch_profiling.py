"""``aliby_tpu_torch.utils.profiling`` on the CPU: ``trace`` writes a Chrome
trace of the region, and the names given to ``annotate`` appear in it and
in the profile's events."""

import json

import torch

from aliby_tpu_torch.utils.profiling import annotate, trace


def test_trace_and_annotate_on_the_cpu(tmp_path):
    x = torch.ones(64, 64)
    with trace(tmp_path / "t") as prof:
        with annotate("outer_region"):
            with annotate("inner_matmul"):
                y = x @ x
    assert float(y[0, 0]) == 64.0
    names = {e.name for e in prof.events()}
    assert {"outer_region", "inner_matmul"} <= names
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    written = {e.get("name") for e in events}
    assert {"outer_region", "inner_matmul"} <= written
    assert any("mm" in str(n) for n in written)


def test_trace_default_directory_follows_tmpdir(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with trace():
        with annotate("step"):
            torch.zeros(3).sum()
    assert (tmp_path / "aliby_tpu_torch_trace" / "trace.json").exists()
