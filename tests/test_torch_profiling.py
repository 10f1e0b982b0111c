"""``aliby_tpu_torch.utils.profiling`` on the CPU: ``trace`` writes a Chrome
trace of the region, and the names given to ``span`` appear in it and in the
profile's events, from the calling thread under any profiler and from pool
threads under one that profiles every thread; with neither a profiler nor
the recorder a span does nothing; the recorder's calls, host seconds and
self-seconds of nested spans and of spans on many threads. A span's stream
time is checked on the card (marked ``cuda``)."""

import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aliby_tpu_torch.utils import profiling
from aliby_tpu_torch.utils.profiling import span, trace


@pytest.fixture
def recorder():
    profiling.reset()
    with profiling.recording():
        yield
    profiling.reset()


def test_trace_and_annotate_on_the_cpu(tmp_path):
    x = torch.ones(64, 64)
    with trace(tmp_path / "t") as prof:
        with span("outer_region"):
            with span("inner_matmul"):
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
        with span("step"):
            torch.zeros(3).sum()
    assert (tmp_path / "aliby_tpu_torch_trace" / "trace.json").exists()


def test_a_span_off_records_nothing_and_enters_no_range(monkeypatch):
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) entered with the profiler off")

    monkeypatch.setattr(profiling, "record_function", no_range)
    profiling.reset()
    with span("off.outer"):
        with span("off.inner", device=torch.device("cpu")):
            torch.ones(4).sum()
    assert profiling.totals() == {}
    assert profiling.thread_host_s().get("off.outer") is None


def test_nested_spans_appear_in_the_profile_of_the_calling_thread():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("nest.outer"):
            with span("nest.inner"):
                torch.ones(8).sum()
    got = {e.name: e.time_range for e in prof.events() if e.name.startswith("nest.")}
    assert set(got) == {"nest.outer", "nest.inner"}
    assert got["nest.outer"].start <= got["nest.inner"].start
    assert got["nest.inner"].end <= got["nest.outer"].end


def test_a_pool_threads_span_appears_when_every_thread_is_profiled():
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    caller = threading.get_ident()

    def work():
        with span("pool.span"):
            torch.ones(8).sum()
        return threading.get_ident()

    with profile(activities=[ProfilerActivity.CPU], experimental_config=config) as prof:
        with ThreadPoolExecutor(2) as pool:
            ran_on = pool.submit(work).result(timeout=60)
    assert ran_on != caller
    assert "pool.span" in {e.name for e in prof.events()}


def test_the_recorder_takes_calls_host_and_self_seconds_of_nested_spans(recorder):
    for _ in range(2):
        with span("rec.outer"):
            time.sleep(0.02)
            with span("rec.inner"):
                time.sleep(0.03)
            with span("rec.inner"):
                time.sleep(0.01)
    got = profiling.totals()
    outer, inner = got["rec.outer"], got["rec.inner"]
    assert (outer["n"], inner["n"]) == (2, 4)
    assert inner["host_s"] >= 0.08 and inner["self_s"] == inner["host_s"]
    assert outer["host_s"] >= 0.12
    assert outer["self_s"] == pytest.approx(outer["host_s"] - inner["host_s"], abs=1e-9)
    assert 0.04 <= outer["self_s"] < outer["host_s"] - 0.079
    assert outer["device_s"] is None and inner["device_s"] is None  # no card's work
    host = profiling.thread_host_s()
    assert host["rec.outer"] == pytest.approx(outer["host_s"], abs=1e-9)


def test_spans_from_many_threads_add_up(recorder):
    threads, spans = 16, 300
    per_thread = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(spans):
                with span("many.outer"):
                    with span("many.inner"):
                        pass
            per_thread[i] = profiling.thread_host_s()

        pool = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    got = profiling.totals()
    assert got["many.outer"]["n"] == got["many.inner"]["n"] == threads * spans
    for name in ("many.outer", "many.inner"):
        assert got[name]["host_s"] == pytest.approx(
            sum(h[name] for h in per_thread.values()), rel=1e-9)
    outer = got["many.outer"]
    assert outer["self_s"] == pytest.approx(outer["host_s"] - got["many.inner"]["host_s"],
                                            rel=1e-6)


def test_recording_blocks_nest_and_reset_clears():
    profiling.reset()
    with profiling.recording():
        with profiling.recording():
            with span("blocks.a"):
                pass
        with span("blocks.a"):
            pass
    with span("blocks.a"):
        pass
    assert profiling.totals()["blocks.a"]["n"] == 2
    profiling.reset()
    assert profiling.totals() == {}


@pytest.mark.cuda
def test_a_device_span_takes_stream_time_without_a_synchronise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (stream time is the card's)")
    dev = torch.device("cuda")
    x = torch.randn(2048, 2048, device=dev)
    torch.cuda.synchronize()
    profiling.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profiling.recording():
            with span("card.work", device=dev):
                for _ in range(20):
                    x = x @ x / 2048.0
            with span("card.host"):
                pass
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    got = profiling.totals()
    profiling.reset()
    assert got["card.work"]["n"] == 1
    assert got["card.work"]["device_s"] > 0
    assert got["card.host"]["device_s"] is None
