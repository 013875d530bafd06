"""Device and idle time put down to the program's spans (``harness.spans``)
on synthetic events, the span metrics' readers, and the spans tool on a
tiny cell on the CPU."""
import importlib.util

import pytest
from conftest import ROOT, tiny_cell

from harness import spans, spec

NEW = ("model.fwd_bwd_ms", "moe.layer_ms", "moe.route_ms",
       "sparq_dist.local_step_ms", "sparq_dist.mix_ms", "moe.drop_pct",
       "sparq_dist.sent_rows_pct")
OLD = ("sparq_dist.sync_ms", "step.launches_per_step", "step.mfu_pct",
       "sign_topk_roofline", "device.idle_pct")
MS = 1_000_000


def _events():
    """One step: the forward on the main thread; its backward, in which
    autograd's thread recomputes a checkpointed MoE layer and then runs the
    layer's backward; a sync; and one kernel after the step. Each kernel
    (a copy every other one) ``(start, end, launch)`` in ms, its launch's
    correlation id its index + 1."""
    span = [("sparq.step", 0, 100), ("sparq.fwd_bwd", 1, 60),
            ("model.forward", 2, 20), ("moe.layer", 5, 15),
            ("moe.route", 6, 8), ("model.backward", 21, 60),
            ("moe.layer", 30, 40),             # autograd's thread
            ("sparq.sync", 70, 95), ("sparq.sync.mix", 75, 90),
            ("comm.fetch", 76, 78)]
    kernels = [(3, 5, 1.5), (7, 9, 6.5), (10, 11, 9), (31, 35, 32),
               (42, 47, 41), (79, 82, 77), (84, 85, 80), (101, 104, 100.5)]
    dev, launches = [], {}
    for k, (a, b, at) in enumerate(kernels):
        dev.append(("kernel" if k % 2 == 0 else "gpu_memcpy", a * MS,
                    b * MS, k + 1))
        launches[k + 1] = int(at * MS)
    return {"spans": [(n, a * MS, b * MS) for n, a, b in span],
            "device": dev, "launches": launches}


def test_device_time_goes_to_the_innermost_span_of_its_launch():
    rec = spans.record(_events(), {"moe.dropped": 3.0})
    assert (rec["named_steps"], rec["named_syncs"]) == (1, 1)
    assert rec["counters"] == {"moe.dropped": 3.0}
    got = rec["span_device_s"]
    ms = {k: round(v * 1e3, 9) for k, v in got["self"].items()}
    assert ms == {"sparq.fwd_bwd": 2.0,       # launched before the forward
                  "moe.route": 2.0, "moe.layer": 1.0 + 4.0,
                  "model.backward": 5.0,      # autograd's, after recompute
                  "comm.fetch": 3.0, "sparq.sync.mix": 1.0,
                  spans.OUTSIDE: 3.0}
    incl = {k: round(v * 1e3, 9) for k, v in got["inclusive"].items()}
    assert incl["sparq.step"] == 18.0 and incl["sparq.fwd_bwd"] == 14.0
    assert incl["model.forward"] == 3.0 and incl["model.backward"] == 9.0
    assert incl["moe.layer"] == 7.0 and incl["moe.route"] == 2.0
    assert incl["sparq.sync"] == incl["sparq.sync.mix"] == 4.0
    assert got["unlinked_s"] == 0.0 and got["overlap_s"] == 0.0
    assert rec["device_by_span"][0] == ["sparq.step", pytest.approx(0.018)]
    idle = {k: round(v * 1e3, 9) for k, v in rec["idle_by_span"]}
    # every gap from the step's start to the last kernel's end, by the span
    # open at its middle: 83 ms idle beside 21 ms busy
    assert idle == {"sparq.fwd_bwd": 3.0, "moe.route": 2.0,
                    "moe.layer": 1.0 + 7.0, "model.backward": 20.0,
                    "sparq.step": 32.0, "sparq.sync.mix": 2.0,
                    "sparq.sync": 16.0}


def test_a_launch_not_found_counts_outside_and_unlinked():
    ev = _events()
    del ev["launches"][2]
    got = spans.record(ev, {})["span_device_s"]
    assert round(got["unlinked_s"] * 1e3, 9) == 2.0
    assert round(got["self"][spans.OUTSIDE] * 1e3, 9) == 5.0
    assert "moe.route" not in got["self"]


def test_overlapping_activities_show_as_overlap():
    ev = _events()
    ev["device"].append(("kernel", 3 * MS, 4 * MS, 99))
    ev["launches"][99] = int(2.5 * MS)
    got = spans.record(ev, {})["span_device_s"]
    assert round(got["overlap_s"] * 1e3, 9) == 1.0


def _full_record():
    rec = spans.record(_events(), {"moe.dropped": 3.0, "moe.choices": 12,
                                   "sparq.rows_sent": 3,
                                   "sparq.rows_compressed": 4})
    rec["named_steps"] = 2
    return rec


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_the_record_or_nothing(name):
    read = spec.reader(name, ROOT)
    assert read({}) is None
    value = read(_full_record())
    want = {"model.fwd_bwd_ms": 14.0 / 2, "moe.layer_ms": 7.0 / 2,
            "moe.route_ms": 2.0 / 2, "sparq_dist.local_step_ms": None,
            "sparq_dist.mix_ms": 4.0, "moe.drop_pct": 25.0,
            "sparq_dist.sent_rows_pct": 75.0}[name]
    assert value == (None if want is None else pytest.approx(want))


def _old_record():
    return {"sync_ms": [10.0, 12.0], "profiled_steps": 3,
            "kernels": [("sign_topk_kernel", 2_000_000), ("mul", 100)],
            "window_s": 2.0, "busy_s": 1.5, "flops_per_token": 1e9,
            "tokens_per_step": 4096, "sign_topk_tiles": 1000}


@pytest.mark.parametrize("name", OLD)
def test_old_readers_read_alike_beside_the_span_keys(name):
    read = spec.reader(name, ROOT)
    plain = _old_record()
    both = dict(plain, **_full_record())
    assert read(both) == read(plain) is not None


def test_tool_runs_a_tiny_cell_on_the_cpu():
    path = ROOT / "bench" / "tools" / "spans.py"
    loader = importlib.util.spec_from_file_location("bench_tool_spans", path)
    tool = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(tool)
    import torch
    line = tool.measure(tiny_cell("dsmoe16b-d2n4.train", "float32"),
                        3_000_000_019, torch.device("cpu"), steps=3)
    rec = line["record"]
    assert rec["named_steps"] == line["steps"] == 3
    assert rec["named_syncs"] == 1
    m = line["metrics"]
    assert 0.0 <= m["moe.drop_pct"] < 100.0
    assert m["sparq_dist.sent_rows_pct"] == line["sent_by_triggers_pct"]
    # no device time on the CPU: the timed readers read nothing
    assert m["model.fwd_bwd_ms"] is None and line["covered_pct"] is None
    assert [len(v) for v in line["wall_s"]["profiled"].values()] == [2, 2]
