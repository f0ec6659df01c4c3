"""The trace reduction and the metric readers on a synthetic run."""
import json

import numpy as np
import pytest

from portbench.count import flops, peaks
from portbench.lib import trace
from portbench.lib.cell import Batch, Run
from portbench.lib.main import reader
from portbench.lib.spec import HERE, load_cell
from portbench.lib.traffic import Traffic


def test_union_and_gaps_by_host_range():
    ms = 1_000_000
    dev = [(1 * ms, 3 * ms, "k1"), (2 * ms, 4 * ms, "k2"),
           (6 * ms, 7 * ms, "k1"), (9 * ms, 12 * ms, "k3")]
    host = [(0, 5 * ms, "prefill"), (5 * ms, 10 * ms, "decode")]
    tl = trace.timeline((0, 10 * ms), dev, host)
    assert tl.window_s == pytest.approx(0.010)
    assert tl.busy_s == pytest.approx(0.005)          # 1-4, 6-7, 9-10
    assert tl.by_op == pytest.approx({"k1": 0.003, "k2": 0.002, "k3": 0.001})
    # gaps 0-1 and 4-5 under prefill, 5-6 and 7-9 under decode
    assert tl.idle_by_host == pytest.approx({"prefill": 0.002,
                                             "decode": 0.003})
    assert trace.top(tl.by_op, 2) == [["k1", pytest.approx(0.003)],
                                      ["k2", pytest.approx(0.002)]]


def test_innermost_range_names_a_gap():
    ms = 1_000_000
    tl = trace.timeline((0, 10 * ms), [(8 * ms, 10 * ms, "k")],
                        [(0, 10 * ms, "outer"), (2 * ms, 4 * ms, "inner")])
    assert tl.idle_by_host == pytest.approx({"outer": 0.006, "inner": 0.002})


class _Ev:
    def __init__(self, name, kind, start, dur):
        self._n, self._k, self._s, self._u = name, kind, start, dur

    def name(self):
        return self._n

    def device_type(self):
        from torch.autograd import DeviceType
        return (DeviceType.CPU if self._k in ("cpu_op", "user_annotation")
                else DeviceType.CUDA)

    def is_user_annotation(self):
        return "annotation" in self._k

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


def test_read_kineto_events():
    evs = [_Ev(trace.WINDOW, "user_annotation", 0, 100),
           _Ev("pb.lookup", "user_annotation", 0, 50),
           _Ev("aten::mm", "cpu_op", 10, 5),
           _Ev("aten::add", "cpu_op", 12, 8),
           _Ev("aten::mm", "cpu_op", 30, 40),
           _Ev("pb.lookup", "gpu_user_annotation", 0, 60),
           _Ev("xam_multiset_kernel<4>", "kernel", 20, 10)]
    tl = trace.read(evs)
    assert tl.busy_s == pytest.approx(10e-9)
    assert tl.by_op == pytest.approx({"xam_multiset_kernel<4>": 10e-9})
    assert tl.idle_by_host == pytest.approx({"lookup": 40e-9, "none": 50e-9})
    assert tl.busy_by_host == pytest.approx({"lookup": 10e-9})
    assert trace.read(evs[:-1]) is None                # no device work
    assert trace.read(evs[1:]) is None                 # no window


def _run(timeline=None):
    cell = load_cell("yi9b.shared_prefix")
    t = Traffic(cell.traffic, 1, 64000)
    batches = []
    for i in range(4):
        prompts, answers = t.batch(i)
        b = Batch(prompts=prompts, answers=answers, start=i * 1.0,
                  first_token=i * 1.0 + 0.3 + 0.1 * (i == 3), end=i + 1.0,
                  lookup_s=0.002, prefill_s=0.25, submit_s=0.004,
                  decode_s=0.64, restored=prompts.shape[1] * 3 // 4 // 16
                  * 16)
        b.served = np.ones((16, t.decode_tokens), np.int32)
        batches.append(b)
    return Run(cell=cell, traffic=t, setup_s=12.5, window_s=4.0,
               batches=batches,
               counters={"engine.resumed_chunks": 96 * 64,
                         "engine.computed_chunks": 32 * 64},
               lookups=[b.prompts for b in batches],
               peak_window_bytes=34_000_000_000, timeline=timeline)


def test_end_to_end_readers():
    r = _run()
    assert reader("ttft_ms_p50")(r) == pytest.approx(300.0)
    # 48 of 64 requests at 300 ms, 16 at 400: the 95th is 400
    assert reader("ttft_ms_p95")(r) == pytest.approx(400.0)
    # each request's own answer: 236 tokens a batch
    assert reader("out_tokens_per_s")(r) == pytest.approx(4 * 236 / 4.0)
    assert reader("setup_s")(r) == 12.5


def test_layer_readers():
    r = _run()
    assert reader("lookup_ms")(r) == pytest.approx(2.0)
    assert reader("prefill_ms")(r) == pytest.approx(250.0)
    assert reader("admit_submit_ms")(r) == pytest.approx(4.0)
    # 33 tokens a batch, 32 of them decode steps
    assert reader("decode_step_ms")(r) == pytest.approx(640.0 / 32)
    assert reader("resumed_chunk_pct")(r) == pytest.approx(75.0)
    assert reader("peak_mem_gb")(r) == pytest.approx(34.0)
    model = r.cell.config["model"]
    work = [flops.batch_flops(model, b.prompts.shape[1], b.restored,
                              b.answers) for b in r.batches]
    pre, dec = sum(w[0] for w in work), sum(w[1] for w in work)
    assert reader("mfu")(r) == pytest.approx(
        100 * (pre + dec) / (4.0 * peaks.BF16_FLOPS))
    assert reader("mfu.prefill")(r) == pytest.approx(
        100 * pre / (1.3 * peaks.BF16_FLOPS))
    # no trace: the device readers find nothing
    assert reader("device_idle_pct")(r) is None
    assert reader("xam_multiset_roofline")(r) is None
    r.counters = {}
    assert reader("resumed_chunk_pct")(r) is None


def test_device_readers_on_a_trace():
    tl = trace.Timeline(window_s=4.0, busy_s=1.0,
                        by_op={"void xam_multiset_kernel<4>(...)": 4e-5,
                               "gemm": 0.9}, idle_by_host={},
                        busy_by_host={})
    r = _run(tl)
    assert reader("device_idle_pct")(r) == pytest.approx(75.0)
    # each lookup: a key a prompt chunk over 8 sets (all 8 hold some)
    need = sum(8 * (32 * 512 + 512) + b.prompts.size // 16 * 8
               for b in r.batches)
    assert reader("xam_multiset_roofline")(r) == pytest.approx(
        100 * need / peaks.HBM_BYTES / 4e-5)


def test_every_metric_has_a_reader_that_loads():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(reader(m["name"]))
