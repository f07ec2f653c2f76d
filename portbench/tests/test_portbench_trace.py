"""The reading of a profiler trace: busy seconds as the union of the
device operations' intervals, launches and seconds by name, and each idle
gap named by the innermost host operation running at its middle."""
from types import SimpleNamespace

import torch

import smoke  # noqa: F401  (puts the benchmark's folder on the path)
import harness  # noqa: E402

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, dev, start, end, annotation=False):
        self._v = (name, dev, start, end - start, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_busy_is_the_union_and_gaps_are_named():
    events = [Event("k1", CUDA, 0, 10), Event("k2", CUDA, 5, 20),
              Event("k1", CUDA, 30, 40),
              Event("marker", CUDA, 0, 40, annotation=True),
              Event("aten::mm", CPU, 18, 29),
              Event("step", CPU, 0, 40)]
    t = harness.read_trace(_prof(events), 0, 40)
    assert t.window_s == 40e-9 and t.busy_s == 30e-9
    assert t.ops == {"k1": (2, 20e-9), "k2": (1, 15e-9)}
    assert t.kernels("k1") == (2, 20e-9)
    assert t.idle_gaps == [("host:aten::mm", 10e-9)]
    b = t.breakdown()
    assert [n for n, _ in b["device_ops"]] == ["k1", "k2"]


def test_idle_share_of_a_record():
    rec = harness.Record(cell={}, config={}, traffic={}, chips=1,
                         window_s=1.0,
                         trace=harness.Trace(window_s=2.0, busy_s=1.5,
                                             ops={}))
    assert harness.idle_pct(rec) == 25.0
    rec.counters["idle_pct"] = 40.0        # the most over a mesh's ranks
    assert harness.idle_pct(rec) == 40.0


def test_roofline_over_calls_counts_each_call_at_its_prompts():
    """Two prefills, 3 launches each in the trace: each launch counted at
    its own call's prompts."""
    import counts
    calls = [{"Hq": 4, "Hkv": 2, "D": 64, "window": None,
              "lengths": [100, 0]},
             {"Hq": 4, "Hkv": 2, "D": 64, "window": None,
              "lengths": [50, 70]}]
    rec = harness.Record(cell={}, config={}, traffic={}, chips=1,
                         window_s=1.0, counters={"fa_calls": calls},
                         trace=harness.Trace(window_s=1.0, busy_s=1.0,
                                             ops={"fa_fwd_bf16": (6, 2e-3)}))
    least = 3 * sum(counts.launch_bound_ms("flash_attention_rows", c)
                    for c in calls)
    got = harness.calls_roofline_pct(rec, "flash_attention_rows",
                                     ("fa_fwd",), "fa_calls")
    assert abs(got - 100.0 * least / 1e3 / 2e-3) < 1e-9
    rec.counters["fa_calls"] = None
    assert harness.calls_roofline_pct(rec, "flash_attention_rows",
                                      ("fa_fwd",), "fa_calls") is None
