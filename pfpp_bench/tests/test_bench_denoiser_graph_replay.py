"""The reader of ``denoiser_graph_replay_pct.serve``: the share of the denoiser's calls in the
traced slice (``pfpp.engine.denoiser`` spans) that replayed a captured CUDA graph
(``pfpp.denoiser.replay`` spans). None outside a traced run and without a denoiser span, 0
after a CPU engine call (the CPU runs the forward eagerly), and the ratio of the counts on
given snapshots."""

from __future__ import annotations

import pytest

from pfpp_bench.tests.test_bench_program_spans import TRACED, engine_call, profiled, read
from puzzlefusion_plusplus_tpu_torch.utils import profiling

METRIC = "denoiser_graph_replay_pct.serve"


def test_none_without_a_slice_or_spans():
    assert read(METRIC, {}) is None
    assert read(METRIC, {"slice": None}) is None
    profiled(profiling.profiling_on)  # a session with no spans
    assert read(METRIC, TRACED) is None


def test_zero_after_a_cpu_engine_call(tmp_path):
    _, snap = profiled(engine_call(str(tmp_path)))
    assert snap["spans"]["pfpp.engine.denoiser"]["count"] > 0
    assert read(METRIC, TRACED) == 0.0


@pytest.mark.parametrize("spans,share", [
    ({"pfpp.engine.step": 40, "pfpp.denoiser.replay": 40}, None),  # no denoiser span
    ({"pfpp.engine.denoiser": 40}, 0.0),
    ({"pfpp.engine.denoiser": 40, "pfpp.denoiser.capture": 2, "pfpp.denoiser.replay": 40},
     100.0),
    ({"pfpp.engine.denoiser": 40, "pfpp.denoiser.replay": 10}, 25.0),
])
def test_share_from_snapshots(monkeypatch, spans, share):
    snap = {"spans": {n: {"count": c, "total_s": 1e-3 * c, "self_s": 1e-3 * c}
                      for n, c in spans.items()}, "records": [], "dropped": 0}
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    assert read(METRIC, TRACED) == share
    assert read(METRIC, {}) is None
