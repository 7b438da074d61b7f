"""The port's profiling and sanitizer tools (``utils/profiling.py``, ``utils/sanitize.py``).

The JAX package's versions wrap ``jax.profiler``, ``block_until_ready`` and
``jax_debug_nans``; the port's wrap ``torch.profiler``, CUDA synchronization and autograd's
anomaly detection. On the CPU the synchronization is a no-op, so these tests check the
semantics: what is timed, traced, raised and restored."""

import json
import time

import numpy as np
import pytest
import torch

from puzzlefusion_plusplus_tpu_torch.matching.sinkhorn import sinkhorn_log
from puzzlefusion_plusplus_tpu_torch.utils import profiling, sanitize


def test_timer_and_average_meter():
    t = profiling.Timer()
    for _ in range(2):
        t.start()
        time.sleep(0.01)
        assert t.stop(torch.ones(2)) >= 0.01
    assert t.meter.count == 2 and t.meter.avg >= 0.01
    m = profiling.AverageMeter()
    m.update(1.0, n=3)
    m.update(5.0)
    assert m.avg == pytest.approx(2.0) and profiling.AverageMeter().avg == 0.0


def test_phase_timer_records_or_prints(capsys):
    results = {}
    for _ in range(2):
        with profiling.phase_timer("step", results):
            time.sleep(0.005)
    assert results["step"].count == 2 and results["step"].avg >= 0.005
    with profiling.phase_timer("load"):
        pass
    assert capsys.readouterr().out.startswith("[phase] load: ")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    with open(tmp_path / "trace" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def test_log_compile_time_tags_the_first_call(capsys):
    @profiling.log_compile_time
    def double(x):
        return 2 * x

    assert torch.equal(double(torch.ones(3)), torch.full((3,), 2.0))
    double(torch.ones(3))
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[double] build+run: ") and out[1].startswith("[double] steady: ")
    assert double.calls["calls"] == 2


def test_check_finite_names_the_bad_leaves():
    model = torch.nn.Linear(3, 2)
    sanitize.check_finite(model, "model")
    sanitize.check_finite({"a": [torch.ones(2), np.zeros(3)], "n": torch.arange(3)})
    with torch.no_grad():
        model.bias[0] = float("nan")
    with pytest.raises(FloatingPointError, match="bias"):
        sanitize.check_finite(model.state_dict(), "model")
    with pytest.raises(FloatingPointError, match=r"x\[1\]"):
        sanitize.check_finite({"x": [np.ones(2), np.array([np.inf])]})


def test_assert_doubly_stochastic_on_sinkhorn_output():
    """The matcher's Sinkhorn output passes; a matrix out of range or off in its row sums
    fails."""
    g = torch.Generator().manual_seed(0)
    s = torch.randn(2, 6, 6, generator=g)
    n = torch.tensor([6, 4])
    mat = sinkhorn_log(s, n, n, max_iter=50, tau=1.0)  # converged
    sanitize.assert_doubly_stochastic(mat, n, n)
    with pytest.raises(AssertionError, match="range"):
        sanitize.assert_doubly_stochastic(mat * 3, n, n)
    with pytest.raises(AssertionError, match="row sums"):
        sanitize.assert_doubly_stochastic(mat * 0.5, n, n)


def test_debug_nans_traps_the_nan_and_restores_the_flag():
    x = torch.tensor([-1.0], requires_grad=True)
    assert not torch.is_anomaly_enabled()
    with pytest.raises(RuntimeError, match="nan"):
        with sanitize.debug_nans():
            assert torch.is_anomaly_enabled()
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()
