"""The readers of the metrics that read the program's own spans
(``utils/profiling.py::snapshot``): ``host_ms_per_step.serve``,
``host_syncs_per_call.serve``, ``sync_wait_ms_per_call.serve`` and ``batch_build_ms.train``.
Each returns None outside a traced run and with an empty registry, and otherwise the ratio
of the spans recorded under ``torch.profiler``: here a tiny engine call and one
``prefetch_batches`` epoch on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pfpp_bench import manifest
from puzzlefusion_plusplus_tpu_torch.data import DenoiserDataset, Loader, generate_dataset
from puzzlefusion_plusplus_tpu_torch.data.loader import prefetch_batches
from puzzlefusion_plusplus_tpu_torch.inference import run as R
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE
from puzzlefusion_plusplus_tpu_torch.utils import profiling

READERS = ("host_ms_per_step.serve", "host_syncs_per_call.serve",
           "sync_wait_ms_per_call.serve", "batch_build_ms.train")
TRACED = {"slice": {"wall_s": 1.0, "busy_s": 0.5}}
ITERS, STEPS = 2, 3


def read(metric: str, r: dict):
    return manifest.reader(metric).read(r)


def profiled(fn):
    """``fn()`` as a new profiled session of the program's registry."""
    assert not profiling.profiling_on()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.snapshot()


def engine_call(root: str):
    generate_dataset(root, num_shapes=2, seed=4, split="val", min_parts=3, max_parts=5,
                     n_points=96)
    cfg = R.Config()
    cfg.data.max_num_part = 5
    for sub in (cfg.denoiser, cfg.verifier):
        sub.embed_dim, sub.num_layers, sub.num_heads = 32, 1, 2
    cfg.denoiser.num_inference_steps, cfg.verifier.max_iters = STEPS, ITERS
    _, den, ver = R.make_models(cfg)
    torch.manual_seed(0)
    vq = VQVAE(32, 16, 25, 64, sa_npoints=(24, 12), sa_nsamples=(8, 8, 8))
    engine = R.build_engine_fn(cfg, "cpu", models=(vq, den, ver))
    ds = DenoiserDataset(root + "/pc_data/val", mode="test",
                         matching_data_path=root + "/matching_data", max_num_part=5)
    batch = next(iter(Loader(ds, 2, shuffle=False, drop_last=False)))
    return lambda: engine(batch, generator=torch.Generator().manual_seed(0))


def mean_ms(snap: dict, name: str) -> float:
    recs = [r for r in snap["records"] if r["name"] == name]
    return 1e3 * sum(r["end"] - r["start"] for r in recs) / len(recs)


@pytest.mark.parametrize("metric", READERS)
def test_none_without_a_slice_or_spans(metric):
    assert read(metric, {}) is None
    assert read(metric, {"slice": None}) is None
    profiled(profiling.profiling_on)  # a session with no spans
    assert read(metric, TRACED) is None


def test_engine_readers_after_a_call(tmp_path):
    out, snap = profiled(engine_call(str(tmp_path)))
    assert int(out["n_iters"][0]) == ITERS  # no edge passes: no early exit
    assert read("host_ms_per_step.serve", TRACED) == pytest.approx(
        mean_ms(snap, "pfpp.engine.step"))
    # ITERS exit checks, ITERS - 1 merge gates, one fetch of the results
    assert read("host_syncs_per_call.serve", TRACED) == 2 * ITERS
    syncs = [r for r in snap["records"] if r["name"].startswith("pfpp.sync.")]
    assert read("sync_wait_ms_per_call.serve", TRACED) == pytest.approx(
        1e3 * sum(r["end"] - r["start"] for r in syncs))
    assert read("batch_build_ms.train", TRACED) is None  # no loader ran


def test_batch_build_after_an_epoch():
    items = [{"x": np.full(4, i)} for i in range(6)]
    got, snap = profiled(lambda: list(prefetch_batches(iter(items))))
    assert len(got) == 6
    assert read("batch_build_ms.train", TRACED) == pytest.approx(
        mean_ms(snap, "pfpp.loader.build"))
    for metric in READERS[:3]:  # no engine call
        assert read(metric, TRACED) is None
