"""Runs of the cells at a tiny size on the CPU with the timed path broken underneath: each
fault a cell can have makes ``correct`` come out false. (The look for a card is skipped by
calling ``run_cell`` with the CPU.)"""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from pfpp_bench import manifest, run

CPU = "cpu"


def serve(tiny, name="engine_b8"):
    over, w_over = tiny["serve"]
    return run.run_cell(name, 21, 0.5, False, device=CPU, cfg_override=over,
                        w_override=w_over, workers=1)


def train(tiny, name="denoiser_train_b64", plant=None, n_shapes=16, root=manifest.ROOT):
    over, w_over = tiny["train"]
    w_over["traffic"]["part_draw"]["shapes"] = n_shapes
    if plant:
        w_over["plant"] = plant
    return run.run_cell(name, 22, 0.5, False, device=CPU, root=root, cfg_override=over,
                        w_override=w_over, workers=1)


def test_sound_runs_are_correct(tiny):
    assert serve(tiny)["correct"] and train(tiny)["correct"]


def broken_step(step, fault):
    def broken(params, pred, t, sample, noise, n):
        if fault == "state_unchanged":
            return sample
        out = step(params, pred, t, sample, noise, n)
        # one coordinate of every pose moved by 1e-3 (pinned reference parts undo it; every
        # shape has a part that is not one)
        return out + 1e-3 * torch.nn.functional.one_hot(torch.tensor(0), out.shape[-1])

    return broken


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_serving_faults(tiny, monkeypatch, fault):
    from puzzlefusion_plusplus_tpu_torch.inference import engine

    monkeypatch.setattr(engine, "ddpm_step", broken_step(engine.ddpm_step, fault))
    assert not serve(tiny)["correct"]


class Unseen:
    """A recorder that sees no step, as when the engine replays a captured graph."""

    def __init__(self, denoiser, verifier):
        self.calls = {}

    def begin(self, i):
        pass

    def close(self):
        pass


@pytest.mark.parametrize("fault", [None, "state_unchanged", "answer_altered"])
def test_serving_free_runs(tiny, monkeypatch, fault):
    """Where the program does not show its steps, the check runs the reference free and
    compares the engine's trajectory: sound runs pass it and each fault fails it."""
    from pfpp_bench.drivers import engine as drv
    from puzzlefusion_plusplus_tpu_torch.inference import engine

    monkeypatch.setattr(drv, "Recorder", Unseen)
    if fault:
        monkeypatch.setattr(engine, "ddpm_step", broken_step(engine.ddpm_step, fault))
    out = serve(tiny)
    assert "free_pose_gap" in out["checks"] and "pose_gap" not in out["checks"]
    assert out["correct"] == (fault is None)


def test_a_call_is_followed_step_by_step_only_where_each_step_shows(tiny):
    from pfpp_bench.drivers.engine import stepwise

    cfg = {"engine": {"max_iters": 2, "num_inference_steps": 2}}
    xs = [torch.zeros(3) for _ in range(4)]
    assert stepwise({"n_iters": 2, "x": xs, "logits": [0]}, cfg)
    assert not stepwise({"n_iters": 2, "x": xs[:1] * 4, "logits": [0]}, cfg)  # one buffer
    assert not stepwise({"n_iters": 2, "x": [], "logits": []}, cfg)  # a replayed graph
    assert not stepwise({"n_iters": 2, "x": xs, "logits": []}, cfg)


def test_training_state_unchanged(tiny, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    assert not train(tiny)["correct"]


def test_training_half_batch(tiny, monkeypatch):
    from puzzlefusion_plusplus_tpu_torch.training import denoiser

    loss_fn = denoiser.loss_fn

    def half(model, encoder, ddpm, batch, generator=None, timestep_set=None,
             encode_cached=False, timesteps=None, noise=None, group=None):
        h = len(timesteps) // 2
        batch = {k: v[:h] for k, v in batch.items()}
        return loss_fn(model, encoder, ddpm, batch, generator, timestep_set, encode_cached,
                       timesteps[:h], noise[:h], group)

    monkeypatch.setattr(denoiser, "loss_fn", half)
    assert not train(tiny)["correct"]


def no_exchange():
    """Planted in every rank: the gradients are not summed over the ranks."""
    from puzzlefusion_plusplus_tpu_torch.parallel import mesh

    mesh.all_reduce_gradients = lambda model, group=None: None


def test_data_parallel_exchange_left_out(tiny, tmp_path):
    # the 4-rank cell (pfpp_bench/workloads/denoiser_train_dp4.json, not yet an entry of
    # BENCHMARK.json) in a copy of the tree that lists it; gloo ranks on the CPU
    shutil.copytree(f"{manifest.ROOT}/pfpp_bench", tmp_path / "pfpp_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = manifest.benchmark()
    bench["workloads"].append({"name": "denoiser_train_dp4", "chips": 4, "traffic": "dp4",
                               "config": "pfpp_everyday_denoiser_train", "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_shapes_per_s":
            m["workloads"].append("denoiser_train_dp4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    root = str(tmp_path)
    sound = train(tiny, "denoiser_train_dp4", n_shapes=64, root=root)
    assert sound["correct"] and sound["checks"]["rank_gap"]["value"] == 0.0
    broken = train(tiny, "denoiser_train_dp4", f"{__name__}:no_exchange", n_shapes=64,
                   root=root)
    assert not broken["correct"]
