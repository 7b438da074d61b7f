"""The port's inference breakdown records, and its denoiser trainer under bf16.

``inference.save_breakdown`` writes one ``breakdown.jsonl`` record per shape; the records
must equal the JAX package's on the same batch and results: ``data_id``, ``num_parts``,
``acc_per_part``, ``ref_part``, ``n_merged_pairs`` and ``n_iters`` exact, ``part_acc`` and
``part_acc_nonref`` within 1e-4, ``part_scale`` rounded to 5 digits by both.
The denoiser trainer once refused ``trainer.precision`` other than fp32; it now trains under
bf16 as the JAX package does (``tests/test_torch_port_bf16.py`` holds the numbers)."""

import json
import os

import numpy as np
import pytest
import torch

from puzzlefusion_plusplus_tpu.inference import run as JR
from puzzlefusion_plusplus_tpu_torch.data import generate_dataset
from puzzlefusion_plusplus_tpu_torch.inference import run as R
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE
from puzzlefusion_plusplus_tpu_torch.training import denoiser as ttrain

torch.set_num_threads(2)
EXACT = ("data_id", "num_parts", "acc_per_part", "ref_part", "part_scale", "n_merged_pairs",
         "n_iters")


def _batch_and_results(seed, B=5, P=6):
    rng = np.random.default_rng(seed)
    num_parts = rng.integers(1, P + 1, B)
    valids = (np.arange(P)[None] < num_parts[:, None]).astype(np.float32)
    batch = {
        "data_id": rng.permutation(100)[:B].astype(np.int64),
        "part_valids": valids,
        "ref_part": (rng.random((B, P)) < 0.3) & (valids == 1),
        "part_scale": rng.uniform(0.05, 2.0, (B, P, 1)).astype(np.float32),
    }
    results = {
        "acc_per_part": rng.random((B, P)) < 0.5,
        "part_acc": rng.random(B).astype(np.float32),
        "part_acc_nonref": rng.random(B).astype(np.float32),
        "n_merged_pairs": rng.integers(0, 4, B),
        "n_iters": np.full(B, rng.integers(1, 7)),
    }
    return batch, results


def _read(path):
    with open(os.path.join(path, "breakdown.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in EXACT:
            assert g[k] == w[k], k
        for k in ("part_acc", "part_acc_nonref"):
            assert abs(g[k] - w[k]) <= 1e-4, k


@pytest.mark.parametrize("seed,n_real", [(0, 5), (1, 3)])
def test_breakdown_records_match_jax(tmp_path, seed, n_real):
    batch, results = _batch_and_results(seed)
    results = {k: v[:n_real] for k, v in results.items()}  # the engine's real rows only
    JR.save_breakdown_records(str(tmp_path / "jax"), batch, results, n_real)
    R.save_breakdown_records(str(tmp_path / "port"), batch, results, n_real)
    want = _read(tmp_path / "jax")
    assert len(want) == n_real
    _assert_records_equal(_read(tmp_path / "port"), want)
    # a second batch appends, as the JAX package's does
    R.save_breakdown_records(str(tmp_path / "port"), batch, results, n_real)
    _assert_records_equal(_read(tmp_path / "port"), want + want)


def test_run_inference_writes_one_breakdown_record_per_shape(tmp_path):
    root = str(tmp_path / "data")
    generate_dataset(root, num_shapes=3, seed=4, split="val", min_parts=3, max_parts=5,
                     n_points=96)
    cfg = R.Config()
    cfg.data.max_num_part = 5
    cfg.data.data_val_dir = root + "/pc_data/val"
    cfg.data.matching_data_path = root + "/matching_data"
    for sub in (cfg.denoiser, cfg.verifier):
        sub.embed_dim, sub.num_layers, sub.num_heads = 32, 1, 2
    cfg.verifier.max_iters = 2
    cfg.inference.batch_size = 2
    cfg.inference.save_trajectories = False
    cfg.inference.save_breakdown = True
    cfg.trainer.output_dir = str(tmp_path / "out")
    _, den, ver = R.make_models(cfg)
    vq = VQVAE(32, 16, 25, 64, sa_npoints=(24, 12), sa_nsamples=(8, 8, 8))
    engine = R.build_engine_fn(cfg, "cpu", models=(vq, den, ver))
    agg = R.run_inference(cfg, engine=engine)
    out_dir = os.path.join(cfg.trainer.output_dir, cfg.trainer.experiment_name, "inference",
                           cfg.inference.inference_dir)
    assert os.listdir(out_dir) == ["breakdown.jsonl"]  # no trajectories were asked for
    recs = _read(out_dir)
    assert len(recs) == agg["num_samples"] == 3
    assert len({r["data_id"] for r in recs}) == 3  # every shape once
    assert np.mean([r["part_acc"] for r in recs]) == pytest.approx(agg["eval/part_acc"])
    assert sum(r["n_merged_pairs"] for r in recs) == agg["n_merged_pairs"]
    for r in recs:
        assert 3 <= r["num_parts"] <= 5
        assert len(r["acc_per_part"]) == len(r["ref_part"]) == len(r["part_scale"])
        assert len(r["part_scale"]) == r["num_parts"]
        assert r["part_acc"] == pytest.approx(np.mean(r["acc_per_part"]))
        assert r["n_iters"] in agg["n_iters"]


@pytest.mark.parametrize("entry", ["train", "load_frozen_encoder"])
def test_denoiser_trainer_refuses_precision_other_than_fp32(entry, tmp_path):
    """(Named from when it refused.) Under ``trainer.precision=bf16`` the denoiser trainer
    builds the bf16 denoiser and the bf16 frozen encoder and trains, the parameters fp32;
    the encoder's kernel-S weights stay fp32. Under fp32 both compute in fp32."""
    cfg = R.Config()
    cfg.trainer.precision = "bf16"
    if entry == "load_frozen_encoder":
        enc = ttrain.load_frozen_encoder(cfg, "cpu")
        assert enc.model.pn2.dtype is torch.bfloat16
        assert all(p.dtype == torch.float32 for p in enc.model.parameters())
        assert all(w.dtype == torch.float32 for layer in enc.w["sa1"] for w in layer)
        cfg.trainer.precision = "fp32"
        assert ttrain.load_frozen_encoder(cfg, "cpu").model.pn2.dtype is None
        return
    root = str(tmp_path)
    generate_dataset(root, num_shapes=2, seed=11, split="train", min_parts=2, max_parts=4,
                     n_points=1000)
    cfg.data.data_dir = cfg.data.data_val_dir = root + "/pc_data/train"
    cfg.data.batch_size, cfg.data.max_num_part = 2, 4
    cfg.denoiser.embed_dim, cfg.denoiser.num_layers, cfg.denoiser.num_heads = 32, 1, 2
    cfg.trainer.output_dir = root + "/out"
    state = ttrain.train(cfg, max_steps=1, device="cpu")
    assert state.step == 1 and state.model.dtype is torch.bfloat16
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
