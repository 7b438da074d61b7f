"""The plain reference against the program at a tiny width on the CPU, and its TF32 control
failing the cells' limits."""

from __future__ import annotations

import torch

from pfpp_bench import harness, manifest, readings
from pfpp_bench.run import merge

CPU = torch.device("cpu")


def cell(name, over, w_over):
    b = manifest.benchmark()
    entry = manifest.cell(b, name)
    return (merge(manifest.workload(name), w_over),
            merge(manifest.config(b, entry["config"]), over))


def test_weights_fit_the_program_modules():
    b = manifest.benchmark()
    for cfg_name in ("pfpp_everyday_infer", "pfpp_everyday_denoiser_train"):
        cfg = manifest.config(b, cfg_name)
        prog = harness.program_models(cfg, harness.program_config(cfg), "meta")
        for name, spec in harness.specs(cfg).items():
            keys = {k: tuple(v.shape) for k, v in prog[name].state_dict().items()
                    if not k.endswith("num_batches_tracked")}
            assert keys == {n: tuple(s) for n, s, _, _ in spec}, name


def test_engine_follows_the_program(tiny):
    w, cfg = cell("engine_b8", *tiny["serve"])
    got = readings.program_reading(w, cfg, 3, CPU, 1)
    lim = w["check"]["limits"]
    assert got["pose_gap"] <= lim["pose_gap"] / 10 and got["mismatches"] == 0
    assert got["logit_gap"] <= lim["logit_gap"]


def test_training_follows_the_program(tiny):
    w, cfg = cell("denoiser_train_b64", *tiny["train"])
    got = readings.train_program_reading(w, cfg, 4, CPU, 1)
    for k, v in got.items():
        assert v <= w["check"]["limits"][k] / 3, (k, v)


def test_training_control_and_half_batch_fail(tiny):
    w, cfg = cell("denoiser_train_b64", *tiny["train"])
    got = readings.train_control_reading(w, cfg, 5, CPU, 1)
    lim = w["check"]["limits"]
    for kind in ("tf32", "half_batch"):
        assert any(got[f"{kind}.{k}"] > lim[k] for k in lim), (kind, got)


def test_engine_control_fails(tiny):
    # the control's gap grows with the width: the denoiser at its published width, the rest tiny
    over, w_over = tiny["serve"]
    over["denoiser"] = {"embed_dim": 512, "num_layers": 2, "num_heads": 8}
    w, cfg = cell("engine_b8", over, w_over)
    got = readings.control_reading(w, cfg, 6, CPU, 1)
    lim = w["check"]["limits"]
    assert any(got[k] > lim[k] for k in lim), got


def test_reference_rebuilds_the_loaders_batches(tmp_path):
    """The reference's epoch-0 batches equal the program's loader's: bit for bit where the
    loader runs the native host core, whose arithmetic ``recentre_rotate`` follows."""
    import numpy as np

    from pfpp_bench.reference.train import TrainData
    from pfpp_bench.traffic import shapes
    from puzzlefusion_plusplus_tpu_torch.data.datasets import DenoiserDataset
    from puzzlefusion_plusplus_tpu_torch.data.loader import Loader
    from puzzlefusion_plusplus_tpu_torch.utils import native

    shapes.write_train_set({"part_counts": [2, 5, 9, 20], "repeats": 2}, 3, 200,
                           str(tmp_path), 1).get()
    prog = next(iter(Loader(DenoiserDataset(str(tmp_path), mode="train"), 4, seed=77)))
    ref = TrainData(str(tmp_path), 20, True).batches(77, 4, 1)[0]
    tol = 0.0 if native.available() else 1e-5
    for k in ("part_pcs", "part_trans", "part_rots", "part_scale", "part_valids", "ref_part"):
        np.testing.assert_allclose(np.asarray(ref[k], np.float64),
                                   np.asarray(prog[k], np.float64), rtol=0, atol=tol)
