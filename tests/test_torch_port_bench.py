"""The port's benchmark entry (``python -m puzzlefusion_plusplus_tpu_torch.bench``) on the CPU.

Its measurement functions run at test widths (a small VQ-VAE, a 32-wide one-layer denoiser
and verifier, 2 agglomeration iterations) on 4 synthetic shapes of 3-5 parts, and print a
line that parses with every key the entry promises; ``--help`` exits 0 without touching
CUDA or building a kernel. The numbers themselves are taken on the card (``chip_smoke.py``
phase ``bench``)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from puzzlefusion_plusplus_tpu_torch import bench
from puzzlefusion_plusplus_tpu_torch.data import generate_dataset
from puzzlefusion_plusplus_tpu_torch.inference import run as R
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"device", "batch", "part_pad", "precision", "build_s",
        "p50_denoise_verify_iter_latency_s", "runs_s", "timing_suspect"}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    generate_dataset(root, num_shapes=4, seed=7, split="val", min_parts=3, max_parts=5,
                     n_points=96)
    cfg = bench.config(root, batch=2)
    cfg.data.max_num_part = 5
    for sub in (cfg.denoiser, cfg.verifier):
        sub.embed_dim, sub.num_layers, sub.num_heads = 32, 1, 2
    cfg.verifier.max_iters = 2
    _, den, ver = R.make_models(cfg)
    vq = VQVAE(32, 16, 25, 64, sa_npoints=(24, 12), sa_nsamples=(8, 8, 8))
    return root, cfg, (vq, den, ver)


@pytest.mark.parametrize("mode", ["default", "serving"])
def test_measurement_prints_a_line_with_every_key(small, mode, capsys):
    root, cfg, models = small
    if mode == "default":
        out = bench.measure(cfg, "cpu", root, batch=2, repeats=2, models=models)
        keys = KEYS
        assert out["metric"] == "assemblies_per_sec_per_chip"
        assert out["extra"]["batch"] == 2 and out["extra"]["part_pad"] in (4, 8)
    else:
        out = bench.measure_serving(cfg, "cpu", root, batch=2, repeats=1, models=models)
        keys = KEYS | {"pads", "part_counts", "warm_s", "n_shapes"}
        assert out["metric"] == "serving_assemblies_per_sec_full_set"
        assert out["extra"]["n_shapes"] == 4
        assert out["extra"]["part_counts"]["min"] >= 3
    print(json.dumps(out))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "vs_baseline", "extra"} <= set(line)
    assert keys <= set(line["extra"]), keys - set(line["extra"])
    assert line["unit"] == "assemblies/s" and line["value"] > 0
    assert line["extra"]["device"] == "cpu" and line["extra"]["precision"] == "fp32"
    assert len(line["extra"]["runs_s"]) == (2 if mode == "default" else 1)
    assert line["extra"]["timing_suspect"] is False  # a CPU engine call takes seconds
    assert np.isfinite(line["extra"]["p50_denoise_verify_iter_latency_s"])


def test_settings_read_the_environment():
    s = bench.settings({})
    assert s == {"batch": 8, "repeats": 3, "data": s["data"], "precision": "fp32",
                 "bucket": True}
    assert s["data"].endswith("pfpp_bench_data_torch")  # never the JAX bench's tree
    s = bench.settings({"PFPP_BENCH_REPEATS": "0", "PFPP_BENCH_BATCH": "2",
                        "PFPP_BENCH_PRECISION": "bf16", "PFPP_BENCH_BUCKET": "0",
                        "PFPP_BENCH_DATA": "/d"})
    assert s == {"batch": 2, "repeats": 1, "data": "/d", "precision": "bf16",
                 "bucket": False}


def test_help_exits_without_cuda_or_a_kernel_build():
    code = ("import sys, torch\n"
            "from puzzlefusion_plusplus_tpu_torch import bench\n"
            "from puzzlefusion_plusplus_tpu_torch.ops import cuda_build\n"
            "assert bench.main(['--help']) == 0\n"
            "assert not torch.cuda.is_initialized() and not cuda_build.build_seconds\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)
    out = subprocess.run([sys.executable, "-m", "puzzlefusion_plusplus_tpu_torch.bench",
                          "--help"], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "usage:" in out.stdout
