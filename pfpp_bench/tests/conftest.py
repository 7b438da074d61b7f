"""Tiny configurations for the benchmark's CPU tests, and the marker of card-only tests."""

from __future__ import annotations

import copy

import pytest

TINY_SERVE = {"vqvae": {"num_point": 8, "sa_npoints": [32, 16], "sa_nsamples": [8, 8, 8]},
              "denoiser": {"embed_dim": 32, "num_layers": 1, "num_heads": 2},
              "verifier": {"embed_dim": 32, "num_layers": 1, "num_heads": 2, "ff_dim": 64},
              "engine": {"max_iters": 2, "num_inference_steps": 2},
              "data": {"points_per_part": 128}}
TINY_SERVE_W = {"traffic": {"part_draw": {"low": 2, "high": 4, "shapes": 4}, "batch": 2},
                "check": {"calls": 2}}
TINY_TRAIN = {"vqvae": TINY_SERVE["vqvae"], "denoiser": TINY_SERVE["denoiser"],
              "data": {"points_per_part": 128}, "train": {"batch_size": 4}}
TINY_TRAIN_W = {"traffic": {"part_draw": {"low": 2, "high": 4, "shapes": 16}}}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU")


@pytest.fixture
def tiny():
    return copy.deepcopy({"serve": (TINY_SERVE, TINY_SERVE_W),
                          "train": (TINY_TRAIN, TINY_TRAIN_W)})
