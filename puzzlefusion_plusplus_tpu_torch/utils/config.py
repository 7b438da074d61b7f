"""Typed configuration system (dataclasses + dotted CLI overrides).

A copy of ``puzzlefusion_plusplus_tpu/utils/config.py``: the port keeps its own copy so that
it imports nothing from the JAX package. The two must keep the same fields and defaults.

Replaces the reference's Hydra YAML tree (config/ — see SURVEY.md §2.1 #30) with one typed,
introspectable config surface. Every tunable the reference exposes is a field here with the same
default:
  * AE: codebook 1024x16, 25 tokens x 64 dims, 40 decode points (config/ae/vq_vae.yaml:5-9)
  * Denoiser: 512 dims / 6 layers / 8 heads, DDPM 1000 train -> 20 inference steps, piecewise
    schedule, epsilon prediction, leading spacing (config/denoiser/model.yaml:8-25)
  * Verifier: 256 dims / 6 layers / 8 heads, threshold 0.9, max_iters 6
    (config/verifier/model.yaml, config/auto_aggl.yaml:26-29)
  * Trainer: epochs / batch sizes / lr / schedules (config/*/global_config.yaml)

Override UX matches Hydra's dotted CLI syntax: ``python -m ... data.batch_size=8 model.lr=1e-4``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass
class DataConfig:
    data_dir: str = "pc_data/everyday/train"
    data_val_dir: str = "pc_data/everyday/val"
    matching_data_path: str = "matching_data/everyday"
    verifier_data_path: str = "verifier_data/everyday"
    save_pc_data_path: str = "pc_data/everyday"
    mesh_data_dir: str = "breaking_bad"
    category: str = "everyday"
    batch_size: int = 64
    val_batch_size: int = 64
    num_workers: int = 6
    max_num_part: int = 20
    min_num_part: int = 2
    num_pc_points: int = 1000
    overfit: int = -1
    # fixed-shape pads for the test-time matching data (reference keeps these ragged host-side;
    # we pad so the whole inference engine stays jit-compiled — SURVEY.md §7.1)
    max_area_points: int = 5000
    max_correspondences: int = 256
    # TRAINING-side part-count bucketing (data/bucketing.py): batches are formed within
    # part-count buckets and each served at its bucket's pad (one XLA specialization per
    # pad). 0 disables (reference-parity default: every batch at the max_num_part pad).
    part_bucket_multiple: int = 0


@dataclass
class VQVAEConfig:
    n_embeddings: int = 1024
    embedding_dim: int = 16
    num_point: int = 25  # latent tokens per part
    num_dim: int = 64  # latent channels
    local_decode_pts: int = 40
    beta: float = 0.25
    lr: float = 5e-4
    weight_decay: float = 1e-6
    lr_milestones: tuple = (200, 400)  # MultiStepLR epochs (config/ae/model.yaml)
    lr_gamma: float = 0.5
    epochs: int = 2000
    ckpt_path: str = ""


@dataclass
class DenoiserConfig:
    embed_dim: int = 512
    num_layers: int = 6
    num_heads: int = 8
    num_point: int = 25
    num_dim: int = 64
    multires: int = 10
    dropout: float = 0.2
    pe_dropout: float = 0.1
    ddpm_train_steps: int = 1000
    num_inference_steps: int = 20
    # sample training timesteps from the num_inference_steps leading timesteps instead of
    # U[0, ddpm_train_steps): inference only ever evaluates those rows of the per-timestep
    # AdaLN table, and concentrating training there reaches the part-acc bar orders of
    # magnitude sooner (VALIDATION.md overfit proof). False = reference behavior.
    train_on_inference_timesteps: bool = False
    # Frozen-encoder forward in the train step via the geometry-cache + rotation-folding
    # path (the engine's fast path; fused Pallas SA kernels on TPU). Semantically equal to
    # rotate-then-encode (rotation commutes with FPS/ball-query/gather). MEASURED NEGATIVE
    # for training (184 vs 174 ms/step at b64 P=8, VALIDATION.md r3): without the engine's
    # 20-step amortization the per-step geometry build eats the fused kernels' win. Kept as
    # an option; default stays on the composable path.
    train_encode_cached: bool = False
    multiple_ref_parts: bool = True
    lr: float = 2e-4
    b1: float = 0.95
    b2: float = 0.999
    weight_decay: float = 1e-6
    epochs: int = 2000
    val_every: int = 100
    ckpt_path: str = ""
    encoder_ckpt_path: str = ""


@dataclass
class VerifierConfig:
    embed_dim: int = 256
    num_layers: int = 6
    num_heads: int = 8
    max_nodes: int = 20
    num_features: int = 7
    threshold: float = 0.9
    max_iters: int = 6
    negative_weight: float = 0.2  # BCE class weight on negatives (verifier.py:27)
    lr: float = 2e-4
    b1: float = 0.95
    b2: float = 0.999
    weight_decay: float = 1e-6
    epochs: int = 100
    ckpt_path: str = ""


@dataclass
class TrainerConfig:
    seed: int = 123
    log_every: int = 50
    ckpt_every_epochs: int = 100
    ckpt_top_k: int = 3
    # rank top-k on the trailing mean of the last k raw evals (1 = raw; denoiser uses this
    # because 32-shape part_acc evals swing +-0.05 between adjacent evals — VERDICT r4 #5)
    ckpt_smooth_k: int = 3
    output_dir: str = "output"
    experiment_name: str = "everyday"
    precision: str = "fp32"  # or "bf16" for bfloat16 matmuls
    num_devices: int = -1  # -1 = all local devices (data parallel)


@dataclass
class InferenceConfig:
    inference_dir: str = "results"
    save_trajectories: bool = True
    # append one JSONL record per shape (per-part correctness, ref mask, part scales) to
    # <out_dir>/breakdown.jsonl for offline failure analysis (scripts/engine_breakdown.py)
    save_breakdown: bool = False
    batch_size: int = 1  # shapes per device-step; vmapped/sharded on TPU
    # part-count bucketing (data/bucketing.py): serve each batch at the smallest multiple-of-
    # this part pad that fits its shapes (one extra XLA specialization per distinct pad).
    # 0 disables (always the global max_num_part pad).
    part_bucket_multiple: int = 4


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    ae: VQVAEConfig = field(default_factory=VQVAEConfig)
    denoiser: DenoiserConfig = field(default_factory=DenoiserConfig)
    verifier: VerifierConfig = field(default_factory=VerifierConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)


def _coerce(value: str, current: Any) -> Any:
    """Parse a CLI string against the type of the current value."""
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        return tuple(json.loads(value))
    return value


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply Hydra-style ``a.b.c=value`` overrides in place. Unknown keys raise."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, value = ov.split("=", 1)
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if not hasattr(obj, p):
                raise KeyError(f"unknown config section {p!r} in {key!r}")
            obj = getattr(obj, p)
        leaf = parts[-1]
        if not dataclasses.is_dataclass(obj) or not hasattr(obj, leaf):
            raise KeyError(f"unknown config key {key!r}")
        setattr(obj, leaf, _coerce(value, getattr(obj, leaf)))
    return cfg


def config_from_argv(argv: list[str]) -> Config:
    return apply_overrides(Config(), [a for a in argv if "=" in a])


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)
