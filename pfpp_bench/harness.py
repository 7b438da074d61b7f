"""What every driver shares: the set-up clock, the card, the program's configuration and
models, the weights, the module check, and the result's device record."""

from __future__ import annotations

import os
import sys
import time

import torch

from pfpp_bench.reference import params as ref_params

FORBIDDEN = ("jax", "jaxlib", "flax", "puzzlefusion_plusplus_tpu")
WEIGHT_SALTS = {"vqvae": 1, "denoiser": 2, "verifier": 3}


def process_start() -> float:
    """The wall-clock time this process started, from /proc (else now)."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def program_config(cfg: dict, batch: int = 1):
    """The program's ``Config`` at the configuration file's settings."""
    from puzzlefusion_plusplus_tpu_torch.utils.config import Config

    c = Config()
    for key in ("n_embeddings", "embedding_dim", "num_point", "num_dim", "local_decode_pts"):
        setattr(c.ae, key, cfg["vqvae"][key])
    for key in ("embed_dim", "num_layers", "num_heads", "num_dim", "multires", "dropout",
                "pe_dropout", "ddpm_train_steps"):
        setattr(c.denoiser, key, cfg["denoiser"][key])
    for key in ("embed_dim", "num_layers", "num_heads", "max_nodes", "num_features"):
        setattr(c.verifier, key, cfg["verifier"][key])
    if "engine" in cfg:
        c.verifier.max_iters = cfg["engine"]["max_iters"]
        c.verifier.threshold = cfg["engine"]["threshold"]
        c.denoiser.num_inference_steps = cfg["engine"]["num_inference_steps"]
    c.data.max_num_part = cfg["data"]["max_num_part"]
    c.data.part_bucket_multiple = cfg["data"].get("part_bucket_multiple", 0)
    c.inference.part_bucket_multiple = cfg["data"].get("part_bucket_multiple", 0)
    c.inference.batch_size = batch
    c.inference.save_trajectories = False
    c.trainer.precision = cfg["precision"]
    c.trainer.num_devices = 1
    if "train" in cfg:
        t = cfg["train"]
        c.data.batch_size = t["batch_size"]
        c.denoiser.lr, c.denoiser.weight_decay = t["lr"], t["weight_decay"]
        c.denoiser.b1, c.denoiser.b2 = t["betas"]
        c.denoiser.multiple_ref_parts = t["multiple_ref_parts"]
    return c


def specs(cfg: dict) -> dict:
    """Each model's parameter spec (``reference/params.py``)."""
    return {
        "vqvae": ref_params.vqvae_spec(cfg["vqvae"]),
        "denoiser": ref_params.denoiser_spec(cfg["denoiser"], cfg["denoiser"]["ddpm_train_steps"]),
        "verifier": ref_params.verifier_spec(cfg["verifier"]),
    }


def draw_weights(cfg: dict, seed: int, device, names=("vqvae", "denoiser", "verifier")) -> dict:
    """The seed's weights of each named model, drawn on ``device``."""
    sp = specs(cfg)
    return {n: ref_params.draw(sp[n], seed, device, WEIGHT_SALTS[n]) for n in names}


def load(module: torch.nn.Module, weights: dict) -> torch.nn.Module:
    """Copy ``weights`` into ``module``; every parameter must be among them."""
    missing, unexpected = module.load_state_dict(weights, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"weights do not fit {type(module).__name__}: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    return module


def program_models(cfg: dict, prog_cfg, device, names=("vqvae", "denoiser", "verifier")):
    """The program's modules, built on ``device``."""
    from puzzlefusion_plusplus_tpu_torch.models.denoiser import make_denoiser
    from puzzlefusion_plusplus_tpu_torch.models.verifier import VerifierTransformer
    from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE

    vq, vf = cfg["vqvae"], cfg["verifier"]
    out = {}
    with torch.device(device):
        if "vqvae" in names:
            out["vqvae"] = VQVAE(vq["n_embeddings"], vq["embedding_dim"], vq["num_point"],
                                 vq["num_dim"], vq["local_decode_pts"], tuple(vq["sa_npoints"]),
                                 tuple(vq["sa_nsamples"]))
        if "denoiser" in names:
            out["denoiser"] = make_denoiser(prog_cfg)
        if "verifier" in names:
            out["verifier"] = VerifierTransformer(vf["embed_dim"], vf["num_layers"],
                                                  vf["num_heads"], vf["max_nodes"],
                                                  vf["num_features"], vf["ff_dim"])
    return {k: m.to(device) for k, m in out.items()}


def device_record(device, count: int) -> dict:
    """The result's ``device``: the card's name, the cards used, the peak of this one."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)
