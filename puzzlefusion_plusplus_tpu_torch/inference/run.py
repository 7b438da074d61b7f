"""Inference entry point (port of ``puzzlefusion_plusplus_tpu/inference/run.py``).

``python -m puzzlefusion_plusplus_tpu_torch.inference.run data.data_val_dir=...
data.matching_data_path=...`` runs the engine over a test set on the GPU (``--cpu`` for the
CPU), prints the mean metrics and writes the renderer artifacts in the JAX package's format
(per sample ``predict_{acc}.npy``, ``gt.npy``, ``init_pose.npy``, ``mesh_file_path.txt``) and,
with ``inference.save_breakdown``, one ``breakdown.jsonl`` record per shape.

The weights come from the checkpoints that ``denoiser.encoder_ckpt_path``,
``denoiser.ckpt_path`` and ``verifier.ckpt_path`` name: the port's own (``state.pt`` under a
``step_N`` dir, a ckpt dir for its best, ``.../best`` or ``.../latest``) or the original
repo's Lightning ``.ckpt`` files (``training/state.py::load_model_state``). The JAX package's
orbax checkpoints are converted first by ``scripts/jax_ckpt_to_torch.py``. A key left empty
keeps the weights drawn from ``trainer.seed``. Callers holding flax weights may also pass
them converted (``convert/from_jax.py``) as ``state_dicts``. ``PFPP_SA_GATHER=int8``, read
when the engine is built, quantizes the encoder's SA2 and SA3 feature projections to 8 bits
(kernel S's int8 mode, ``ops/sa_fused.py``), as it does in the JAX package.

``trainer.num_devices`` above 1 serves data-parallel (``parallel/``), as the JAX entry shards
each batch over its mesh: every rank takes the same bucket-sliced global batch, padded to a
multiple of the world size by repeating row 0, and the noise of the whole batch drawn from
the one seeded generator; each runs the engine on its rows, the ranks leave the loop
together, and rank 0 gathers the rows in order, drops the padding and alone writes the
artifacts. Per-shape results do not depend on the world size.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from puzzlefusion_plusplus_tpu_torch.data.bucketing import part_bucket, slice_batch_parts
from puzzlefusion_plusplus_tpu_torch.data.datasets import DenoiserDataset
from puzzlefusion_plusplus_tpu_torch.data.loader import Loader
from puzzlefusion_plusplus_tpu_torch.inference.engine import (
    AgglConfig,
    auto_agglomerate_batch,
    draw_noise,
)
from puzzlefusion_plusplus_tpu_torch.inference.sampler import FrozenEncoder
from puzzlefusion_plusplus_tpu_torch.models.denoiser import compute_dtype, make_denoiser
from puzzlefusion_plusplus_tpu_torch.models.scheduler import DDPMParams
from puzzlefusion_plusplus_tpu_torch.models.verifier import VerifierTransformer
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE
from puzzlefusion_plusplus_tpu_torch.parallel import launch, mesh
from puzzlefusion_plusplus_tpu_torch.training.state import load_model_state
from puzzlefusion_plusplus_tpu_torch.utils import profiling
from puzzlefusion_plusplus_tpu_torch.utils.config import Config, config_from_argv
from puzzlefusion_plusplus_tpu_torch.utils.metrics import assembly_metrics

SAMPLE_KEYS = (
    "part_pcs", "part_trans", "part_rots", "part_scale", "part_valids", "ref_part",
    "num_parts", "area_pts", "n_area", "match_edges", "match_edge_valid",
    "corr_src", "corr_tgt", "corr_count",
)
METRIC_KEYS = ("part_acc", "part_acc_nonref", "shape_cd", "rmse_r", "rmse_t")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``cuda`` unless the caller asks for the CPU; raises when CUDA is absent. Also turns
    TF32 off: the part_acc CD < 0.01 bar and the 1e-3 interpenetration cutoff sit close to
    TF32's error, and the JAX reference computes in full float32. bf16 products accumulate
    in fp32 (no reduced-precision split-K), as the JAX package's do."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' (--cpu on the "
                           "command line) to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return device


def make_models(cfg: Config):
    """(vqvae, denoiser, verifier) at cfg's widths, with weights drawn from trainer.seed and
    then loaded from each checkpoint that cfg names (``load_model_state``). Under
    ``trainer.precision=bf16`` the denoiser and the VQ-VAE's composable encode compute in
    bf16 with fp32 parameters, as the JAX entry builds them; the engine's cached encode
    (kernel S) keeps its fp32 folded weights, as on the TPU."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.trainer.seed)
        vqvae = VQVAE(cfg.ae.n_embeddings, cfg.ae.embedding_dim, cfg.ae.num_point,
                      cfg.ae.num_dim, cfg.ae.local_decode_pts).with_dtype(compute_dtype(cfg))
        denoiser = make_denoiser(cfg)
        verifier = VerifierTransformer(cfg.verifier.embed_dim, cfg.verifier.num_layers,
                                       cfg.verifier.num_heads, cfg.verifier.max_nodes,
                                       cfg.verifier.num_features)
    if cfg.denoiser.encoder_ckpt_path:
        # the denoiser trainer's loader (imported here: that module imports this one)
        from puzzlefusion_plusplus_tpu_torch.training.denoiser import load_frozen_encoder

        vqvae = load_frozen_encoder(cfg, "cpu").model
    if cfg.denoiser.ckpt_path:
        denoiser.load_state_dict(load_model_state(cfg.denoiser.ckpt_path, "denoiser"))
    if cfg.verifier.ckpt_path:
        verifier.load_state_dict(load_model_state(cfg.verifier.ckpt_path, "verifier"))
    return vqvae, denoiser, verifier


def agg_config(cfg: Config) -> AgglConfig:
    return AgglConfig(
        max_iters=cfg.verifier.max_iters,
        num_inference_steps=cfg.denoiser.num_inference_steps,
        threshold=cfg.verifier.threshold,
        # the lowmem normals avoid the [*, K, 3] neighbourhood temporaries at large batch
        normals_method="lowmem" if cfg.inference.batch_size >= 16 else "analytic",
        noise_parts=cfg.data.max_num_part,
    )


def build_engine_fn(cfg: Config, device=None, state_dicts: dict | None = None,
                    models=None):
    """-> ``engine(batch, noise=None, generator=None) -> dict`` of numpy results.

    ``state_dicts``: optional {"vqvae", "denoiser", "verifier"} weights; ``models``:
    optional prebuilt (vqvae, denoiser, verifier) modules, e.g. at test widths. Inside a
    process group the engine is a collective: every rank calls it, each on its rows."""
    device = resolve_device(device)
    vqvae, denoiser, verifier = models if models is not None else make_models(cfg)
    for name, mod in (("vqvae", vqvae), ("denoiser", denoiser), ("verifier", verifier)):
        if state_dicts and name in state_dicts:
            mod.load_state_dict(state_dicts[name])
        mod.to(device).eval()
    encoder = FrozenEncoder(vqvae)
    ddpm = DDPMParams.piecewise(cfg.denoiser.ddpm_train_steps)
    acfg = agg_config(cfg)

    @torch.inference_mode()
    def engine(batch: dict, noise=None, generator=None) -> dict:
        with profiling.span("pfpp.engine.call", request=True):
            t = {k: torch.as_tensor(np.asarray(batch[k]), device=device) for k in SAMPLE_KEYS}
            out = auto_agglomerate_batch(denoiser, verifier, encoder, ddpm, t, acfg,
                                         noise=noise, generator=generator,
                                         all_done=mesh.all_ranks)
            pts = t["part_pcs"] * t["part_scale"][..., None]  # original local clouds
            res = {
                **assembly_metrics(pts, out["pred_trans"], out["pred_rots"], t["part_trans"],
                                   t["part_rots"], t["part_valids"], t["ref_part"]),
                "trajectory": out["trajectory"],
                "n_merged_pairs": out["final_state"].adj.sum((-1, -2)) // 2,
                "n_iters": torch.full_like(t["num_parts"], out["n_iters"]),
            }
            return profiling.sync("pfpp.sync.results", res)

    engine.device = device
    engine.sa_gather = encoder.sa_gather  # kernel S's gather mode, PFPP_SA_GATHER at build
    return engine


def save_inference_artifacts(out_dir: str, batch: dict, results: dict) -> None:
    """Per-sample renderer artifacts, the JAX package's format."""
    traj = np.asarray(results["trajectory"])  # [B, T, P, 7]
    for i in range(results["part_acc"].shape[0]):
        save_dir = os.path.join(out_dir, str(int(batch["data_id"][i])))
        os.makedirs(save_dir, exist_ok=True)
        mask = np.asarray(batch["part_valids"][i]) == 1
        acc = float(results["part_acc"][i])
        np.save(os.path.join(save_dir, f"predict_{acc}.npy"), traj[i][:, mask])
        gt = np.concatenate(
            [np.asarray(batch["part_trans"][i]), np.asarray(batch["part_rots"][i])], -1
        )[mask]
        np.save(os.path.join(save_dir, "gt.npy"), gt)
        init_pose = np.concatenate(
            [np.asarray(batch["init_pose_t"][i]), np.asarray(batch["init_pose_r"][i])], -1
        )
        np.save(os.path.join(save_dir, "init_pose.npy"), init_pose)
        with open(os.path.join(save_dir, "mesh_file_path.txt"), "w") as f:
            f.write(str(batch["mesh_file_path"][i]))


def save_breakdown_records(out_dir: str, batch: dict, results: dict, n_real: int) -> None:
    """Append one JSONL record per shape to ``<out_dir>/breakdown.jsonl``: per-part
    correctness, the ref mask and part scales over the valid parts, the merged pairs and the
    iterations (the JAX package's format; scripts/engine_breakdown.py aggregates it)."""
    os.makedirs(out_dir, exist_ok=True)
    valids = np.asarray(batch["part_valids"])[:n_real]
    ref = np.asarray(batch["ref_part"])[:n_real].astype(bool)
    per_part = np.asarray(results["acc_per_part"]).astype(bool)
    scales = np.asarray(batch["part_scale"])[:n_real].reshape(n_real, -1)
    with open(os.path.join(out_dir, "breakdown.jsonl"), "a") as fh:
        for i in range(n_real):
            m = valids[i] == 1
            fh.write(json.dumps({
                "data_id": int(np.asarray(batch["data_id"])[i]),
                "num_parts": int(m.sum()),
                "part_acc": float(results["part_acc"][i]),
                "part_acc_nonref": float(results["part_acc_nonref"][i]),
                "acc_per_part": per_part[i][m].astype(int).tolist(),
                "ref_part": ref[i][m].astype(int).tolist(),
                "part_scale": [round(float(s), 5) for s in scales[i][m]],
                "n_merged_pairs": int(np.asarray(results["n_merged_pairs"])[i]),
                "n_iters": int(np.asarray(results["n_iters"])[i]),
            }) + "\n")


def run_inference(cfg: Config, device=None, max_batches: int | None = None,
                  engine=None, join_timeout_s: float | None = None) -> dict:
    """Serve the test set in part-count-sorted, bucketed batches -> mean metrics. On
    ``trainer.num_devices`` above 1 it spawns the ranks (``parallel/launch.py::entry``;
    ``join_timeout_s`` bounds their run) and returns rank 0's result; inside a process group
    every rank returns the same result."""
    device = resolve_device(engine.device if engine is not None else device)
    if engine is None:
        spawned = launch.entry(run_inference, (cfg, device, max_batches),
                               cfg.trainer.num_devices, device, join_timeout_s=join_timeout_s)
        if spawned is not launch.HERE:
            return spawned
        engine = build_engine_fn(cfg, device)
    elif launch.needs_spawn(mesh.world_size(cfg.trainer.num_devices, device)):
        raise ValueError("a prebuilt engine serves in this process only: pass "
                         "trainer.num_devices=1, or no engine")
    ds = DenoiserDataset(
        cfg.data.data_val_dir, mode="test", matching_data_path=cfg.data.matching_data_path,
        max_num_part=cfg.data.max_num_part, overfit=cfg.data.overfit,
    )
    bucket_mult = cfg.inference.part_bucket_multiple
    order = (
        np.argsort(ds.num_parts_list(), kind="stable") if bucket_mult and len(ds) else None
    )
    loader = Loader(ds, cfg.inference.batch_size, shuffle=False, drop_last=False,
                    seed=cfg.trainer.seed, order=order)
    out_dir = os.path.join(cfg.trainer.output_dir, cfg.trainer.experiment_name, "inference",
                           cfg.inference.inference_dir)
    acfg = agg_config(cfg)
    generator = torch.Generator(device=engine.device).manual_seed(cfg.trainer.seed)
    rank, world = mesh.rank(), mesh.world()
    metrics: dict[str, list] = {k: [] for k in METRIC_KEYS + ("n_merged_pairs", "n_iters")}
    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        if bucket_mult:
            P_b = part_bucket(int(np.max(batch["num_parts"])), bucket_mult,
                              cap=cfg.data.max_num_part)
            batch = slice_batch_parts(batch, P_b)
        sample = {k: np.asarray(batch[k]) for k in SAMPLE_KEYS}
        n_real, P = sample["part_valids"].shape
        # the real rows' noise, as one process draws it; the padding rows repeat row 0's
        init, steps = draw_noise(acfg, n_real, P, generator, engine.device)
        padded = mesh.pad_batch_to_devices(sample, world)[0]
        b = len(padded["part_valids"]) // world
        src = torch.cat([torch.arange(n_real), torch.zeros(b * world - n_real, dtype=torch.long)])
        rows = src[rank * b:(rank + 1) * b].to(engine.device)
        results = engine(mesh.shard_batch(padded, rank, world), noise=(init[rows], steps[:, rows]))
        results = mesh.gather_rows(results, n_real)
        for name in metrics:
            metrics[name].extend(np.asarray(results[name]).tolist())
        if cfg.inference.save_trajectories and mesh.is_main():
            save_inference_artifacts(out_dir, batch, results)
        if cfg.inference.save_breakdown and mesh.is_main():
            save_breakdown_records(out_dir, batch, results, n_real)
    agg = {f"eval/{k}": float(np.mean(metrics[k])) for k in METRIC_KEYS if metrics[k]}
    agg["num_samples"] = len(metrics["part_acc"])
    agg["n_merged_pairs"] = int(np.sum(metrics["n_merged_pairs"]))
    agg["n_iters"] = metrics["n_iters"]
    return agg


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cfg = config_from_argv(argv)
    print(run_inference(cfg, device="cpu" if "--cpu" in argv else None))


if __name__ == "__main__":
    main()
