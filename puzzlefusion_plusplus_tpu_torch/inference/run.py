"""Inference entry point (port of ``puzzlefusion_plusplus_tpu/inference/run.py``).

``python -m puzzlefusion_plusplus_tpu_torch.inference.run data.data_val_dir=...
data.matching_data_path=...`` runs the engine over a test set on the GPU (``--cpu`` for the
CPU), prints the mean metrics and writes the renderer artifacts in the JAX package's format
(per sample ``predict_{acc}.npy``, ``gt.npy``, ``init_pose.npy``, ``mesh_file_path.txt``).

Loading the orbax checkpoints that ``*.ckpt_path`` name waits for a later slice; without
them the port initialises its weights from ``trainer.seed``. Callers holding flax weights
pass them converted (``convert/from_jax.py``) as ``state_dicts``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from puzzlefusion_plusplus_tpu_torch.data.bucketing import part_bucket, slice_batch_parts
from puzzlefusion_plusplus_tpu_torch.data.datasets import DenoiserDataset
from puzzlefusion_plusplus_tpu_torch.data.loader import Loader
from puzzlefusion_plusplus_tpu_torch.inference.engine import AgglConfig, auto_agglomerate_batch
from puzzlefusion_plusplus_tpu_torch.inference.sampler import FrozenEncoder
from puzzlefusion_plusplus_tpu_torch.models.denoiser import DenoiserTransformer
from puzzlefusion_plusplus_tpu_torch.models.scheduler import DDPMParams
from puzzlefusion_plusplus_tpu_torch.models.verifier import VerifierTransformer
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE
from puzzlefusion_plusplus_tpu_torch.utils.config import Config, config_from_argv
from puzzlefusion_plusplus_tpu_torch.utils.metrics import (
    calc_part_acc,
    calc_shape_cd,
    rot_metrics,
    trans_metrics,
)

SAMPLE_KEYS = (
    "part_pcs", "part_trans", "part_rots", "part_scale", "part_valids", "ref_part",
    "num_parts", "area_pts", "n_area", "match_edges", "match_edge_valid",
    "corr_src", "corr_tgt", "corr_count",
)
METRIC_KEYS = ("part_acc", "part_acc_nonref", "shape_cd", "rmse_r", "rmse_t")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``cuda`` unless the caller asks for the CPU; raises when CUDA is absent. Also turns
    TF32 off: the part_acc CD < 0.01 bar and the 1e-3 interpenetration cutoff sit close to
    TF32's error, and the JAX reference computes in full float32."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' (--cpu on the "
                           "command line) to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def make_models(cfg: Config):
    """(vqvae, denoiser, verifier) at cfg's widths, with weights drawn from trainer.seed."""
    if cfg.denoiser.ckpt_path or cfg.verifier.ckpt_path or cfg.denoiser.encoder_ckpt_path:
        raise NotImplementedError("orbax checkpoints are not loaded by the port yet; "
                                  "pass converted state_dicts instead")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.trainer.seed)
        vqvae = VQVAE(cfg.ae.n_embeddings, cfg.ae.embedding_dim, cfg.ae.num_point,
                      cfg.ae.num_dim, cfg.ae.local_decode_pts)
        denoiser = DenoiserTransformer(
            cfg.denoiser.embed_dim, cfg.denoiser.num_layers, cfg.denoiser.num_heads,
            cfg.denoiser.num_dim, cfg.data.max_num_part, cfg.denoiser.multires,
            num_ada_embeds=max(6 * cfg.denoiser.embed_dim, cfg.denoiser.ddpm_train_steps),
        )
        verifier = VerifierTransformer(cfg.verifier.embed_dim, cfg.verifier.num_layers,
                                       cfg.verifier.num_heads, cfg.verifier.max_nodes,
                                       cfg.verifier.num_features)
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
    optional prebuilt (vqvae, denoiser, verifier) modules, e.g. at test widths."""
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
        t = {k: torch.as_tensor(np.asarray(batch[k]), device=device) for k in SAMPLE_KEYS}
        out = auto_agglomerate_batch(denoiser, verifier, encoder, ddpm, t, acfg,
                                     noise=noise, generator=generator)
        pts = t["part_pcs"] * t["part_scale"][..., None]  # original local clouds
        gt_trans, gt_rots, valids = t["part_trans"], t["part_rots"], t["part_valids"]
        acc, acc_per_part, _ = calc_part_acc(pts, out["pred_trans"], gt_trans,
                                             out["pred_rots"], gt_rots, valids)
        shape_cd = calc_shape_cd(pts, out["pred_trans"], gt_trans, out["pred_rots"],
                                 gt_rots, valids)
        # ref parts are pinned to GT; nonref excludes those give-away parts (all-ref -> 1)
        nonref = (valids == 1) & ~t["ref_part"].bool()
        n_nonref = nonref.sum(-1)
        acc_nonref = torch.where(
            n_nonref > 0, (acc_per_part & nonref).sum(-1) / n_nonref.clamp_min(1),
            torch.ones_like(acc),
        )
        res = {
            "part_acc": acc, "part_acc_nonref": acc_nonref, "shape_cd": shape_cd,
            "rmse_r": rot_metrics(out["pred_rots"], gt_rots, valids, "rmse"),
            "rmse_t": trans_metrics(out["pred_trans"], gt_trans, valids, "rmse"),
            "acc_per_part": acc_per_part,
            "trajectory": out["trajectory"],
            "n_merged_pairs": out["final_state"].adj.sum((-1, -2)) // 2,
            "n_iters": torch.full_like(n_nonref, out["n_iters"]),
        }
        return {k: v.cpu().numpy() for k, v in res.items()}

    engine.device = device
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


def run_inference(cfg: Config, device=None, max_batches: int | None = None,
                  engine=None) -> dict:
    """Serve the test set in part-count-sorted, bucketed batches -> mean metrics."""
    engine = engine or build_engine_fn(cfg, device)
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
    generator = torch.Generator(device=engine.device).manual_seed(cfg.trainer.seed)
    metrics: dict[str, list] = {k: [] for k in METRIC_KEYS + ("n_merged_pairs", "n_iters")}
    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        if bucket_mult:
            P_b = part_bucket(int(np.max(batch["num_parts"])), bucket_mult,
                              cap=cfg.data.max_num_part)
            batch = slice_batch_parts(batch, P_b)
        results = engine(batch, generator=generator)
        for name in metrics:
            metrics[name].extend(np.asarray(results[name]).tolist())
        if cfg.inference.save_trajectories:
            save_inference_artifacts(out_dir, batch, results)
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
