#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each printing one JSON object per line (with its seconds):
  1. build   — compiles the port's CUDA kernels (``puzzlefusion_plusplus_tpu_torch/csrc``)
               for sm_90a; prints the card's name and power limit from nvidia-smi.
  2. kernels — every kernel of the inference path (S, F, G, N, M) at the shapes the main
               path gives it, on seeded inputs, against its plain PyTorch version on the card:
               error, exact-index agreement, and CUDA-event times of the kernel, the plain
               version and (where one exists) a single PyTorch library call.
  3. engine  — the full-width engine (``Config()`` defaults: VQ-VAE 1000 pts / 25x64 tokens /
               1024x16 codebook, denoiser 512/6/8, verifier 256/6/8, 6 iterations x 20 steps,
               fp32, batch 8) on 8 synthetic shapes of 3-12 parts (seed 7) through
               ``build_engine_fn`` + ``run_inference``, with seeded random weights.
  4. merge   — a forced-merge batch (2 shapes, no reference part, verifier threshold 0): every
               valid edge is predicted, so parts merge and kernel M and the merge FPS run.
               The same batch and noise also go through the CPU engine (plain versions);
               discrete outcomes must agree and poses stay within 1e-3 (damped denoiser
               weights keep the 20-step recurrence contractive, as tests/test_bucketing.py).
  5. profile — torch.profiler over one more full-width engine call: self device time grouped
               into the port's kernels, matrix products and the rest, and the busy share.
The kernel launch counts are reset right before phase 3's second (counted) engine call and
read right after phase 4's GPU run: that run is the main path. Then a ``kernels`` line lists
every kernel with those counts, its error
and its times, and the last line is ``{"ok": true, "device": {...}}``. Any failure raises and
the script exits non-zero without that line. Needs one CUDA card; ``--phases`` picks phases.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H100_FP32_FLOPS = 67e12  # FP32 outside the tensor cores, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12
REPLACES = {
    "S": ("puzzlefusion_plusplus_tpu_torch/csrc/sa_cached.cu",
          "puzzlefusion_plusplus_tpu/ops/sa_fused_pallas.py:271"),
    "F": ("puzzlefusion_plusplus_tpu_torch/csrc/fps.cu",
          "puzzlefusion_plusplus_tpu/ops/fps.py:104"),
    "G": ("puzzlefusion_plusplus_tpu_torch/csrc/gather.cu",
          "puzzlefusion_plusplus_tpu/ops/gather_pallas.py:55"),
    "N": ("puzzlefusion_plusplus_tpu_torch/csrc/nn.cu",
          "puzzlefusion_plusplus_tpu/ops/chamfer_pallas.py:68"),
    "M": ("puzzlefusion_plusplus_tpu_torch/csrc/nn.cu",
          "puzzlefusion_plusplus_tpu/ops/chamfer_pallas.py:163"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------------------- phases


def phase_build() -> None:
    from puzzlefusion_plusplus_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all()
    for name in cuda_build.SIGNATURES:
        cuda_build.library(name)
    ptxas = {}
    for name in cuda_build.SIGNATURES:
        path = os.path.join(cuda_build.BUILD_DIR, f"{name}.log")
        if os.path.exists(path):
            with open(path) as fh:
                ptxas[name] = [l.strip() for l in fh if "registers" in l or "spill" in l]
    card = card_line()
    print(card, flush=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": cuda_build.build_seconds, "card": card, "ptxas": ptxas})


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_kernels(results: dict) -> None:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from puzzlefusion_plusplus_tpu_torch.ops import chamfer, fps, gather, sa_fused

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def record(name, shape, err, ms, plain_ms, nbytes, flops, library_ms=None, **extra):
        b_ms, b_by = bound(nbytes, flops)
        row = {"phase": "kernels", "kernel": name, "shape": shape, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": library_ms, **extra}
        emit(row)
        results.setdefault(name, []).append(row)

    # S: the three SA stages of one denoise step at M = 96 clouds (b8 x P12)
    M = 96
    for stage, (S, K, N2, D, C1, C2, C3) in {
        "SA1": (256, 32, 0, 0, 64, 64, 128),
        "SA2": (128, 64, 256, 128, 128, 128, 256),
        "SA3": (25, 64, 128, 256, 256, 256, 512),
    }.items():
        t0 = time.perf_counter()
        g = randn(M, S, K, 3, scale=0.1)
        w_eff = randn(M, 3, C1, scale=3 ** -0.5)
        feats = randn(M, N2, D).relu() if D else None
        gidx = (torch.randint(0, N2, (M, S, K), generator=gen, device=dev, dtype=torch.int32)
                if D else None)
        k1f = randn(D, C1, scale=D ** -0.5) if D else None
        b1, b2, b3 = randn(C1, scale=0.1), randn(C2, scale=0.1), randn(C3, scale=0.1)
        w2, w3 = randn(C1, C2, scale=C1 ** -0.5), randn(C2, C3, scale=C2 ** -0.5)
        args = (g, w_eff, feats, gidx, k1f, b1, w2, b2, w3, b3)
        out = sa_fused.sa_stage_fused_cached(*args)
        proj = None if feats is None else torch.matmul(feats, k1f)
        ref = sa_fused.sa_stage_plain(g, w_eff, proj, gidx, b1, w2, b2, w3, b3)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
        _check(rel <= 1e-4, f"S {stage}: relative error {rel}")
        flops = 2 * M * S * K * (3 * C1 + C1 * C2 + C2 * C3) + 2 * M * N2 * D * C1
        nbytes = 4 * (g.numel() + w_eff.numel() + (feats.numel() + gidx.numel()
                      + k1f.numel() if D else 0) + C1 + C1 * C2 + C2 + C2 * C3 + C3
                      + M * S * C3)
        record("S", stage, err,
               cuda_ms(lambda: sa_fused.sa_stage_fused_cached(*args), 20),
               cuda_ms(lambda: sa_fused.sa_stage_plain(
                   g, w_eff, None if feats is None else torch.matmul(feats, k1f), gidx, b1,
                   w2, b2, w3, b3), 3),
               nbytes, flops, max_rel_err=rel, seconds=time.perf_counter() - t0)

    # F: the cache build's first stage and the merge resample (partial mask)
    for B, N, npoint, masked in ((96, 1000, 256, False), (10, 20000, 1000, True)):
        t0 = time.perf_counter()
        xyz = randn(B, N, 3)
        mask = (torch.rand((B, N), generator=gen, device=dev) < 0.6) if masked else None
        out = fps.farthest_point_sample(xyz, npoint, mask)
        ref = fps.farthest_point_sample_plain(xyz, npoint, mask)
        match = bool(torch.equal(out, ref))
        _check(match, f"F [{B},{N}]->{npoint}: indices differ")
        if masked:
            _check(bool(mask.gather(1, out.long()).all()), "F picked a masked point")
        nbytes = 4 * B * N * 3 + (B * N if masked else 0) + 4 * B * npoint
        record("F", f"[{B},{N}]->{npoint}" + (" masked" if masked else ""), 0.0,
               cuda_ms(lambda: fps.farthest_point_sample(xyz, npoint, mask), 3),
               cuda_ms(lambda: fps.farthest_point_sample_plain(xyz, npoint, mask), 1),
               nbytes, 9.0 * B * N * npoint, indices_equal=match,
               seconds=time.perf_counter() - t0)

    # G: the largest grouping gather of the cache build (SA1 neighbourhoods)
    t0 = time.perf_counter()
    pts = randn(96, 1000, 3)
    idx = torch.randint(0, 1000, (96, 256, 32), generator=gen, device=dev, dtype=torch.int32)
    out = gather.gather_points(pts, idx)
    ref = gather.gather_points_plain(pts, idx)
    match = bool(torch.equal(out, ref))
    _check(match, "G: gathered values differ")
    bidx = torch.arange(96, device=dev)[:, None, None]
    idx64 = idx.long()
    record("G", "[96,1000,3] by [96,256,32]", 0.0,
           cuda_ms(lambda: gather.gather_points(pts, idx), 50),
           cuda_ms(lambda: gather.gather_points_plain(pts, idx), 20),
           4 * (idx.numel() + 2 * idx.numel() * 3), 0.0,
           library_ms=cuda_ms(lambda: pts[bidx, idx64], 50), values_equal=match,
           seconds=time.perf_counter() - t0)

    # N: part_acc clouds and the shape_cd clouds
    for B, N in ((96, 1000), (8, 20000)):
        t0 = time.perf_counter()
        x, y = randn(B, N, 3), randn(B, N, 3)
        d, i = chamfer.nn_distance(x, y)
        dr, ir = chamfer.nn_distance_plain(x, y)
        torch.cuda.synchronize()
        err = (d - dr).abs().max().item()
        rel = ((d - dr).abs() / dr.abs().clamp_min(1e-30)).max().item()
        match = bool(torch.equal(i, ir))
        _check(rel <= 1e-5 and match, f"N [{B},{N}]: rel err {rel}, indices equal {match}")
        record("N", f"[{B},{N}]^2", err,
               cuda_ms(lambda: chamfer.nn_distance(x, y), 5),
               cuda_ms(lambda: chamfer.nn_distance_plain(x, y), 1),
               4 * (2 * B * N * 3 + 2 * B * N), 8.0 * B * N * N,
               library_ms=cuda_ms(lambda: torch.cdist(x, y).min(-1), 3),
               max_rel_err=rel, indices_equal=match, seconds=time.perf_counter() - t0)

    # M: one merge step's pairs at P = 20, N = 1000, 3 active pairs
    t0 = time.perf_counter()
    P, N = 20, 1000
    pts = randn(1, P, N, 3, scale=0.3)
    mask = torch.zeros((1, P, P), dtype=torch.bool, device=dev)
    pairs = ((0, 1), (1, 0), (2, 5))
    for a, b in pairs:
        mask[0, a, b] = True
    out = chamfer.masked_pairwise_nn(pts, mask)
    ref = chamfer.masked_pairwise_nn_plain(pts, mask)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    act = mask[..., None].expand_as(out)
    rel = ((out - ref).abs()[act] / ref[act].clamp_min(1e-30)).max().item()
    _check(rel <= 1e-5 and bool((out[~act] == chamfer.INACTIVE).all()),
           f"M: rel err {rel} or bad sentinel")
    xa = torch.stack([pts[0, a] for a, _ in pairs])
    xb = torch.stack([pts[0, b] for _, b in pairs])
    record("M", "P=20 N=1000, 3 active pairs", err,
           cuda_ms(lambda: chamfer.masked_pairwise_nn(pts, mask), 20),
           cuda_ms(lambda: chamfer.masked_pairwise_nn_plain(pts, mask), 3),
           4 * (P * N * 3 + P * P * N) + P * P, 8.0 * len(pairs) * N * N,
           library_ms=cuda_ms(lambda: torch.cdist(xa, xb).min(-1), 20),
           max_rel_err=rel, seconds=time.perf_counter() - t0)


def _full_config(data_root: str):
    from puzzlefusion_plusplus_tpu_torch.utils.config import Config

    cfg = Config()
    cfg.data.data_val_dir = os.path.join(data_root, "pc_data", "val")
    cfg.data.matching_data_path = os.path.join(data_root, "matching_data")
    cfg.inference.batch_size = 8
    cfg.inference.save_trajectories = False
    return cfg


def phase_engine(data_root: str) -> dict:
    import numpy as np

    from puzzlefusion_plusplus_tpu_torch import ops
    from puzzlefusion_plusplus_tpu_torch.inference.run import build_engine_fn, run_inference

    t0 = time.perf_counter()
    cfg = _full_config(data_root)
    engine = build_engine_fn(cfg, "cuda")
    walls = []
    for call in range(2):  # call 0 warms cuBLAS and the allocator; call 1 is counted
        if call == 1:
            ops.reset_launch_counts()  # the main path's run starts here
        t1 = time.perf_counter()
        agg = run_inference(cfg, engine=engine)
        walls.append(time.perf_counter() - t1)
    counts = ops.launch_counts()
    vals = [agg[f"eval/{k}"] for k in ("part_acc", "shape_cd", "rmse_r", "rmse_t")]
    _check(all(np.isfinite(vals)), f"non-finite metrics {agg}")
    _check(all(counts[k] > 0 for k in "SFGN"), f"a kernel never launched: {counts}")
    row = {"phase": "engine", "seconds": time.perf_counter() - t0, "batch": 8,
           "num_samples": agg["num_samples"], "wall_s_per_call": walls,
           "assemblies_per_s": agg["num_samples"] / walls[-1],
           "part_acc": agg["eval/part_acc"], "shape_cd": agg["eval/shape_cd"],
           "rmse_r": agg["eval/rmse_r"], "rmse_t": agg["eval/rmse_t"],
           "n_iters": agg["n_iters"], "n_merged_pairs": agg["n_merged_pairs"],
           "launches": counts}
    emit(row)
    return row


def phase_merge(data_root: str) -> dict:
    import numpy as np
    import torch

    from puzzlefusion_plusplus_tpu_torch import ops
    from puzzlefusion_plusplus_tpu_torch.data.bucketing import part_bucket, slice_batch_parts
    from puzzlefusion_plusplus_tpu_torch.data.datasets import DenoiserDataset
    from puzzlefusion_plusplus_tpu_torch.data.loader import Loader
    from puzzlefusion_plusplus_tpu_torch.inference.engine import draw_noise
    from puzzlefusion_plusplus_tpu_torch.inference.run import (
        agg_config,
        build_engine_fn,
        make_models,
    )

    t0 = time.perf_counter()
    cfg = _full_config(data_root)
    cfg.verifier.threshold = 0.0
    cfg.inference.batch_size = 2
    ds = DenoiserDataset(cfg.data.data_val_dir, mode="test",
                         matching_data_path=cfg.data.matching_data_path)
    batch = next(iter(Loader(ds, 2, shuffle=False, drop_last=False)))
    batch = slice_batch_parts(batch, part_bucket(int(np.max(batch["num_parts"]))))
    batch["ref_part"] = np.zeros_like(batch["ref_part"])
    B, P = batch["part_valids"].shape
    noise = draw_noise(agg_config(cfg), B, P, torch.Generator().manual_seed(3), "cpu")

    vq, den, ver = make_models(cfg)
    with torch.no_grad():  # damped denoiser: a contractive recurrence, comparable runs
        for p in den.parameters():
            p.mul_(0.05)
    sds = {"vqvae": vq.state_dict(), "denoiser": den.state_dict(),
           "verifier": ver.state_dict()}
    before = ops.launch_counts()
    gpu = build_engine_fn(cfg, "cuda", state_dicts=sds)(
        batch, noise=tuple(n.cuda() for n in noise))
    counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
    t_gpu = time.perf_counter() - t0
    cpu = build_engine_fn(cfg, "cpu", state_dicts=sds)(batch, noise=noise)
    _check(int(gpu["n_merged_pairs"].sum()) > 0, f"no merge fired: {gpu['n_merged_pairs']}")
    _check(counts["M"] > 0 and counts["F"] > 0, f"merge kernels not launched: {counts}")
    same = {k: bool(np.array_equal(gpu[k], cpu[k]))
            for k in ("n_iters", "n_merged_pairs", "acc_per_part")}
    traj_err = float(np.abs(gpu["trajectory"] - cpu["trajectory"]).max())
    row = {"phase": "merge", "seconds": time.perf_counter() - t0, "gpu_seconds": t_gpu,
           "n_merged_pairs": gpu["n_merged_pairs"].tolist(),
           "n_iters": int(gpu["n_iters"][0]), "launches": counts,
           "gpu_vs_cpu_equal": same, "gpu_vs_cpu_max_traj_err": traj_err}
    emit(row)
    _check(all(same.values()) and traj_err <= 1e-3, f"GPU and CPU engines disagree: {row}")
    return row


KERNEL_NAMES = {"sa_cached_kernel": "S", "fps_kernel": "F", "gather_kernel": "G",
                "nn_kernel": "N", "masked_pair_kernel": "M"}


def phase_profile(data_root: str) -> dict:
    """Where one engine call's device time goes: torch.profiler over one full-width call,
    self device time grouped into the port's kernels, matrix products and the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from puzzlefusion_plusplus_tpu_torch.inference.run import build_engine_fn, run_inference

    t0 = time.perf_counter()
    cfg = _full_config(data_root)
    engine = build_engine_fn(cfg, "cuda")
    run_inference(cfg, engine=engine)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        run_inference(cfg, engine=engine)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    groups: dict[str, float] = {}
    top = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # operator rows repeat the time of the kernels they launch
        us = e.self_device_time_total
        if us <= 0:
            continue
        top.append((us, e.key, e.count))
        group = next((f"kernel {v}" for k, v in KERNEL_NAMES.items() if k in e.key), None)
        if group is None:
            low = e.key.lower()
            group = "matmul (cuBLAS)" if ("gemm" in low or "cutlass" in low) else "other"
        groups[group] = groups.get(group, 0.0) + us / 1e3
    device_ms = sum(groups.values())
    top.sort(reverse=True)
    row = {"phase": "profile", "seconds": time.perf_counter() - t0,
           "wall_ms_under_profiler": wall_ms, "device_ms": device_ms,
           "device_busy_share": device_ms / wall_ms if device_ms else None,
           "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
           "top": [{"name": k[:90], "ms": us / 1e3, "count": c} for us, k, c in top[:12]]}
    emit(row)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,engine,merge,profile")
    phases = ap.parse_args().phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from puzzlefusion_plusplus_tpu_torch import ops
    from puzzlefusion_plusplus_tpu_torch.data.synthetic import generate_dataset
    from puzzlefusion_plusplus_tpu_torch.inference.run import resolve_device

    resolve_device("cuda")  # also turns TF32 off for the comparisons
    t_start = time.perf_counter()
    results: dict = {}
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        phase_kernels(results)
    launches = None
    if "engine" in phases or "merge" in phases:
        t0 = time.perf_counter()
        data_root = os.path.join(REPO, ".smoke", "chip_smoke_data")
        generate_dataset(data_root, num_shapes=8, seed=7, split="val", min_parts=3,
                         max_parts=12)
        emit({"phase": "data", "seconds": time.perf_counter() - t0})
        ops.reset_launch_counts()  # phase_engine resets again after its warm-up call
        if "engine" in phases:
            phase_engine(data_root)
        if "merge" in phases:
            phase_merge(data_root)  # its GPU run closes the main path's run
        launches = ops.launch_counts()
        _check(all(v > 0 for v in launches.values()), f"kernel never launched: {launches}")
        if "profile" in phases:
            phase_profile(data_root)

    if results:
        rows = []
        for name, recs in results.items():
            main_rec = recs[-1]  # S: sum of the three stages; others: the largest shape
            agg = (lambda key: sum(r[key] for r in recs)) if name == "S" else (
                lambda key: main_rec[key])
            source, replaces = REPLACES[name]
            rows.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": None if launches is None else launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in recs),
                "ms": agg("ms"), "plain_ms": agg("plain_ms"), "bound_ms": agg("bound_ms"),
                "bound_by": main_rec["bound_by"], "library_ms": main_rec["library_ms"],
                "shape": "SA1+SA2+SA3 of one denoise step" if name == "S" else
                main_rec["shape"],
            })
        print(json.dumps({"kernels": rows}), flush=True)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
