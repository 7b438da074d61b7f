"""The training cells: the denoiser trainer's inner loop (``training/denoiser.py::train``) on
one card, or on one rank a card over NCCL.

Set-up writes the cell's training set from the seed as pc_data files under the run's
temporary directory (in parallel processes, before any rank starts), builds the trainer
through ``_setup`` (its dataset, ``Loader`` and AdamW), draws the denoiser's and the frozen
VQ-VAE encoder's weights on the card, and runs the first ``check.steps`` steps through the
window's own loop, each after seeding the dropout generator from the seed: they warm every
kernel, and the check reads them (the loss of each, the first gradient from AdamW's first
moment, the parameters after the last). The window then runs whole epochs of steps until
``seconds`` have passed and ends on a host sync. The loop is ``train``'s inner loop,
``prefetch_batches`` over the loader an epoch, ``prepare``, ``draw_step_noise`` and
``train_step``, without the logger, validation and checkpoints (none falls in a 4-step
epoch): the program has no step hook to drive instead. A traced run adds one more epoch
under the profiler.

The check runs the plain reference (``reference/train.py``) over the same raw files once the
window has closed and the program's state is freed, on rank 0. With more than one rank every
rank's parameters after the checked steps must equal rank 0's.
"""

from __future__ import annotations

import importlib
import os
import queue
import shutil
import socket
import tempfile
import time

import numpy as np
import torch

from pfpp_bench import flops, harness, seeds
from pfpp_bench.reference import train as ref_train
from pfpp_bench.reference.numerics import FP32
from pfpp_bench.trace import Slice, Spans
from pfpp_bench.traffic import shapes

SPANS = ("train_step", "encoder", "denoiser", "allreduce", "optimizer")
LOADER_SALT, NOISE_SALT, DROPOUT_SALT = 21, 23, 31


def dropout_seeds(seed: int, steps: int, world: int) -> list[list[int]]:
    return [[seeds.derive(seed, DROPOUT_SALT, k, r) for r in range(world)] for k in range(steps)]


def run(w: dict, cfg: dict, seed: int, seconds: float, trace: bool, device, workers: int,
        t_start: float, chips: int = 1) -> dict:
    tmp = tempfile.mkdtemp(prefix="pfpp_bench_")
    try:
        train_dir = os.path.join(tmp, "pc_data", "train")
        os.makedirs(os.path.join(tmp, "pc_data", "val"))
        pending = shapes.write_train_set(w["traffic"], seed, cfg["data"]["points_per_part"],
                                         train_dir, workers)
        marks = {}
        args = (w, cfg, seed, seconds, trace, tmp, t_start, marks)
        if chips == 1:  # the models are built while the set is written
            return rank_main(0, 1, device, None, *args, wait=pending.get)
        t = time.time()
        pending.get()  # every rank's loader reads the whole set
        marks["traffic_s"] = time.time() - t
        return _spawn(chips, args, device.type)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, world: int, port: int, device_type: str, args: tuple,
                results) -> None:
    device = torch.device(device_type, rank if device_type == "cuda" else None)
    if device.type == "cuda":
        torch.cuda.set_device(rank)
    out = rank_main(rank, world, device, port, *args)
    if rank == 0:
        results.put(out)


def _spawn(world: int, args: tuple, device_type: str) -> dict:
    """One process a rank, a card each (gloo processes on the CPU); rank 0's result."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_entry, args=(r, world, port, device_type, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        out = None
        while out is None:
            try:
                out = results.get(timeout=5)
            except queue.Empty:  # check that the ranks are alive
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise RuntimeError("a rank failed: "
                                       + ", ".join(str(p.exitcode) for p in procs))
        for p in procs:
            p.join(timeout=120)
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()


def rank_main(rank: int, world: int, device, port, w, cfg, seed, seconds, trace, tmp,
              t_start, marks, wait=None) -> dict:
    import torch.distributed as dist

    from puzzlefusion_plusplus_tpu_torch.inference.sampler import make_frozen_encoder
    from puzzlefusion_plusplus_tpu_torch.models.scheduler import DDPMParams
    from puzzlefusion_plusplus_tpu_torch.parallel import mesh
    from puzzlefusion_plusplus_tpu_torch.training import denoiser as trainer

    if w.get("plant"):  # a test's fault, planted in each rank's process ("module:function")
        module, fn = w["plant"].split(":")
        getattr(importlib.import_module(module), fn)()
    if world > 1:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}", world_size=world,
                                rank=rank)
    try:
        t = time.time()
        tc = cfg["train"]
        prog_cfg = harness.program_config(cfg)
        prog_cfg.data.batch_size = tc["batch_size"] * world
        prog_cfg.data.data_dir = os.path.join(tmp, "pc_data", "train")
        prog_cfg.data.data_val_dir = os.path.join(tmp, "pc_data", "val")
        prog_cfg.trainer.seed = seeds.derive(seed, LOADER_SALT)
        weights = harness.draw_weights(cfg, seed, device, ("vqvae", "denoiser"))
        ae = harness.program_models(cfg, prog_cfg, device, ("vqvae",))["vqvae"]
        encoder = make_frozen_encoder(harness.load(ae, weights["vqvae"]))
        ddpm = DDPMParams.piecewise(prog_cfg.denoiser.ddpm_train_steps)
        gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, NOISE_SALT))
        marks["encoder_s"] = time.time() - t
        if wait is not None:
            wait()
            marks["traffic_s"] = time.time() - t
        t = time.time()
        loader, _, prepare, state = trainer._setup(prog_cfg, device)
        harness.load(state.model, weights["denoiser"])
        del weights
        mesh.replicate(state.model)
        marks["build_s"] = time.time() - t

        host = {"loader_wait": []}
        batches = _epochs(loader)
        steps_per_epoch = len(loader)

        def step():
            tw = time.perf_counter()
            batch = next(batches)
            host["loader_wait"].append(time.perf_counter() - tw)
            local = prepare(batch)
            b, P = local["part_valids"].shape
            ts, noise = trainer.draw_step_noise(ddpm, (b * world, P, 7), gen, None, device)
            rows = slice(rank * b, (rank + 1) * b)
            return trainer.train_step(state, local, encoder, ddpm, timesteps=ts[rows],
                                      noise=noise[rows]), batch["num_parts"]

        # the checked steps: the set-up's warm-up, read before the window
        t = time.time()
        n_check = w["check"]["steps"]
        drop = dropout_seeds(seed, n_check, world)
        losses = []
        for k in range(n_check):
            torch.manual_seed(drop[k][rank])
            metrics, _ = step()
            losses.append(float(metrics["mse_loss"]))
            if k == 0:
                b1 = tc["betas"][0]
                grad1 = {n: (state.optimizer.state[p].get("exp_avg", torch.zeros_like(p))
                             / (1.0 - b1)).cpu() for n, p in state.model.named_parameters()}
        after = {n: p.detach().cpu().clone() for n, p in state.model.named_parameters()}
        harness.sync(device)
        marks["warm_s"] = time.time() - t
        setup_s = time.time() - t_start

        host["loader_wait"].clear()
        shapes_done, work, n = 0, 0, 0
        t0 = time.perf_counter()
        te = t0
        # whole epochs, so that a traced slice of ``trace_steps`` (one epoch) has the
        # window's mix of steps
        while te < t0 + seconds or (n_check + n) % steps_per_epoch:
            _, parts = step()
            shapes_done += len(parts)
            work += flops.train_step_flops(cfg, [int(x) for x in parts])
            n += 1
            te = time.perf_counter()
        harness.sync(device)
        te = pre = time.perf_counter()
        readings = {"host": {"loader_wait": list(host["loader_wait"])}, "slice": None}
        dev_rec = harness.device_record(device, world)
        if trace:
            spans = Spans()
            spans.wrap(trainer, "train_step", "train_step")
            spans.wrap(trainer, "extract_features", "encoder")
            spans.wrap(mesh, "all_reduce_gradients", "allreduce")
            spans.wrap(state.model, "forward", "denoiser")
            spans.wrap(state.optimizer, "step", "optimizer")
            with Slice() as sl:
                for _ in range(w["trace_steps"]):
                    _, parts = step()
                    shapes_done += len(parts)
                    work += flops.train_step_flops(cfg, [int(x) for x in parts])
                    n += 1
            te = sl.t0 + sl.wall_s  # the profiler's start and stop left out
            spans.restore()
            red = sl.reduce(SPANS)
            readings.update(slice=red, slice_steps=w["trace_steps"])
            busy = torch.tensor([red["busy_s"], red["wall_s"]], device=device)
            if world > 1:
                dist.all_reduce(busy)
            dev_rec.update(busy_s=float(busy[0]) / world, window_s=float(busy[1]) / world)
            window_s = (pre - t0) + (te - sl.t0)
        else:
            window_s = te - t0
        readings.update(window_s=window_s, flops=work / world)
        if world > 1:
            peak = torch.tensor([dev_rec["memory_peak_bytes"]], device=device)
            dist.all_reduce(peak, op=dist.ReduceOp.MAX)
            dev_rec["memory_peak_bytes"] = int(peak)

        # every rank's checked parameters against rank 0's
        rank_gap = 0.0
        if world > 1:
            for name in sorted(after):
                mine = after[name].to(device)
                theirs = mine.clone()
                dist.broadcast(theirs, 0)
                rank_gap = max(rank_gap, float((mine - theirs).abs().max()))
            gap = torch.tensor([rank_gap], device=device)
            dist.all_reduce(gap, op=dist.ReduceOp.MAX)
            rank_gap = float(gap)
        loader_seed = prog_cfg.trainer.seed
        del state, encoder, batches
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if world > 1:
            dist.barrier()
        out = None
        if rank == 0:
            t = time.time()
            checks = check(cfg, w, seed, prog_cfg.data.data_dir, loader_seed, world, device,
                           {"loss": losses, "grad1": grad1, "params": after})
            if world > 1:
                checks["rank_gap"] = (rank_gap, w["check"]["limits"]["rank_gap"])
            metrics = {"setup_s": setup_s, "train_shapes_per_s": shapes_done / window_s}
            out = {"metrics": metrics, "readings": readings, "checks": checks,
                   "device": dev_rec, "attempted": n, "failed": 0,
                   "counts": {"steps": n, "shapes": shapes_done, "window_s": window_s,
                              "check_s": time.time() - t, **marks}}
        return out
    finally:
        if world > 1 and dist.is_initialized():
            dist.destroy_process_group()


def _epochs(loader):
    """``train``'s batches: epoch after epoch, each through a new prefetch thread."""
    from puzzlefusion_plusplus_tpu_torch.data.loader import prefetch_batches

    while True:
        yield from prefetch_batches(loader)


def reference(cfg: dict, w: dict, seed: int, data_dir: str, loader_seed: int, world: int,
              device, prec=None, half: bool = False) -> dict:
    """The reference's checked steps over the raw files in ``data_dir``."""
    n = w["check"]["steps"]
    data = ref_train.TrainData(data_dir, cfg["data"]["max_num_part"],
                               cfg["train"]["multiple_ref_parts"])
    batches = data.batches(loader_seed, cfg["train"]["batch_size"] * world, n)
    params = harness.draw_weights(cfg, seed, device, ("vqvae", "denoiser"))
    return ref_train.steps(params, cfg, batches, seeds.derive(seed, NOISE_SALT),
                           dropout_seeds(seed, n, world), world, device, prec or FP32, half)


def check(cfg: dict, w: dict, seed: int, data_dir: str, loader_seed: int, world: int, device,
          prog: dict) -> dict:
    """The reference's steps against the program's record -> {name: (value, limit)}."""
    ref = reference(cfg, w, seed, data_dir, loader_seed, world, device)
    return compare(cfg, w, seed, prog, ref, device)


def compare(cfg: dict, w: dict, seed: int, prog: dict, ref: dict, device) -> dict:
    """Each step's loss, the first gradient and the parameters' change by the worst leaf;
    the change leaves out leaves whose reference gradient is under a thousandth of the
    median leaf's (moved by AdamW's round-off alone)."""
    theta0 = harness.draw_weights(cfg, seed, device, ("denoiser",))["denoiser"]
    loss = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], ref["loss"]))
    grad = ref_train.leaf_gap(prog["grad1"], ref["grad1"])
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in ref["grad1"].items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    moved = {k: prog["params"][k].to(device) - theta0[k] for k in theta0}
    ref_moved = {k: ref["params"][k] - theta0[k] for k in theta0}
    update = ref_train.leaf_gap(moved, ref_moved, keep=lambda k: norms[k] >= floor)
    lim = w["check"]["limits"]
    return {"loss_gap": (loss, lim["loss_gap"]), "grad_gap": (grad, lim["grad_gap"]),
            "update_gap": (update, lim["update_gap"])}
