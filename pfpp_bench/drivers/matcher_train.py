"""The matcher cell: the Jigsaw matcher's trainer (``matching/train.py::train_matching``) on
one card at batch 1.

Set-up writes the cell's shapes from the seed as pc_data files under the run's temporary
directory (in parallel processes, while the model is built), builds the program's
``JigsawModel`` at the configuration's widths with the seed's weights drawn on the card,
builds the trainer through ``_setup`` (``AllPieceMatchingDataset``, ``Loader`` and
``adam_cosine`` over the published epochs), and runs the first ``check.steps`` steps through
the window's own loop: they warm every kernel, and the check reads them (the first loss,
the first gradient from Adam's first moment, the parameters after the last, the first
step's Sinkhorn matrix). The window then runs whole epochs of steps until ``seconds`` have
passed and ends on a host sync. The loop is ``train_matching``'s inner loop in the loss
stage of epochs ``mat_epoch`` to ``rig_epoch`` - 1: ``prefetch_batches`` over the loader an
epoch, the batch's copy to the card and ``train_step(state, batch, w_mat, w_rig)``, without
the logger, validation and checkpoints, which no window reaches (the program has no step
hook to drive instead). A traced run adds ``trace_steps`` steps under the profiler.

The device-time readings come from the program's own ``pfpp.match.*`` ranges in the trace,
the host readings from its span registry (``utils/profiling.py::snapshot``); a program
without them gives neither, and the readers of the ``.match`` metrics return None. The
device's idle share and the loader's wait (the window's steps waiting on the prefetch
iterator, timed here as ``drivers/denoiser_train.py`` times them) need no span.

The check runs the plain reference (``reference/matcher.py``) over the same raw files once
the window has closed and the program's state is freed. Its loss is the first step's: from
the second step on, Adam's first update (about lr for every entry, whatever its gradient's
size) turns rounding into loss gaps (up to 3.2e-3 on 28 sound seeds) as large as a TF32
control's, while the first step's loss, gradient and Sinkhorn matrix separate them by
orders of magnitude (PERF.md §6).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from pfpp_bench import flops_matcher, harness, seeds
from pfpp_bench.reference import matcher as ref_matcher
from pfpp_bench.reference import matcher_params
from pfpp_bench.reference import train as ref_train
from pfpp_bench.reference.numerics import FP32
from pfpp_bench.trace import Slice
from pfpp_bench.traffic import shapes

SPANS = ("pfpp.match.step", "pfpp.match.encode", "pfpp.match.attention", "pfpp.match.affinity",
         "pfpp.match.sinkhorn", "pfpp.match.loss", "pfpp.match.backward",
         "pfpp.match.optimizer")
LOADER_SALT = 41


def program_model(cfg: dict, device):
    """The program's ``JigsawModel`` at the configuration's widths, on ``device``; raises
    where the program's encoder plan is not the file's."""
    from puzzlefusion_plusplus_tpu_torch.matching.model import JigsawModel

    m = cfg["model"]
    with torch.device(device):
        model = JigsawModel(pc_feat_dim=m["pc_feat_dim"], aff_feat_dim=m["aff_feat_dim"],
                            encoder_type=m["encoder"], tf_num_heads=m["tf_num_heads"],
                            tf_num_samples=m["tf_num_samples"],
                            sinkhorn_iters=m["sinkhorn_iters"], sinkhorn_tau=m["sinkhorn_tau"],
                            sa_npoints=tuple(m["sa_npoints"]), cls_method=m["cls_method"],
                            max_num_part=cfg["data"]["max_num_part"])
    for s, level in enumerate(m["sa_plan"]):
        sa = getattr(model.encoder, f"sa{s + 1}")
        if (list(sa.radii), list(sa.nsamples)) != (level["radii"], level["nsamples"]):
            raise ValueError(f"sa{s + 1}: the program's radii and samples {sa.radii}, "
                             f"{sa.nsamples} are not the configuration's")
    return model.to(device)


def run(w: dict, cfg: dict, seed: int, seconds: float, trace: bool, device, workers: int,
        t_start: float, chips: int = 1) -> dict:
    if chips != 1:
        raise ValueError("the matcher cell runs on one card (the published recipe)")
    tmp = tempfile.mkdtemp(prefix="pfpp_bench_")
    try:
        data_dir = os.path.join(tmp, "pc_data", "train")
        pending = shapes.write_train_set(w["traffic"], seed, cfg["data"]["points_per_part"],
                                         data_dir, workers)
        return _run(w, cfg, seed, seconds, trace, device, t_start, data_dir, pending.get)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(w, cfg, seed, seconds, trace, device, t_start, data_dir, wait) -> dict:
    from puzzlefusion_plusplus_tpu_torch.data.loader import prefetch_batches
    from puzzlefusion_plusplus_tpu_torch.matching import train as trainer
    from puzzlefusion_plusplus_tpu_torch.training.vqvae import local_rows
    from puzzlefusion_plusplus_tpu_torch.utils.profiling import snapshot

    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    d, tr = cfg["data"], cfg["train"]
    marks = {}
    t = time.time()
    model = harness.load(program_model(cfg, device), matcher_params.draw(cfg["model"], seed,
                                                                          device))
    marks["build_s"] = time.time() - t
    wait()
    marks["traffic_s"] = time.time() - t
    loader_seed = seeds.derive(seed, LOADER_SALT)
    loader, _, state = trainer._setup(data_dir, d["num_points"], d["max_num_part"],
                                      tr["batch_size"], loader_seed, None, model, tr["epochs"],
                                      tr["lr"], device)
    ds = loader.dataset
    if (ds.min_part_point, ds.fracture_label_threshold) != (d["min_part_point"],
                                                            d["fracture_label_threshold"]):
        raise ValueError("the program's dataset settings are not the configuration's")
    # the batch's copy to the card, as the program's loop makes it (a program without
    # ``device_batch`` copies with ``local_rows`` alone)
    to_card = getattr(trainer, "device_batch", local_rows)
    steps_per_epoch = len(loader)
    decay_steps = tr["epochs"] * steps_per_epoch

    def epochs():
        while True:
            yield from prefetch_batches(loader)

    batches = epochs()
    host = {"loader_wait": []}

    def step():
        tw = time.perf_counter()
        batch = next(batches)
        host["loader_wait"].append(time.perf_counter() - tw)
        return trainer.train_step(state, to_card(batch, device), tr["w_mat"], tr["w_rig"],
                                  tr["cls_pos_weight"]), batch

    # the checked steps: the set-up's warm-up, read before the window; the first step's
    # Sinkhorn matrix from the model's output
    kept = []

    def keep(*args, _fwd=state.model.forward, **kwargs):
        out = _fwd(*args, **kwargs)
        if not kept:
            n = out["n_critical_sum"].tolist()
            kept.extend(out["ds_mat"][i, :k, :k].detach().clone() for i, k in enumerate(n))
        return out

    state.model.forward = keep
    t = time.time()
    losses = []
    for k in range(w["check"]["steps"]):
        metrics, _ = step()
        losses.append(float(metrics["loss"]))
        if k == 0:
            b1 = tr["betas"][0]
            grad1 = {n: (state.optimizer.state[p].get("exp_avg", torch.zeros_like(p))
                         / (1.0 - b1)).detach().clone()
                     for n, p in state.model.named_parameters()}
    del state.model.forward
    after = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    harness.sync(device)
    marks["warm_s"] = time.time() - t
    setup_s = time.time() - t_start

    host["loader_wait"].clear()
    n_check, shapes_done, n = w["check"]["steps"], 0, 0
    t0 = time.perf_counter()
    te = t0
    while te < t0 + seconds or (n_check + n) % steps_per_epoch:  # whole epochs
        _, batch = step()
        shapes_done += len(batch["num_parts"])
        n += 1
        te = time.perf_counter()
    harness.sync(device)
    te = pre = time.perf_counter()
    readings = {"host": {"loader_wait": list(host["loader_wait"])}, "slice": None}
    dev_rec = harness.device_record(device, 1)
    if trace:
        traced = []
        with Slice() as sl:
            for _ in range(w["trace_steps"]):
                _, batch = step()
                traced.append(batch)
                shapes_done += len(batch["num_parts"])
                n += 1
        te = sl.t0 + sl.wall_s  # the profiler's start and stop left out
        readings.update(spans=snapshot()["spans"], slice=sl.reduce(SPANS),
                        **traced_work(cfg, traced, device))
        dev_rec.update(busy_s=readings["slice"]["busy_s"], window_s=readings["slice"]["wall_s"])
        window_s = (pre - t0) + (te - sl.t0)
    else:
        window_s = te - t0
    del state, model, batches
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.time()
    prog = {"loss": losses, "grad1": grad1, "params": after, "ds1": kept}
    checks = check(cfg, w, seed, data_dir, loader_seed, decay_steps, device, prog)
    return {"metrics": {"setup_s": setup_s, "train_shapes_per_s": shapes_done / window_s},
            "readings": readings, "checks": checks, "device": dev_rec, "attempted": n,
            "failed": 0,
            "counts": {"steps": n, "shapes": shapes_done, "window_s": window_s,
                       "check_s": time.time() - t, **marks}}


def traced_work(cfg: dict, batches: list[dict], device) -> dict:
    """The traced steps' needed FLOPs and the least bytes of their Sinkhorns, from each
    shape's critical count (the reference's fracture labels of its batch)."""
    n_crit = []
    for b in batches:
        gt = torch.as_tensor(b["gt_pcs"], device=device)
        pid = torch.as_tensor(b["piece_id"], device=device).long()
        n_parts = torch.as_tensor(b["part_valids"], device=device).sum(-1).long()
        thr = torch.as_tensor(b["critical_label_thresholds"], device=device)
        n_crit.append(ref_matcher.fracture_labels(gt, pid, n_parts, thr).sum(-1).tolist())
    iters = cfg["model"]["sinkhorn_iters"]
    return {"match_flops": sum(flops_matcher.train_step_flops(cfg, n) for n in n_crit),
            "sinkhorn_bytes": sum(flops_matcher.sinkhorn_bytes(k, iters)
                                  for n in n_crit for k in n)}


def reference(cfg: dict, w: dict, seed: int, data_dir: str, loader_seed: int,
              decay_steps: int, device, prec=None, model_override=None) -> dict:
    """The reference's checked steps over the raw files in ``data_dir``; ``model_override``
    changes the reference's model settings (a planted fault for the readings)."""
    rcfg = {**cfg, "model": {**cfg["model"], **(model_override or {})}}
    batches = ref_matcher.MatcherData(data_dir, cfg["data"]).batches(
        loader_seed, cfg["train"]["batch_size"], w["check"]["steps"])
    params = matcher_params.draw(cfg["model"], seed, device)
    return ref_matcher.steps(params, rcfg, batches, decay_steps, device, prec or FP32)


def check(cfg: dict, w: dict, seed: int, data_dir: str, loader_seed: int, decay_steps: int,
          device, prog: dict) -> dict:
    """The reference's steps against the program's record -> {name: (value, limit)}."""
    ref = reference(cfg, w, seed, data_dir, loader_seed, decay_steps, device)
    return compare(cfg, w, seed, prog, ref, device)


def compare(cfg: dict, w: dict, seed: int, prog: dict, ref: dict, device) -> dict:
    """The first step's loss (relative), the first gradient and the parameters' change by
    the worst leaf (as the denoiser's cells measure them), and the first step's Sinkhorn
    matrices."""
    theta0 = {k: v for k, v in matcher_params.draw(cfg["model"], seed, device).items()
              if k in ref["grad1"]}
    loss = abs(prog["loss"][0] - ref["loss"][0]) / max(abs(ref["loss"][0]), 1e-30)
    grad = ref_train.leaf_gap(prog["grad1"], ref["grad1"])
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in ref["grad1"].items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    moved = {k: prog["params"][k].to(device) - theta0[k] for k in theta0}
    ref_moved = {k: ref["params"][k] - theta0[k] for k in theta0}
    update = ref_train.leaf_gap(moved, ref_moved, keep=lambda k: norms[k] >= floor)
    if [tuple(a.shape) for a in prog["ds1"]] != [tuple(a.shape) for a in ref["ds1"]]:
        ds = float("inf")  # the critical sets differ
    else:
        ds = max((float((a.to(device) - b).abs().max()) for a, b in zip(prog["ds1"], ref["ds1"])
                  if a.numel()), default=0.0)
    lim = w["check"]["limits"]
    return {"loss_gap": (loss, lim["loss_gap"]), "grad_gap": (grad, lim["grad_gap"]),
            "update_gap": (update, lim["update_gap"]), "ds_gap": (ds, lim["ds_gap"])}
