"""Benchmark of the port: assemblies/s of the full auto-agglomerative engine on one card.

``python -m puzzlefusion_plusplus_tpu_torch.bench [--serving | --full-range | --cpu-baseline]``
prints one JSON line, ``{"metric", "value", "unit", "vs_baseline", "extra"}``.

The engine is ``inference/run.py::build_engine_fn`` at ``Config()`` widths (VQ-VAE 1000 points,
25 x 64 tokens, 1024 x 16 codebook; denoiser 512/6/8; verifier 256/6/8; 6 iterations of 20
diffusion steps and a verification) with weights drawn from ``trainer.seed``, on 32 synthetic
Breaking-Bad-style shapes of 3-12 parts (seed 7, ``data/synthetic.py``):

* default: the loader's first batch of ``PFPP_BENCH_BATCH`` shapes (8), sliced to its part
  bucket as ``run_inference`` slices it (``PFPP_BENCH_BUCKET=0`` keeps the 20-part pad);
* ``--serving``: the whole set in part-count-sorted batches, each at its own bucket's pad,
  as ``run_inference`` serves it; ``--full-range``: the same over 32 shapes of 3-20 parts;
* ``--cpu-baseline``: the default metric at batch 1 on the CPU, the anchor of
  ``vs_baseline`` (``REFERENCE_CPU_ASSEMBLIES_PER_SEC``).

Timing: one warm-up call (which also builds the CUDA kernels: ``build_s``), then
``PFPP_BENCH_REPEATS`` timed calls (3, at least 1), each ended by the host holding
``part_acc`` (the engine returns numpy, a real device-to-host copy); ``value`` is the shapes
over the best call. ``timing_suspect`` is true when a call took under 50 ms, which 6 x 20
denoising steps cannot: the measurement is then broken, not fast.

Environment: ``PFPP_BENCH_BATCH``, ``PFPP_BENCH_REPEATS``, ``PFPP_BENCH_DATA`` (the data
directory, default ``<tmp>/pfpp_bench_data_torch``: the port's own, never the JAX bench's),
``PFPP_BENCH_PRECISION`` (``trainer.precision``: fp32 or bf16), ``PFPP_BENCH_BUCKET``, and
``PFPP_SA_GATHER`` (kernel S's gather mode: ``onehot``, the default, is exact; ``int8``
quantizes the encoder's SA2 and SA3 projections, as in the JAX package), which the line
reports as ``extra.sa_gather``.
"""

from __future__ import annotations

import json
import os
import platform
import sys
import tempfile
import time

USAGE = ("usage: python -m puzzlefusion_plusplus_tpu_torch.bench "
         "[--serving | --full-range | --cpu-baseline]  # env: PFPP_BENCH_BATCH, "
         "PFPP_BENCH_REPEATS, PFPP_BENCH_DATA, PFPP_BENCH_PRECISION, PFPP_BENCH_BUCKET, "
         "PFPP_SA_GATHER")

# Measured with ``python -m puzzlefusion_plusplus_tpu_torch.bench --cpu-baseline`` (the port's
# engine at Config() widths, batch 1 at the 8-part pad, fp32) on the host CPU of an NVIDIA
# H100 machine, which reports no model name (/proc/cpuinfo and lscpu say "unknown"), 8 cores,
# torch on 8 threads: best of 3 calls 26.17 s (runs 26.57, 26.17, 27.09 s).
REFERENCE_CPU_ASSEMBLIES_PER_SEC = 0.0382

NUM_BENCH_SHAPES = 32
SEED = 7
SUSPECT_S = 0.05  # 6 iterations x 20 denoising steps cannot finish faster


def settings(env=os.environ) -> dict:
    return {
        "batch": int(env.get("PFPP_BENCH_BATCH", "8")),
        "repeats": max(1, int(env.get("PFPP_BENCH_REPEATS", "3"))),
        "data": env.get("PFPP_BENCH_DATA",
                        os.path.join(tempfile.gettempdir(), "pfpp_bench_data_torch")),
        "precision": env.get("PFPP_BENCH_PRECISION", "fp32"),
        "bucket": bool(int(env.get("PFPP_BENCH_BUCKET", "1"))),
    }


def ensure_data(data_dir: str, max_parts: int = 12) -> str:
    """The 32 bench shapes (test-mode pc_data and matching_data) under ``data_dir``, made
    once: written to a temporary directory and renamed, so that no reader sees a
    half-written tree."""
    from puzzlefusion_plusplus_tpu_torch.data.synthetic import generate_dataset

    if not os.path.exists(os.path.join(data_dir, f".done_{NUM_BENCH_SHAPES}")):
        tmp = f"{data_dir}.{os.getpid()}.tmp"
        generate_dataset(tmp, num_shapes=NUM_BENCH_SHAPES, seed=SEED, split="val",
                         min_parts=3, max_parts=max_parts)
        open(os.path.join(tmp, f".done_{NUM_BENCH_SHAPES}"), "w").close()
        try:
            os.rename(tmp, data_dir)
        except OSError:  # another process finished first
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    return data_dir


def config(data_dir: str, precision: str = "fp32", batch: int = 8):
    """``Config()`` at full width, reading the bench data in ``data_dir``."""
    from puzzlefusion_plusplus_tpu_torch.utils.config import Config

    cfg = Config()
    cfg.trainer.num_devices = 1
    cfg.trainer.precision = precision
    cfg.inference.batch_size = batch  # also picks the normals' layout (run.py)
    cfg.inference.save_trajectories = False
    return with_data(cfg, data_dir)


def with_data(cfg, data_dir: str):
    cfg.data.data_val_dir = os.path.join(data_dir, "pc_data", "val")
    cfg.data.matching_data_path = os.path.join(data_dir, "matching_data")
    return cfg


def _dataset(cfg):
    from puzzlefusion_plusplus_tpu_torch.data.datasets import DenoiserDataset

    return DenoiserDataset(cfg.data.data_val_dir, mode="test",
                           matching_data_path=cfg.data.matching_data_path,
                           max_num_part=cfg.data.max_num_part)


def _bucketed(cfg, batch: dict) -> dict:
    """The batch sliced to its part bucket, as ``run_inference`` slices it."""
    from puzzlefusion_plusplus_tpu_torch.data.bucketing import slice_to_bucket

    return slice_to_bucket(batch, cfg.inference.part_bucket_multiple, cfg.data.max_num_part)


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _timed_calls(engine, samples: list, repeats: int) -> list[float]:
    """Seconds of each pass over ``samples``; each call ends with ``part_acc`` on the host."""
    import numpy as np
    import torch

    times = []
    for r in range(repeats):
        t0 = time.perf_counter()
        for s in samples:
            gen = torch.Generator(device=engine.device).manual_seed(r + 1)
            np.asarray(engine(s, generator=gen)["part_acc"])
        times.append(time.perf_counter() - t0)
    return times


def _result(metric: str, n: int, calls: int, times: list, cfg, engine, extra: dict) -> dict:
    """The JSON line: ``n`` shapes served by ``calls`` engine calls a pass."""
    import numpy as np

    value = n / min(times)
    base = REFERENCE_CPU_ASSEMBLIES_PER_SEC
    return {
        "metric": metric, "value": round(value, 4), "unit": "assemblies/s",
        "vs_baseline": round(value / base, 2) if base else None,
        "extra": {
            "device": _device_name(engine.device), "precision": cfg.trainer.precision,
            "sa_gather": engine.sa_gather, **extra,
            "p50_denoise_verify_iter_latency_s":
                round(float(np.median(times)) / (n * cfg.verifier.max_iters), 6),
            "runs_s": [round(t, 4) for t in times],
            "timing_suspect": min(times) < SUSPECT_S * calls,
        },
    }


def measure(cfg, device, data_dir: str, batch: int = 8, repeats: int = 3,
            bucket: bool = True, models=None) -> dict:
    """The default metric on ``device``: the first ``batch`` shapes of ``data_dir`` through
    the engine of ``cfg`` (``models``: prebuilt modules, as ``build_engine_fn`` takes them)."""
    import numpy as np

    from puzzlefusion_plusplus_tpu_torch.data.loader import Loader
    from puzzlefusion_plusplus_tpu_torch.inference.run import SAMPLE_KEYS, build_engine_fn

    cfg = with_data(cfg, data_dir)
    b = next(iter(Loader(_dataset(cfg), batch, shuffle=False, drop_last=False, seed=0)))
    if bucket:
        b = _bucketed(cfg, b)
    sample = {k: np.asarray(b[k][:batch]) for k in SAMPLE_KEYS}
    n, P = sample["part_valids"].shape
    engine = build_engine_fn(cfg, device, models=models)
    t0 = time.perf_counter()
    _timed_calls(engine, [sample], 1)  # warm-up: builds the kernels
    build_s = time.perf_counter() - t0
    times = _timed_calls(engine, [sample], repeats)
    return _result("assemblies_per_sec_per_chip", n, 1, times, cfg, engine,
                   {"batch": n, "part_pad": P, "build_s": round(build_s, 3)})


def measure_serving(cfg, device, data_dir: str, batch: int = 8, repeats: int = 3,
                    models=None, full_range: bool = False) -> dict:
    """``--serving``: every shape of ``data_dir`` in part-count-sorted batches, each sliced
    to its bucket's pad; one warm-up call a distinct (batch, pad) before the timed passes."""
    import numpy as np

    from puzzlefusion_plusplus_tpu_torch.data.loader import Loader
    from puzzlefusion_plusplus_tpu_torch.inference.run import SAMPLE_KEYS, build_engine_fn

    cfg = with_data(cfg, data_dir)
    ds = _dataset(cfg)
    mult = cfg.inference.part_bucket_multiple
    order = np.argsort(ds.num_parts_list(), kind="stable") if mult else None
    samples = []
    for b in Loader(ds, batch, shuffle=False, drop_last=False, seed=0, order=order):
        b = _bucketed(cfg, b)
        samples.append({k: np.asarray(b[k]) for k in SAMPLE_KEYS})
    pads = sorted({s["part_valids"].shape for s in samples})
    engine = build_engine_fn(cfg, device, models=models)
    t0 = time.perf_counter()
    build_s, warmed = None, set()
    for s in samples:
        if s["part_valids"].shape not in warmed:
            warmed.add(s["part_valids"].shape)
            _timed_calls(engine, [s], 1)
            build_s = build_s if build_s is not None else time.perf_counter() - t0
    warm_s = time.perf_counter() - t0
    times = _timed_calls(engine, samples, repeats)
    n = sum(s["part_valids"].shape[0] for s in samples)
    counts = ds.num_parts_list()
    return _result(
        "serving_assemblies_per_sec_3to20_parts" if full_range
        else "serving_assemblies_per_sec_full_set", n, len(samples), times, cfg, engine,
        {"batch": batch, "part_pad": max(p for _, p in pads), "build_s": round(build_s, 3),
         "n_shapes": n, "pads": [list(p) for p in pads],
         "part_counts": {"min": int(counts.min()), "max": int(counts.max()),
                         "mean": round(float(counts.mean()), 1)},
         "warm_s": round(warm_s, 3)})


def cpu_host() -> str:
    """The host CPU as ``/proc/cpuinfo`` names it (model name, else vendor, family and
    model numbers), for the CPU baseline's record."""
    info = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = info.get("model name", "")
    if name and name != "unknown":
        return name
    ids = [info.get(k) for k in ("vendor_id", "cpu family", "model")]
    return " ".join(f"{k} {v}" for k, v in zip(("vendor", "family", "model"), ids) if v) or (
        platform.processor() or "unknown")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--help" in argv or "-h" in argv:  # no torch device, no kernel build
        print(__doc__)
        print(USAGE)
        return 0
    import torch

    s = settings()
    cpu = "--cpu-baseline" in argv
    device = torch.device("cpu" if cpu else "cuda")
    if "--full-range" in argv or "--serving" in argv:
        full = "--full-range" in argv
        data = ensure_data(s["data"] + ("_full20" if full else ""), 20 if full else 12)
        out = measure_serving(config(data, s["precision"], s["batch"]), device, data,
                              s["batch"], s["repeats"], full_range=full)
    else:
        batch = 1 if cpu else s["batch"]
        data = ensure_data(s["data"])
        out = measure(config(data, s["precision"], batch), device, data, batch, s["repeats"],
                      s["bucket"])
        if cpu:
            out["extra"].update(host_cpu=cpu_host(), threads=torch.get_num_threads(),
                                host_cores=os.cpu_count())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
