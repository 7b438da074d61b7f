"""The serving cells: the program's engine (``inference/run.py::build_engine_fn``) in a
closed loop with one client.

Set-up makes the cell's requests from the seed (``traffic/shapes.py``), draws the weights
on the card (``reference/params.py``), builds the engine and runs one call for each distinct
(batch, part pad) of the requests. The window then sends the requests in turn, looping over
the set, each with its own noise drawn from the seed; each call ends when its ``part_acc``
is on the host, and the window ends with the pass over the set during which ``seconds``
passed, so that every window serves the same mix of pads. A traced run adds
``trace_calls`` calls under the profiler at the window's end.

The check follows a sample of the finished calls, drawn from the seed with the largest
part pad in it, through the plain reference (``reference/engine.py``) once the window has
closed, the peak memory has been read and the program's models are freed. Each call's
trajectory of poses, ``part_acc`` and iteration count are the engine's own outputs. Thin
wrappers around the denoiser's and the verifier's ``forward`` keep references to the state
each denoising step started from and to the verifier's logits; a call whose record holds
one distinct state a step and one set of logits a verify pass is followed one step at a
time (``pose_gap``, ``logit_gap``). Where the program does not show its steps so, as when the program replays a captured graph in place of
those calls, the reference runs the call free from the same noise and its trajectory is
compared with the engine's over the first ``check.free_steps`` steps (``free_pose_gap``):
later, float32 rounding compounds as far as the TF32 control's gap.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from pfpp_bench import flops, harness, seeds
from pfpp_bench.reference import engine as ref_engine
from pfpp_bench.trace import Slice, Spans
from pfpp_bench.traffic import shapes

SPANS = ("engine_call", "denoise", "encoder_cache", "encoder", "denoiser", "verify")
NOISE_SALT, CHECK_SALT, WARM_SALT = 7, 9, 11


class Recorder:
    """Keeps, per call, the denoiser's input states and the verifier's logits."""

    def __init__(self, denoiser, verifier):
        self.calls, self.current = {}, None
        self._restore = []
        for module, keep in ((denoiser, self._keep_x), (verifier, self._keep_logits)):
            fwd = module.forward

            def wrapped(*args, _fwd=fwd, _keep=keep, **kwargs):
                out = _fwd(*args, **kwargs)
                if self.current is not None:
                    _keep(args, out)
                return out

            module.forward = wrapped
            self._restore.append(module)

    def _keep_x(self, args, out):
        self.current["x"].append(args[0])

    def _keep_logits(self, args, out):
        self.current["logits"].append(out[..., 0])

    def begin(self, i):
        self.current = self.calls.setdefault(i, {"x": [], "logits": []}) if i is not None else None

    def close(self):
        for m in self._restore:
            del m.forward
        self.current = None


def call_noise(seed: int, i: int, B: int, P: int, cfg: dict, device, salt: int = NOISE_SALT):
    """(init [B, P, 7], steps [iters * S, B, P, 7]) of call ``i``, drawn at the 20-part pad
    and sliced to P, so that a part's noise does not depend on its batch's pad."""
    g = torch.Generator(device=device).manual_seed(seeds.derive(seed, salt, i))
    Pn = max(P, cfg["data"]["max_num_part"])
    S = cfg["engine"]["max_iters"] * cfg["engine"]["num_inference_steps"]
    init = torch.randn((B, Pn, 7), generator=g, device=device)
    steps = torch.randn((S, B, Pn, 7), generator=g, device=device)
    return init[:, :P].contiguous(), steps[:, :, :P].contiguous()


def _tensors(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()}


class Serving:
    """The program's engine at the seed's weights, with the seed's requests."""

    def __init__(self, w: dict, cfg: dict, seed: int, device, workers: int,
                 marks: dict | None = None):
        from puzzlefusion_plusplus_tpu_torch.inference.run import build_engine_fn

        marks = {} if marks is None else marks
        self.cfg, self.seed, self.device = cfg, seed, device
        t = time.time()
        pending = shapes.make_shapes(w["traffic"], seed, cfg["data"]["points_per_part"],
                                     workers)  # made while the models are built
        prog_cfg = harness.program_config(cfg, batch=w["traffic"]["batch"])
        self.models = harness.program_models(cfg, prog_cfg, device)
        weights = harness.draw_weights(cfg, seed, device)
        for name, m in self.models.items():
            harness.load(m, weights[name])
        m = self.models
        self.engine = build_engine_fn(prog_cfg, device,
                                      models=(m["vqvae"], m["denoiser"], m["verifier"]))
        self.rec = Recorder(m["denoiser"], m["verifier"])
        self.calls = []
        marks["build_s"] = time.time() - t
        self.batches = shapes.engine_batches(w["traffic"], pending.get(), seed,
                                             cfg["data"]["max_num_part"])
        marks["traffic_s"] = time.time() - t

    def batch(self, i: int) -> dict:
        return self.batches[i % len(self.batches)]

    def warm(self) -> None:
        """One call for each (batch, pad) the requests use, unrecorded."""
        warmed = set()
        for k, b in enumerate(self.batches):
            shape = b["part_valids"].shape
            if shape not in warmed:
                warmed.add(shape)
                self.engine(b, noise=call_noise(self.seed, k, *shape, self.cfg, self.device,
                                                WARM_SALT))
        harness.sync(self.device)

    def call(self, i: int):
        """Request ``i`` -> (seconds until its part_acc was on the host, shapes, end time)."""
        b = self.batch(i)
        noise = call_noise(self.seed, i, *b["part_valids"].shape, self.cfg, self.device)
        self.rec.begin(i)
        ts = time.perf_counter()
        out = self.engine(b, noise=noise)
        te = time.perf_counter()
        self.rec.begin(None)
        self.calls.append((i, out["part_acc"], out["trajectory"], int(out["n_iters"][0])))
        return te - ts, len(b["num_parts"]), te

    def records(self, picked) -> dict:
        """The program's record of the calls at these positions of ``calls``."""
        out = {}
        for k in picked:
            j, acc, traj, iters = self.calls[k]
            r = self.rec.calls.get(j, {"x": [], "logits": []})
            traj = torch.as_tensor(traj, device=self.device)
            out[j] = {"x": list(r["x"]), "logits": list(r["logits"]), "traj": traj,
                      "final": traj[:, -1],
                      "part_acc": torch.as_tensor(acc, device=self.device), "n_iters": iters}
        return out

    def close(self) -> None:
        """Drop the program's models and records."""
        self.rec.close()
        del self.engine, self.models, self.rec
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def pick(seed: int, calls: list, batches: list, n: int) -> list[int]:
    """Positions in ``calls`` to check: the largest part pad's first, then ``n - 1`` drawn
    from the seed."""
    order = np.random.default_rng(seeds.derive(seed, CHECK_SALT)).permutation(len(calls))
    pads = [batches[c[0] % len(batches)]["part_valids"].shape[1] for c in calls]
    longest = max(range(len(calls)), key=lambda k: (pads[k], -k))
    return [longest] + [int(k) for k in order if k != longest][:n - 1]


def run(w: dict, cfg: dict, seed: int, seconds: float, trace: bool, device, workers: int,
        t_start: float, chips: int = 1) -> dict:
    from puzzlefusion_plusplus_tpu_torch.inference import engine as prog_engine

    marks = {"start": time.time() - t_start}
    sv = Serving(w, cfg, seed, device, workers, marks)
    t = time.time()
    sv.warm()
    marks["warm_s"] = time.time() - t
    setup_s = time.time() - t_start

    lat, served, by_pad = [], 0, {}
    nb = len(sv.batches)
    t0 = time.perf_counter()
    i, te = 0, t0
    while te < t0 + seconds or i % nb:  # whole passes over the requests
        dt, n, te = sv.call(i)
        lat += [dt] * n
        served += n
        by_pad.setdefault(sv.batch(i)["part_valids"].shape[1], []).append(dt)
        i += 1
    pre = te
    if trace:
        spans = Spans()
        spans.wrap(prog_engine, "denoise_phase", "denoise")
        spans.wrap(prog_engine, "build_feature_cache", "encoder_cache")
        spans.wrap(prog_engine, "extract_features", "encoder")
        spans.wrap(prog_engine, "verify_and_merge", "verify")
        spans.wrap(sv.models["denoiser"], "forward", "denoiser")
        first = len(sv.calls)
        with Slice() as sl:
            for _ in range(w["trace_calls"]):
                with torch.profiler.record_function("engine_call"):
                    dt, n, te = sv.call(i)
                lat += [dt] * n
                served += n
                i += 1
        spans.restore()
        window_s = (pre - t0) + (te - sl.t0)  # the profiler's start and stop left out
    else:
        window_s = te - t0
    dev_rec = harness.device_record(device, 1)

    # what the window's finished shapes needed, and what the slice's encoder calls needed
    vq, pts = cfg["vqvae"], cfg["data"]["points_per_part"]
    work = sum(flops.engine_shape_flops(cfg, int(n), iters)
               for j, _, _, iters in sv.calls for n in sv.batch(j)["num_parts"])
    readings = {"window_s": window_s, "flops": work, "slice": None}
    if trace:
        red = sl.reduce(SPANS)
        enc_f = enc_b = 0
        for j, _, _, iters in sv.calls[first:]:
            valid = int(sv.batch(j)["num_parts"].sum())
            steps = iters * cfg["engine"]["num_inference_steps"]
            enc_f += steps * valid * flops.encoder_cached_flops(vq, pts)
            enc_b += steps * (valid * flops.encoder_bytes(vq, pts)
                              + flops.encoder_weight_bytes(vq))
        readings.update(slice=red, encoder_flops=enc_f, encoder_bytes=enc_b)
        dev_rec.update(busy_s=red["busy_s"], window_s=red["wall_s"])

    # the check: free the program, then follow the sample through the reference
    records = sv.records(pick(seed, sv.calls, sv.batches, w["check"]["calls"]))
    batches, sv_calls = sv.batches, sv.calls
    sv.close()
    t = time.time()
    checks = check(cfg, w, seed, batches, records, device)
    check_s = time.time() - t

    metrics = {"setup_s": setup_s, "assemblies_per_s": served / window_s,
               "assembly_latency_p90_s": float(np.percentile(lat, 90))}
    return {"metrics": metrics, "readings": readings, "checks": checks, "device": dev_rec,
            "attempted": served, "failed": 0,
            "counts": {"requests": served, "calls": i, "p90_samples": len(lat),
                       "window_s": window_s, "checked_calls": len(records),
                       "check_s": check_s, **marks,
                       "call_s_by_pad": {p: float(np.median(v)) for p, v in by_pad.items()},
                       "iterations": sorted({c[3] for c in sv_calls})}}


def stepwise(record: dict, cfg: dict) -> bool:
    """Whether the program showed each step of the call: one distinct state a denoising
    step and one set of logits a verify pass (the last iteration has none)."""
    iters, n = record["n_iters"], cfg["engine"]["max_iters"]
    xs = record["x"]
    return (len(xs) == iters * cfg["engine"]["num_inference_steps"]
            and len({t.data_ptr() for t in xs}) == len(xs)
            and len(record["logits"]) == (iters if iters < n else n - 1))


def check(cfg: dict, w: dict, seed: int, batches: list, records: dict, device,
          prec=None) -> dict:
    """The reference's gaps over the recorded calls -> {name: (value, limit)}. Each call is
    followed one step at a time where its record allows, else run free and compared over
    its first ``check.free_steps`` steps (``free_gaps``)."""
    from pfpp_bench.reference.numerics import FP32

    params = harness.draw_weights(cfg, seed, device)
    rcfg = {**cfg, "engine": {**cfg["engine"], **w["check"]["engine"]}}
    steps = w["check"].get("free_steps")
    pose = logit = free = None
    blocks, mismatch = [], 0
    for j, record in sorted(records.items()):
        b = _tensors(batches[j % len(batches)], device)
        noise = call_noise(seed, j, *b["part_valids"].shape, cfg, device)
        try:
            if stepwise(record, cfg):
                g = ref_engine.follow(params, rcfg, b, noise, record, prec or FP32)
                pose, logit = max(pose or 0.0, g["pose"]), max(logit or 0.0, g["logit"])
            else:
                ref = ref_engine.follow(params, rcfg, b, noise, None, prec or FP32)
                g = ref_engine.free_gaps(ref, record, b, steps)
                free = max(free or 0.0, g["pose"])
                blocks = [max(x) for x in itertools.zip_longest(blocks, g["by_block"],
                                                                fillvalue=0.0)]
        except ref_engine.MergeFired as e:
            harness.say(f"check: call {j}: {e}")
            mismatch += 1
            continue
        mismatch += g["mismatch"]
    lim = w["check"]["limits"]
    out = {}
    if pose is not None:
        out.update(pose_gap=(pose, lim["pose_gap"]), logit_gap=(logit, lim["logit_gap"]))
    if free is not None:
        out["free_pose_gap"] = (free, lim["free_pose_gap"])
        harness.say(f"check: free runs, largest pose gap by block of steps: {blocks}")
    out["mismatches"] = (mismatch, lim["mismatches"])
    return out
