"""One training step on two devices from the same weights and batch, compared.

This is how the port shows that its step on the card computes what its step on the CPU
(the kernels' plain versions, through the same ``autograd.Function``s) computes: the loss
and metrics, every parameter's gradient, the buffers (BatchNorm's running statistics), and
the parameters after the AdamW update. ``step_on`` runs a VQ-VAE step (kernels A, B, F, G,
N), ``denoiser_step_on`` a denoiser step (the frozen encoder's kernels F, G, A, or S with
``encode_cached``). ``chip_smoke.py`` (phases ``train_parity`` and ``denoiser_parity``) and
``tests/test_torch_port_cuda.py`` run them.

Tolerances and why (``compare``):
  * loss and metrics 1e-5 relative;
  * the gradients of conv6, the decoder and the codebook within 1e-3 of their largest
    entry plus 1e-5 (the card's GEMMs sum in another order);
  * the gradients of the SA stages within 5e-2 in relative L2 norm. They are ill-conditioned
    in the inputs' last bits: where two of the K neighbours' activations sit within float
    error of each other, the max over K routes the gradient to either, and ReLU and
    train-mode BatchNorm pass that on. On the CPU alone, a relative perturbation of 1e-6
    of the SA weights moves these gradients by about 1e-2 in relative L2 norm
    (``tests/test_torch_port_training.py`` measures it), while a missing or wrong gradient
    is off by about 1. The bias of
    each SA conv has true gradient 0 (a train-mode BatchNorm subtracts it again): on both
    devices it must stay float noise, below 1e-3 of its kernel's largest gradient entry;
  * running statistics 1e-4 relative plus 1e-5;
  * parameters after the step: Adam's first update is about ``lr * sign(g)``, so where the
    gradient clearly differs from 0 (beyond twice its elementwise tolerance; for the SA
    stages beyond 0.1 of the largest entry) the parameters agree to 1e-6, and elsewhere
    to 2 lr.
The denoiser step is held to the same tolerances (it has no SA stage and no BatchNorm, so
all its gradients are held elementwise), with its injected timesteps and noise, dropout
off, and the same frozen-encoder codes on both devices (``denoiser_step_on`` returns the
smallest code margin so a caller can check that no code sat within float error of a tie).
The verifier step (``verifier_step_on``) is held to them too, with dropout off: its loss
1e-5 relative, every gradient elementwise. The matcher's step (``matching_step_on``, all
three losses on, kernels F, G and B) is held to ``MATCHING``: its whole step is
ill-conditioned, so every gradient is held in relative L2 norm and the biases with true
gradient 0 to float noise; its losses are held to 1e-5 relative as the other steps' are
(see ``MATCHING``). A step under ``trainer.precision=bf16`` is held to ``BF16``.

``dp_steps`` runs the same steps data-parallel: each case's global batch split over
``world`` ranks (``parallel/``), the result rank 0's, plus every rank's buffers under
``rank_buffers``. ``compare`` holds it to the one-process step (``dp_steps`` at world 1, the
same code in this process) with the tolerances above; ``chip_smoke.py`` (phase ``dp``) and
``tests/test_torch_port_parallel.py`` run it. ``measured`` (and ``serving``, for the
inference entry) reads a data-parallel entry's times, launch counts and peak device memory
on every rank.
"""

from __future__ import annotations

import dataclasses
import functools
import re
import time
from typing import Callable

import torch
import torch.distributed as dist

from puzzlefusion_plusplus_tpu_torch import ops
from puzzlefusion_plusplus_tpu_torch.inference.sampler import (
    build_feature_cache,
    make_frozen_encoder,
)
from puzzlefusion_plusplus_tpu_torch.matching import train as match_train
from puzzlefusion_plusplus_tpu_torch.models.scheduler import DDPMParams, add_noise
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE
from puzzlefusion_plusplus_tpu_torch.parallel import launch, mesh
from puzzlefusion_plusplus_tpu_torch.training import denoiser as den_train
from puzzlefusion_plusplus_tpu_torch.training import verifier as ver_train
from puzzlefusion_plusplus_tpu_torch.training.state import (
    adam_cosine,
    adamw_multistep,
    adamw_reference,
)
from puzzlefusion_plusplus_tpu_torch.training.vqvae import METRIC_KEYS, to_device, train_step
from puzzlefusion_plusplus_tpu_torch.utils.masking import compact_parts
from puzzlefusion_plusplus_tpu_torch.utils.transforms import quat_normalize, quat_to_matrix


def spread_codebook(model: VQVAE, seed: int = 0) -> None:
    """Codebook entries of unit scale, as a trained codebook's: the init's +-1/n_e entries
    leave codes within 3e-6 of a tie at full width, so float error could pick another."""
    gen = torch.Generator().manual_seed(seed)
    w = model.vector_quantization.embedding.weight
    with torch.no_grad():
        w.copy_(torch.rand(w.shape, generator=gen) * 2 - 1)


def step_on(make_model, state_dict: dict, batch: dict, device, lr: float = 5e-4,
            weight_decay: float = 1e-6) -> dict:
    """One ``train_step`` on ``device`` -> loss metrics, gradients, BatchNorm buffers and
    parameters after the update, all on the CPU."""
    model = make_model().to(device).reduce_over(mesh.data_group())
    model.load_state_dict(state_dict)
    state = adamw_multistep(model, lr, (), 0.5, weight_decay)
    metrics = train_step(state, to_device(batch, device))
    return _result(model, metrics, lr)


def _result(model, metrics: dict, lr: float) -> dict:
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
        "buffers": {n: b.detach().cpu() for n, b in model.named_buffers()
                    if b.is_floating_point()},
        "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
        "lr": lr,
    }


def denoiser_step_on(make_model, state_dict: dict, make_encoder, batch: dict, device,
                     timesteps: torch.Tensor, noise: torch.Tensor, encode_cached: bool = False,
                     lr: float = 2e-4, weight_decay: float = 1e-6) -> dict:
    """One denoiser ``train_step`` on ``device`` with the given timesteps [B] and noise
    [B, P, 7]; ``make_model()`` must build the denoiser without dropout and
    ``make_encoder(device)`` the frozen encoder. -> ``step_on``'s result plus
    ``code_margin``, the smallest gap between a valid part's nearest and second-nearest
    code distances."""
    model = make_model().to(device)
    model.load_state_dict(state_dict)
    encoder = make_encoder(device)
    state = adamw_reference(model, lr, weight_decay=weight_decay)
    batch = to_device(batch, device)
    metrics = den_train.train_step(state, batch, encoder, DDPMParams.piecewise(), None, None,
                                   encode_cached, timesteps.to(device), noise.to(device))
    margin = code_margin(encoder, batch, timesteps.to(device), noise.to(device))
    return {**_result(model, metrics, lr), "code_margin": margin}


def verifier_step_on(make_model, state_dict: dict, batch: dict, device, lr: float = 2e-4,
                     weight_decay: float = 1e-6, negative_weight: float = 0.2) -> dict:
    """One verifier ``train_step`` on ``device``; ``make_model()`` must build the verifier
    without dropout. -> ``step_on``'s result."""
    model = make_model().to(device)
    model.load_state_dict(state_dict)
    state = adamw_reference(model, lr, weight_decay=weight_decay)
    metrics = ver_train.train_step(state, to_device(batch, device), negative_weight)
    return _result(model, metrics, lr)


def matching_step_on(make_model, state_dict: dict, batch: dict, device, lr: float = 1e-3,
                     w_mat: float = 1.0, w_rig: float = 1.0) -> dict:
    """One matcher ``train_step`` on ``device`` with all three losses on, Adam at ``lr``
    (the first update of a cosine schedule). -> ``step_on``'s result."""
    model = make_model().to(device).reduce_over(mesh.data_group())
    model.load_state_dict(state_dict)
    state = adam_cosine(model, lr, 1000)
    metrics = match_train.train_step(state, to_device(batch, device), w_mat, w_rig)
    return _result(model, metrics, lr)


def encoder_maker(make_ae, ae_state_dict: dict):
    """A picklable ``make_encoder(device)`` for ``denoiser_step_on``: the frozen encoder of
    ``make_ae()`` with ``ae_state_dict`` loaded."""
    return functools.partial(_frozen_encoder, make_ae, ae_state_dict)


def _frozen_encoder(make_ae, ae_state_dict: dict, device):
    model = make_ae()
    model.load_state_dict(ae_state_dict)
    return make_frozen_encoder(model.to(device))


def _rank_step(kind: str, make_model, state_dict: dict, batch: dict, device,
               make_encoder=None, timesteps=None, noise=None) -> dict:
    """This rank's part of one step of ``kind`` ('vqvae', 'denoiser', 'verifier' or
    'matching') on the global ``batch`` (the denoiser's ``timesteps`` and ``noise`` are the
    global batch's)."""
    rank, world = mesh.rank(), mesh.world()
    rows = mesh.shard_batch({k: v for k, v in batch.items() if hasattr(v, "shape")}, rank,
                            world)
    if kind == "vqvae":
        res = step_on(make_model, state_dict, rows, device)
    elif kind == "matching":
        res = matching_step_on(make_model, state_dict, rows, device)
    elif kind == "denoiser":
        b = len(rows["part_valids"])
        own = slice(rank * b, (rank + 1) * b)
        res = denoiser_step_on(make_model, state_dict, make_encoder, rows, device,
                               timesteps[own], noise[own])
    else:
        res = verifier_step_on(make_model, state_dict, rows, device)
    gathered = [res["buffers"]]
    if world > 1:
        gathered = [None] * world
        dist.all_gather_object(gathered, res["buffers"])
    return {**res, "rank_buffers": gathered}


def _rank_steps(cases: dict, device) -> dict:
    return {name: _rank_step(device=device, **case) for name, case in cases.items()}


def dp_steps(cases: dict, world: int, device, share_card: bool = False,
             join_timeout_s: float | None = None) -> dict:
    """One step of every case ({name: ``_rank_step``'s keyword arguments}) at world size
    ``world`` -> {name: rank 0's ``step_on``-style result with ``rank_buffers``}; world 1
    runs in this process. The models must be picklable factories (``functools.partial``)."""
    if world == 1:
        return _rank_steps(cases, device)
    return launch.run(_rank_steps, (cases, device), world, device, share_card=share_card,
                      join_timeout_s=join_timeout_s)


def measured(fn, args: tuple, calls: int = 1) -> dict:
    """``fn(*args)`` ``calls`` times on this rank, with its launch counts and peak device
    memory read around them -> {"result": the last call's (a trainer's state stays in its
    rank: pass ``launch.discard_result`` and the trainer as ``fn``), "seconds": per call, "peak_bytes": per rank, "launches": summed over the calls and the
    ranks}. A worker for ``launch.run``, or a plain call on one process."""
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    seconds = []
    for _ in range(calls):
        t0 = time.perf_counter()
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    mine = {"peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
            "launches": ops.launch_counts()}
    ranks = [mine]
    if mesh.world() > 1:
        ranks = [None] * mesh.world()
        dist.all_gather_object(ranks, mine)
    return {"result": out, "seconds": seconds,
            "peak_bytes": [r["peak_bytes"] for r in ranks],
            "launches": {k: sum(r["launches"][k] for r in ranks) for k in mine["launches"]}}


def serving(cfg, device, calls: int) -> dict:
    """``measured`` over ``calls`` calls of ``inference/run.py::run_inference`` with one
    engine built first, as a server keeps it (a worker for ``launch.run``)."""
    from puzzlefusion_plusplus_tpu_torch.inference import run

    engine = run.build_engine_fn(cfg, device)
    return measured(run.run_inference, (cfg, device, None, engine), calls)


@torch.no_grad()
def code_margin(encoder, batch: dict, timesteps: torch.Tensor, noise: torch.Tensor) -> float:
    """The smallest code-distance gap (second-nearest minus nearest) over the parts, each
    encoded at the noisy rotation that a denoiser step with these draws gives it."""
    gt = torch.cat([batch["part_trans"], batch["part_rots"]], -1)
    ref = batch["ref_part"].bool()[..., None]
    noisy = torch.where(ref, gt, add_noise(DDPMParams.piecewise(), gt, noise, timesteps))
    cache = build_feature_cache(encoder, batch["part_pcs"], batch["part_valids"])
    B, P = gt.shape[:2]
    quat = compact_parts(quat_normalize(noisy[..., 3:]), cache.src).reshape(B * P, 4)
    z_e = encoder.encode(cache.idx_stages, cache.geom_stages, quat_to_matrix(quat))["z_e"]
    d = torch.cdist(z_e.reshape(-1, encoder.e_dim), encoder.w["codebook"]) ** 2
    two = d.topk(2, dim=-1, largest=False).values
    return float((two[:, 1] - two[:, 0]).min())


def _pre_bn_bias(name: str) -> bool:
    return ".mlp_convs." in name and name.endswith(".bias")


def _kernel_scale(grads: dict, name: str) -> float:
    return grads[name[: -len("bias")] + "weight"].abs().max().item()


# The matcher's parameters whose true gradient is 0: a bias that a train-mode BatchNorm
# subtracts again (every conv before a BatchNorm, the PointTransformer's q/k biases and
# linear_p0/linear_w0), one that a softmax over the neighbours removes (linear_w1), and the
# last LayerNorm's bias, a shift of every point that cls_bn and aff_bn subtract
_MATCHING_ZERO = re.compile(
    r"encoder\.(sa\d\.conv\d_\d|fp\d\.conv\d|conv1|edge\d)\.bias$"
    r"|tf_self1\.linear_(q|k|p0|w0|w1)\.bias$|tf_cross1\.pos_ffn\.layer_norm\.bias$")


def _block_scale(grads: dict, name: str) -> float:
    """The largest gradient entry of the weights of ``name``'s block (its first two name
    parts, such as ``encoder.sa1`` or ``tf_cross1.pos_ffn``)."""
    block = ".".join(name.split(".")[:2]) + "."
    return max(g.abs().max().item() for n, g in grads.items()
               if n.startswith(block) and n.endswith("weight"))


@dataclasses.dataclass(frozen=True)
class Tolerances:
    """What ``compare`` holds a step to. ``l2_grad``: the parameters whose gradients are
    compared in relative L2 norm (the rest elementwise); ``zero_grad``: those whose true
    gradient is 0, held to float noise below ``NOISE`` of ``zero_scale``'s entry;
    ``signed_clear``: an entry of a gradient held in L2 norm counts as clear of 0 for the
    step check only from ``CLEAR_FLOOR`` and where both gradients share its sign."""

    metric_rel: float = 1e-5
    metric_floor: float = 1e-30
    l2_grad: Callable[[str], bool] = lambda n: n.startswith("pn2.sa")
    zero_grad: Callable[[str], bool] = _pre_bn_bias
    zero_scale: Callable[[dict, str], float] = _kernel_scale
    signed_clear: bool = False


NOISE, CLEAR_FLOOR = 1e-3, 1e-5


# The matcher's step is ill-conditioned as a whole: its train-mode BatchNorms sit over few
# distinct rows in the encoder (the ball query repeats its first hit) and feed one another
# down to the Sinkhorn loss. On the CPU alone a relative perturbation of 1e-6 of the weights
# moves the gradients by up to 1.2e-2 in relative L2 norm
# (tests/test_torch_port_matching_training.py measures it), so every gradient is held in
# relative L2 norm, as the VQ-VAE's SA stages are. The losses are held to 1e-5 relative, as
# the other steps' (the rigid loss, which is 0 wherever a pair's matches fit exactly,
# against a floor of 1e-6). Adam's first update, lr g / (|g| + 1e-8), is lr sign(g) only
# where |g| is well above its epsilon, and at full width a few entries above 0.1 of their
# tensor's largest flip sign between one process and two ranks, within the L2 bound: so
# ``signed_clear``.
MATCHING = Tolerances(metric_floor=1e-6, l2_grad=lambda n: True,
                      zero_grad=lambda n: bool(_MATCHING_ZERO.search(n)),
                      zero_scale=_block_scale, signed_clear=True)
# The tests' small matchers (128-320 points, sa_npoints (32, 16, 8, 4)) are worse
# conditioned: there a 1e-6 perturbation of the weights moves the losses by up to 1e-4
# relative, two ranks and one process are up to 3e-5 apart and the JAX package's step and
# the port's 5e-4, so their losses are held to 2e-3
# (tests/test_torch_port_matching_training.py measures each, and shows that a planted fault
# still fails).
MATCHING_SMALL = dataclasses.replace(MATCHING, metric_rel=2e-3)


# trainer.precision=bf16: every bf16 product is rounded to bf16 after summing in fp32, and
# the card and the CPU sum in other orders, so a few activations round the other way and
# attention, then the backward, spread each such flip. The JAX package's bf16 step against
# the port's on the CPU differs by 1.9e-4 relative in the loss and up to 3.6e-2 in relative
# L2 norm in a gradient (tests/test_torch_port_bf16.py, which holds them to these limits).
# So the loss is held to 2e-3 relative and every gradient in relative L2 norm; the denoiser
# has no parameter whose true gradient is 0.
BF16 = Tolerances(metric_rel=2e-3, l2_grad=lambda n: True, zero_grad=lambda n: False,
                  signed_clear=True)


GRAD_REL, GRAD_ATOL, SA_GRAD_REL_L2 = 1e-3, 1e-5, 5e-2


def compare(ref: dict, out: dict, metric_keys=METRIC_KEYS, tol: Tolerances = Tolerances()
            ) -> dict:
    """Max errors of ``out`` against ``ref`` (two ``step_on``-style results); raises
    AssertionError naming every quantity outside its tolerance (``tol``: the VQ-VAE,
    denoiser and verifier steps' by default, ``MATCHING`` for the matcher's)."""
    bad, errs = [], {}
    for k in metric_keys:
        e = abs(out["metrics"][k] - ref["metrics"][k]) / max(abs(ref["metrics"][k]),
                                                              tol.metric_floor)
        errs[f"metric/{k}"] = e
        if e > tol.metric_rel:
            bad.append(f"{k}: rel err {e}")
    grad_rel, sa_l2, sa_max, clear = 0.0, 0.0, 0.0, {}
    for n, g in ref["grads"].items():
        o = out["grads"][n]
        if tol.zero_grad(n):
            scale = tol.zero_scale(ref["grads"], n)
            noise = max(g.abs().max().item(), o.abs().max().item()) / max(scale, 1e-30)
            errs[f"bias_noise/{n}"] = noise
            if noise > NOISE:
                bad.append(f"{n}: gradient {noise} of its scale, should be float noise")
            clear[n] = torch.zeros_like(g, dtype=torch.bool)
            continue
        gmax = g.abs().max().item()
        e = (o - g).abs().max().item()
        if tol.l2_grad(n):
            l2 = ((o - g).norm() / g.norm().clamp_min(1e-30)).item()
            sa_l2, sa_max = max(sa_l2, l2), max(sa_max, e / max(gmax, 1e-30))
            if l2 > SA_GRAD_REL_L2:
                bad.append(f"grad {n}: relative L2 error {l2} > {SA_GRAD_REL_L2}")
            clear[n] = g.abs() > 0.1 * gmax
            if tol.signed_clear:
                clear[n] &= g.abs() > CLEAR_FLOOR
                flips = clear[n] & (g * o <= 0)
                errs["clear_sign_flips"] = errs.get("clear_sign_flips", 0) + int(flips.sum())
                clear[n] &= ~flips
            continue
        grad_rel = max(grad_rel, e / max(gmax, 1e-30))
        tol_n = GRAD_REL * gmax + GRAD_ATOL
        if e > tol_n:
            bad.append(f"grad {n}: max err {e} > {tol_n}")
        clear[n] = g.abs() > 2 * tol_n
    errs["grad_max_rel"] = grad_rel
    errs["sa_grad_rel_l2"], errs["sa_grad_max_rel"] = sa_l2, sa_max
    for n, b in ref["buffers"].items():
        e = (out["buffers"][n] - b).abs().max().item()
        errs[f"buffer/{n}"] = e
        if e > 1e-4 * b.abs().max().item() + 1e-5:
            bad.append(f"buffer {n}: max err {e}")
    step_clear, step_other, worst = 0.0, 0.0, ""
    for n, p in ref["params"].items():
        err = (out["params"][n] - p).abs()
        e = err[clear[n]].max().item() if clear[n].any() else 0.0
        if e > step_clear:
            step_clear, worst = e, n
        step_other = max(step_other, err.max().item())
    errs["param_after_step_clear"], errs["param_after_step_any"] = step_clear, step_other
    if step_clear > 1e-6 or step_other > 2 * ref["lr"] + 1e-6:
        bad.append(f"parameters after the step: {step_clear} where g is clear (at {worst}), "
                   f"{step_other} anywhere")
    if bad:
        raise AssertionError("devices disagree:\n" + "\n".join(bad))
    return {k: float(v) for k, v in errs.items() if not k.startswith(("buffer/", "bias_"))} | {
        "buffer_max": max((v for k, v in errs.items() if k.startswith("buffer/")), default=0.0),
        "pre_bn_bias_noise_max": max((v for k, v in errs.items() if k.startswith("bias_")),
                                     default=0.0),
    }
