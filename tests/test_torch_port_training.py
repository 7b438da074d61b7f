"""Parity of the port's VQ-VAE training slice with the JAX package, on the CPU, where every
kernel wrapper runs its plain PyTorch version through the same ``autograd.Function``
backward that the card runs with kernels A, B, G and N.

Tolerances and why:
  * B (scatter-add) and A (gather) against the Pallas kernels in interpret mode: forward
    values exact; scatter-add sums within 1e-6 absolute (the Pallas kernel sums a one-hot
    matmul in another order than the port's row-ordered index_add_).
  * nn_distance: values 1e-4 and gradients 1e-4 absolute. The JAX CPU path uses the
    expanded x^2 - 2xy + y^2 form, the port direct differences; the inputs are checked to
    have no near-tie (second-nearest more than 1e-4 away), so the indices agree.
  * MaskedBatchNorm: outputs and running statistics 1e-5 (sums in another order).
  * VectorQuantizer: codes exact (inputs checked to have margin > 1e-4 to the second
    code), loss and perplexity 1e-6 relative, gradients 1e-6.
  * VQ-VAE loss_fn: loss 1e-5 relative; every parameter gradient within 2e-4 of the
    largest entry of that gradient, plus 1e-5 absolute (measured: 5e-5 at most). The two
    frameworks sum the [M, S, K, C] activations in other orders, and a max over K whose two
    largest entries sit within float error may pick another neighbour; the chamfer and code
    margins of the fixture are checked. The one exception is the bias of each SA conv: a
    train-mode BatchNorm follows it and subtracts it again, so its true gradient is 0 and
    both frameworks return float noise; there both must stay below 1e-4 of the largest
    gradient entry of the conv's kernel.
  * train_step: parameters after one AdamW step within 1e-6 where |g| > 1e-4 of the
    gradient's largest entry (for an SA conv bias: of its kernel's, as above); elsewhere
    within 2 lr, since Adam's first step is about lr * sign(g) and a tiny gradient's sign
    may differ. BatchNorm statistics 1e-5.
  * Datasets: augmented arrays 1e-5 (the JAX package may augment in its native library).
"""

import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

from tests.helpers import jit_apply, jit_init

from puzzlefusion_plusplus_tpu.convert.torch_ckpt import convert_vqvae
from puzzlefusion_plusplus_tpu.data import generate_dataset as jgen
from puzzlefusion_plusplus_tpu.data.datasets import VQVAEDataset as JVQDS
from puzzlefusion_plusplus_tpu.data.loader import Loader as JLoader
from puzzlefusion_plusplus_tpu.models.vqvae import VQVAE as JVQ
from puzzlefusion_plusplus_tpu.models.vqvae import MaskedBatchNorm as JBN
from puzzlefusion_plusplus_tpu.models.vqvae import VectorQuantizer as JVQuant
from puzzlefusion_plusplus_tpu.ops import chamfer as jch
from puzzlefusion_plusplus_tpu.ops import gather_pallas as jgp
from puzzlefusion_plusplus_tpu.training import state as jstate
from puzzlefusion_plusplus_tpu.training import vqvae as jtrain
from puzzlefusion_plusplus_tpu_torch import ops
from puzzlefusion_plusplus_tpu_torch.convert import from_jax
from puzzlefusion_plusplus_tpu_torch.data import Loader, VQVAEDataset, generate_dataset
from puzzlefusion_plusplus_tpu_torch.models import vqvae as tvq
from puzzlefusion_plusplus_tpu_torch.ops import chamfer as tch
from puzzlefusion_plusplus_tpu_torch.ops import gather as tga
from puzzlefusion_plusplus_tpu_torch.training import parity
from puzzlefusion_plusplus_tpu_torch.training import state as tstate
from puzzlefusion_plusplus_tpu_torch.training import vqvae as ttrain
from puzzlefusion_plusplus_tpu_torch.utils.config import Config, apply_overrides

torch.set_num_threads(2)


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX package's Pallas gathers in interpret mode on the CPU."""
    monkeypatch.setattr(jgp.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


# ------------------------------------------------------------------ kernels B and A


@pytest.mark.parametrize("case", ["duplicates", "untouched_rows", "one_row", "one_index"])
def test_scatter_add_matches_pallas_interpret(pallas_interpret, case):
    rng = np.random.default_rng(0)
    B, N, C = 2, 40, 16
    shape = {"duplicates": (B, 8, 6), "untouched_rows": (B, 5, 3), "one_row": (B, 1),
             "one_index": (B, 9, 7)}[case]
    hi = {"duplicates": 6, "untouched_rows": N, "one_row": N, "one_index": 1}[case]
    idx = rng.integers(0, hi, size=shape).astype(np.int32)  # one_index: every row to 0
    g = rng.normal(size=shape + (C,)).astype(np.float32)
    ref = np.asarray(jgp._gather_bwd_pallas(jnp.asarray(idx), jnp.asarray(g), N))
    out = tga.scatter_add_plain(T(g).reshape(B, -1, C), T(idx).reshape(B, -1), N)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    if case in ("untouched_rows", "one_index"):
        hit = np.zeros((B, N), bool)
        for b in range(B):
            hit[b, idx[b].ravel()] = True
        assert (~hit).any() and (out.numpy()[~hit] == 0).all()
    # the same backward through the differentiable gather
    pts = torch.zeros((B, N, C), requires_grad=True)
    tga.gather_points(pts, T(idx)).backward(T(g))
    np.testing.assert_allclose(pts.grad.numpy(), ref, atol=1e-6)


def test_gather_approx_matches_pallas_interpret(pallas_interpret):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(2, 30, 12)).astype(np.float32)
    idx = rng.integers(0, 30, size=(2, 7, 5)).astype(np.int32)
    w = rng.normal(size=(2, 7, 5, 12)).astype(np.float32)
    ref = np.asarray(jgp.gather_points_approx(jnp.asarray(pts), jnp.asarray(idx)))
    jgrad = np.asarray(jax.grad(
        lambda p: (jgp.gather_points_approx(p, jnp.asarray(idx)) * w).sum())(jnp.asarray(pts)))
    p = T(pts).requires_grad_()
    out = tga.gather_points_approx(p, T(idx))
    np.testing.assert_array_equal(out.detach().numpy(), ref)
    (out * T(w)).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), jgrad, atol=1e-6)


def test_wrappers_count_nothing_on_cpu_and_raise_elsewhere():
    ops.reset_launch_counts()
    x = torch.zeros(1, 4, 3, requires_grad=True)
    tga.gather_points_approx(x, torch.zeros((1, 2), dtype=torch.int64)).sum().backward()
    tga.scatter_add(torch.ones(1, 2, 3), torch.zeros((1, 2), dtype=torch.int32), 4)
    assert all(v == 0 for v in ops.launch_counts().values())
    with pytest.raises(ValueError):
        tga.scatter_add(torch.ones(1, 2, 3, device="meta"),
                        torch.zeros((1, 2), dtype=torch.int32, device="meta"), 4)
    with pytest.raises(ValueError):
        tga.gather_points_approx(x.to("meta"), torch.zeros((1, 2), dtype=torch.int64,
                                                          device="meta"))


# ------------------------------------------------------------------ chamfer gradient


def _no_near_ties(x, y, margin=1e-4):
    d = np.sort(((x[:, :, None] - y[:, None]) ** 2).sum(-1), axis=-1)
    return float((d[..., 1] - d[..., 0]).min()) > margin


def test_nn_distance_gradient_both_inputs():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, size=(2, 60, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, size=(2, 45, 3)).astype(np.float32)
    w = rng.normal(size=(2, 60)).astype(np.float32)
    assert _no_near_ties(x, y)

    def jloss(a, b):
        return (jch.nn_distance(a, b)[0] * w).sum()

    jdx, jdy = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = T(x).requires_grad_(), T(y).requires_grad_()
    d, idx = tch.nn_distance(tx, ty)
    assert not idx.requires_grad
    (d * T(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-4)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jdy), atol=1e-4)

    # y as a plain input: no gradient asked for, none computed
    tx2 = T(x).requires_grad_()
    (tch.nn_distance(tx2, T(y))[0] * T(w)).sum().backward()
    np.testing.assert_allclose(tx2.grad.numpy(), tx.grad.numpy(), atol=0)


def test_chamfer_distance_default():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, size=(3, 50, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, size=(3, 70, 3)).astype(np.float32)
    assert _no_near_ties(x, y) and _no_near_ties(y, x)
    ref = float(jch.chamfer_distance_default(jnp.asarray(x), jnp.asarray(y)))
    jg = np.asarray(jax.grad(lambda a: jch.chamfer_distance_default(a, jnp.asarray(y)))(
        jnp.asarray(x)))
    tx = T(x).requires_grad_()
    out = tch.chamfer_distance_default(tx, T(y))
    out.backward()
    np.testing.assert_allclose(out.item(), ref, rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), jg, atol=1e-4)


# ------------------------------------------------------------------ BatchNorm, quantizer


@pytest.mark.parametrize("weighted", [False, True])
def test_masked_batchnorm_train(weighted):
    rng = np.random.default_rng(4)
    M, S, K, C = 5, 6, 4, 8
    x = rng.normal(1.0, 2.0, size=(M, S, K, C)).astype(np.float32)
    wts = np.array([1, 1, 0, 1, 0], np.float32) if weighted else None
    bn = JBN(use_running_average=False)
    variables = jit_init(bn, jax.random.key(0), jnp.asarray(x))
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(size=C).astype(np.float32)
    mean0 = rng.normal(size=C).astype(np.float32)
    var0 = rng.uniform(0.5, 2, C).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    y, mut = bn.apply(variables, jnp.asarray(x), None if wts is None else jnp.asarray(wts),
                      mutable=["batch_stats"])
    tbn = tvq.MaskedBatchNorm(C).train()
    with torch.no_grad():
        tbn.weight.copy_(T(scale))
        tbn.bias.copy_(T(bias))
        tbn.running_mean.copy_(T(mean0))
        tbn.running_var.copy_(T(var0))
    out = tbn(T(x), None if wts is None else T(wts))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), atol=1e-5)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), atol=1e-5)
    assert int(tbn.num_batches_tracked) == 1
    # eval mode uses the running statistics, as use_running_average=True does
    y_eval = JBN(use_running_average=True).apply(
        {"params": variables["params"], "batch_stats": mut["batch_stats"]}, jnp.asarray(x))
    np.testing.assert_allclose(tbn.eval()(T(x)).detach().numpy(), np.asarray(y_eval),
                               atol=1e-5)


def _code_margin(z, cb):
    d = np.sort(((z.reshape(-1, 1, z.shape[-1]) - cb[None]) ** 2).sum(-1), axis=-1)
    return float((d[:, 1] - d[:, 0]).min())


@pytest.mark.parametrize("masked", [False, True])
def test_vector_quantizer(masked):
    rng = np.random.default_rng(5)
    n_e, e_dim, B, Tk = 32, 16, 4, 10
    cb = rng.uniform(-1, 1, size=(n_e, e_dim)).astype(np.float32)
    z = rng.normal(size=(B, Tk, e_dim)).astype(np.float32)
    r = rng.normal(size=(B, Tk, e_dim)).astype(np.float32)
    mask = np.array([1, 0, 1, 1], np.float32) if masked else None
    assert _code_margin(z, cb) > 1e-4
    jq = JVQuant(n_e, e_dim, 0.25)
    params = {"params": {"embedding": jnp.asarray(cb)}}
    jm = None if mask is None else jnp.asarray(mask)

    def jfn(p, zz):
        loss, z_q, perp, idx = jq.apply(p, zz, jm)
        return loss + (z_q * r).sum(), (loss, z_q, perp, idx)

    (_, (jloss, jzq, jperp, jidx)), (jg_p, jg_z) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(params, jnp.asarray(z))
    tq = tvq.VectorQuantizer(n_e, e_dim, 0.25)
    with torch.no_grad():
        tq.embedding.weight.copy_(T(cb))
    tz = T(z).requires_grad_()
    loss, z_q, perp, idx = tq(tz, None if mask is None else T(mask))
    (loss + (z_q * T(r)).sum()).backward()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(perp.item(), float(jperp), rtol=1e-6)
    np.testing.assert_allclose(z_q.detach().numpy(), np.asarray(jzq), atol=1e-6)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jg_z), atol=1e-6)
    np.testing.assert_allclose(tq.embedding.weight.grad.numpy(),
                               np.asarray(jg_p["params"]["embedding"]), atol=1e-6)


# ------------------------------------------------------------------ the VQ-VAE loss and step

VQ_KW = dict(n_embeddings=32, embedding_dim=16, num_point=5, num_dim=64, local_decode_pts=40,
             sa_npoints=(64, 32), sa_nsamples=(8, 16, 16))
B_, P_, N_ = 2, 3, 200


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def vq_setup():
    """Converted weights with non-trivial BatchNorm, a batch with one compaction repeat, and
    the JAX loss, gradients and updated statistics."""
    rng = np.random.default_rng(6)
    model = JVQ(**VQ_KW)
    v = _np_tree(jit_init(model, jax.random.key(3), jnp.zeros((1, N_, 3)), train=False))
    params, stats = v["params"], v["batch_stats"]
    for sa in ("sa1", "sa2", "sa3"):
        for j in range(3):
            c = params["pn2"][sa][f"bn{j}"]["scale"].shape[0]
            params["pn2"][sa][f"bn{j}"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            params["pn2"][sa][f"bn{j}"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
            stats["pn2"][sa][f"bn{j}"]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            stats["pn2"][sa][f"bn{j}"]["var"] = rng.uniform(0.5, 2, c).astype(np.float32)
    # the decoder's last layer scaled up so the reconstructed points spread over the part
    # as a trained model's do (about 1.3 at most), which keeps every chamfer margin > 1e-5
    params["pn2"]["fc3"]["kernel"] = params["pn2"]["fc3"]["kernel"] * 40.0
    batch = {"part_pcs": rng.uniform(-1, 1, size=(B_, P_, N_, 3)).astype(np.float32),
             "part_valids": np.array([[1, 1, 1], [1, 0, 1]], np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, s, b: jtrain.loss_fn(p, s, model, b, True), has_aux=True))
    (loss, (metrics, new_stats)), grads = grad_fn(params, stats, jbatch)
    # the fixture has no near-ties where a flipped index would move a gradient
    flat, _ = jtrain._flatten_compact(jbatch)
    out = jit_apply(model, {"params": params, "batch_stats": stats}, flat, train=True,
                    mask=jnp.ones(flat.shape[0]), mutable=("batch_stats",))[0]
    recon = np.asarray(model.reconstruction(out))
    return dict(model=model, params=params, stats=stats, batch=batch, loss=float(loss),
                metrics=_np_tree(metrics), new_stats=_np_tree(new_stats),
                grads=_np_tree(grads), recon=recon, flat=np.asarray(flat))


def _port_model(params, stats, remat=True):
    m = tvq.VQVAE(**VQ_KW, remat=remat)
    m.load_state_dict(from_jax.vqvae_state_dict(params, stats))
    return m.train()


def _grad_tree(model):
    """The port's gradients (and BatchNorm statistics) as the flax trees."""
    sd = dict(model.state_dict())
    for name, p in model.named_parameters():
        sd[name] = p.grad
    return convert_vqvae(sd)


def _assert_trees_close(out, ref, rel, atol, path=""):
    if isinstance(ref, dict):
        assert set(out) == set(ref), path
        for k in ref:
            _assert_trees_close(out[k], ref[k], rel, atol, f"{path}/{k}")
        return
    ref, out = np.asarray(ref), np.asarray(out)
    tol = rel * float(np.abs(ref).max()) + atol
    err = float(np.abs(out - ref).max())
    assert err <= tol, f"{path}: max err {err} > {tol}"


def test_vqvae_loss_and_every_gradient(vq_setup):
    s = vq_setup
    assert _no_near_ties(s["recon"], s["flat"], 1e-5)
    assert _no_near_ties(s["flat"], s["recon"], 1e-5)
    model = _port_model(s["params"], s["stats"])
    batch = {k: T(v) for k, v in s["batch"].items()}
    with torch.no_grad():  # no quantizer code within 1e-4 of a tie
        z_e = copy.deepcopy(model).pn2.encode(T(s["flat"]))[0].reshape(-1, 16)
    assert _code_margin(z_e.numpy(), model.vector_quantization.embedding.weight.detach().numpy()) > 1e-4
    loss, metrics = ttrain.loss_fn(model, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss), s["loss"], rtol=1e-5)
    for k in ttrain.METRIC_KEYS:
        np.testing.assert_allclose(float(metrics[k]), float(s["metrics"][k]), rtol=1e-5)
    assert float(metrics["valid_parts"]) == float(np.sum(s["batch"]["part_valids"]))
    tree = _grad_tree(model)
    got, ref = tree["params"], s["grads"]
    for sa in ("sa1", "sa2", "sa3"):
        for j in range(3):
            conv, rconv = got["pn2"][sa][f"conv{j}"], ref["pn2"][sa][f"conv{j}"]
            noise = 1e-4 * float(np.abs(rconv["kernel"]).max())
            assert np.abs(conv.pop("bias")).max() <= noise, (sa, j)
            assert np.abs(rconv["bias"]).max() <= noise, (sa, j)
            ref = {**ref, "pn2": {**ref["pn2"], sa: {**ref["pn2"][sa], f"conv{j}": {
                "kernel": rconv["kernel"]}}}}
    _assert_trees_close(got, ref, rel=2e-4, atol=1e-5)
    _assert_trees_close(tree["batch_stats"], s["new_stats"], rel=0.0, atol=1e-5)


def test_remat_updates_running_stats_once(vq_setup):
    """A checkpointed stage runs its forward again in backward; BatchNorm's running
    statistics and counter must move once, and the gradients must not change."""
    s = vq_setup
    batch = {k: T(v) for k, v in s["batch"].items()}
    models = [_port_model(s["params"], s["stats"], remat=r) for r in (True, False)]
    for m in models:
        ttrain.loss_fn(m, batch)[0].backward()
    for (name, a), b in zip(models[0].state_dict().items(), models[1].state_dict().values()):
        assert torch.equal(a, b), name
    assert int(models[0].pn2.sa2.mlp_bns[1].num_batches_tracked) == 1
    for (name, a), b in zip(models[0].named_parameters(), models[1].parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6, msg=name)


def test_train_step_matches_jax(vq_setup):
    s = vq_setup
    lr, wd = 5e-4, 1e-6
    tx = jstate.adamw_multistep(lr, (100,), 0.5, wd)
    jstate0 = jstate.create_state({"params": s["params"], "batch_stats": s["stats"]}, tx)
    jnew, jmetrics = jtrain.train_step(jstate0, {k: jnp.asarray(v) for k, v in
                                                 s["batch"].items()}, s["model"], tx)
    model = _port_model(s["params"], s["stats"])
    state = tstate.adamw_multistep(model, lr, (100,), 0.5, wd)
    metrics = ttrain.train_step(state, {k: T(v) for k, v in s["batch"].items()})
    assert state.step == 1 and int(jnew.step) == 1
    np.testing.assert_allclose(float(metrics["total_loss"]), float(jmetrics["total_loss"]),
                               rtol=1e-5)
    after = convert_vqvae(model.state_dict())
    _assert_trees_close(after["batch_stats"], _np_tree(jnew.batch_stats), rel=0.0, atol=1e-5)
    flat_new = jax.tree_util.tree_leaves_with_path(_np_tree(jnew.params))
    got = dict(jax.tree_util.tree_leaves_with_path(after["params"]))
    grads = dict(jax.tree_util.tree_leaves_with_path(s["grads"]))
    for path, ref in flat_new:
        g = np.abs(grads[path])
        keys = [k.key for k in path]
        if keys[1].startswith("sa") and keys[2].startswith("conv") and keys[3] == "bias":
            scale = np.abs(grads[path[:-1] + (jax.tree_util.DictKey("kernel"),)]).max()
        else:
            scale = g.max()
        clear = g > 1e-4 * scale
        err = np.abs(got[path] - ref)
        assert err[clear].max(initial=0) <= 1e-6, jax.tree_util.keystr(path)
        assert err.max() <= 2 * lr + 1e-6, jax.tree_util.keystr(path)


def test_device_parity_check_accepts_equal_steps_and_catches_a_missing_gradient(vq_setup):
    """``training/parity.py`` is what holds the card's step to the CPU's; here both sides
    run on the CPU, and a zeroed gradient (the fault of a kernel output without grad_fn)
    must be named."""
    s = vq_setup
    sd = _port_model(s["params"], s["stats"]).state_dict()

    def make():
        return tvq.VQVAE(**VQ_KW)

    ref = parity.step_on(make, sd, s["batch"], "cpu")
    errs = parity.compare(ref, parity.step_on(make, sd, s["batch"], "cpu"))
    assert errs["sa_grad_rel_l2"] < 1e-5 and errs["param_after_step_clear"] == 0.0
    bad = {**ref, "grads": {**ref["grads"],
                            "pn2.sa2.mlp_convs.1.weight": torch.zeros(
                                ref["grads"]["pn2.sa2.mlp_convs.1.weight"].shape)}}
    with pytest.raises(AssertionError, match="sa2.mlp_convs.1.weight"):
        parity.compare(ref, bad)


def test_sa_gradients_move_under_last_bit_noise_within_the_parity_tolerance(tmp_path):
    """Why ``training/parity.py`` holds the SA stages' gradients in relative L2 norm: on the
    CPU alone, a relative perturbation of 1e-6 of the SA weights (the size of the card's
    rounding differences) moves them far more than the rest, because a max over K with two
    neighbours within float error routes the gradient to either. It must stay inside the
    card-vs-CPU tolerance, and the other gradients inside theirs."""
    root = str(tmp_path)
    generate_dataset(root, num_shapes=2, seed=5, split="train", min_parts=3, max_parts=4,
                     n_points=300)
    batch = next(iter(Loader(VQVAEDataset(root + "/pc_data/train", max_num_part=4), 2,
                             shuffle=False)))

    def make():
        return tvq.VQVAE(64, 16, 5, 64, 40, sa_npoints=(96, 48), sa_nsamples=(16, 32, 32))

    torch.manual_seed(0)
    model = make()
    parity.spread_codebook(model)
    sd = model.state_dict()
    gen = torch.Generator().manual_seed(1)
    noisy = {k: v * (1 + 1e-6 * torch.randn(v.shape, generator=gen))
             if ".mlp_convs." in k else v for k, v in sd.items()}
    ref, out = parity.step_on(make, sd, batch, "cpu"), parity.step_on(make, noisy, batch, "cpu")
    sa_l2 = max(((out["grads"][n] - g).norm() / g.norm()).item()
                for n, g in ref["grads"].items()
                if n.startswith("pn2.sa") and not parity._pre_bn_bias(n))
    other = max(((out["grads"][n] - g).abs().max() / g.abs().max()).item()
                for n, g in ref["grads"].items() if not n.startswith("pn2.sa"))
    print(f"SA gradients: relative L2 {sa_l2}; other gradients: {other} of their largest")
    assert sa_l2 < parity.SA_GRAD_REL_L2
    assert other < parity.GRAD_REL


def test_lr_schedule_matches_optax_boundary():
    """Update k (from 1) runs at optax's schedule(k - 1): the rate halves from the update
    after the milestone's count, for MultiStepLR stepped once per update."""
    sched = optax.piecewise_constant_schedule(5e-4, {3: 0.5, 5: 0.5})
    state = tstate.adamw_multistep(torch.nn.Linear(1, 1), 5e-4, (3, 5), 0.5)
    seen = []
    for _ in range(8):
        seen.append(state.optimizer.param_groups[0]["lr"])
        state.optimizer.step()
        state.scheduler.step()
    assert seen == pytest.approx([float(sched(k)) for k in range(8)], rel=1e-7)

    # and one AdamW update with decay equals optax's adamw
    rng = np.random.default_rng(7)
    w0, g = rng.normal(size=5).astype(np.float32), rng.normal(size=5).astype(np.float32)
    tx = optax.adamw(1e-2, eps=1e-8, weight_decay=0.1)
    upd, _ = tx.update(jnp.asarray(g), tx.init(jnp.asarray(w0)), jnp.asarray(w0))
    w = torch.nn.Parameter(T(w0))
    opt = torch.optim.AdamW([w], lr=1e-2, eps=1e-8, weight_decay=0.1)
    w.grad = T(g)
    opt.step()
    np.testing.assert_allclose(w.detach().numpy(), w0 + np.asarray(upd), atol=1e-7)


# ------------------------------------------------------------------ checkpoints


def _state(value: float, step: int = 0) -> tstate.TrainState:
    model = torch.nn.Linear(2, 1, bias=False)
    with torch.no_grad():
        model.weight.fill_(value)
    st = tstate.adamw_multistep(model, 1e-3, (), 0.5)
    st.step = step
    return st


def _steps(ckpt_dir):
    return sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))


def test_topk_retention_and_best(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    topk = tstate.TopKCheckpointer(ckpt_dir, monitor="val_cd_loss", mode="max", top_k=2)
    for step, acc in {1: 0.1, 2: 0.5, 3: 0.3, 4: 0.05, 5: 0.4}.items():
        topk.save(_state(float(step), step), step, acc)
    assert _steps(ckpt_dir) == ["step_2", "step_5"]
    assert os.path.basename(tstate.best_checkpoint(ckpt_dir)) == "step_2"
    assert os.path.basename(tstate.resolve_checkpoint_path(ckpt_dir)) == "step_2"
    assert os.path.basename(tstate.resolve_checkpoint_path(ckpt_dir + "/best")) == "step_2"
    assert os.path.basename(tstate.latest_checkpoint(ckpt_dir)) == "step_5"
    assert os.path.basename(tstate.resolve_checkpoint_path(ckpt_dir + "/latest")) == "step_5"
    assert tstate.maybe_restore(_state(0.0), ckpt_dir).step == 5


def test_topk_mode_min_and_restart_persistence(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    topk = tstate.TopKCheckpointer(ckpt_dir, monitor="val_cd_loss", mode="min", top_k=2)
    for step, loss in {1: 0.9, 2: 0.2, 3: 0.5}.items():
        topk.save(_state(float(step)), step, loss)
    assert os.path.basename(tstate.best_checkpoint(ckpt_dir)) == "step_2"
    topk2 = tstate.TopKCheckpointer(ckpt_dir, monitor="val_cd_loss", mode="min", top_k=2)
    topk2.save(_state(4.0), 4, 0.1)
    assert os.path.basename(tstate.best_checkpoint(ckpt_dir)) == "step_4"
    assert _steps(ckpt_dir) == ["step_2", "step_4"]


def test_best_falls_back_to_latest_without_index(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    tstate.save_checkpoint(ckpt_dir, _state(1.0), 1)
    tstate.save_checkpoint(ckpt_dir, _state(2.0), 2)
    assert os.path.basename(tstate.best_checkpoint(ckpt_dir)) == "step_2"


def test_resume_continues_step_counter_and_restores_weights(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    topk = tstate.TopKCheckpointer(ckpt_dir, monitor="val_cd_loss", mode="max", top_k=2)
    topk.save(_state(1.0, 63), 63, 0.91)
    restored = tstate.maybe_restore(_state(0.0, 0), ckpt_dir)
    assert restored.step == 63
    topk.save(_state(2.0, 64), 64, 0.55)
    assert tstate.best_checkpoint(ckpt_dir).endswith("step_63")
    r63 = tstate.maybe_restore(_state(0.0), ckpt_dir, os.path.join(ckpt_dir, "step_63"))
    assert float(r63.model.weight[0, 0]) == 1.0


def test_resume_skips_interrupted_and_damaged_saves(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    tstate.save_checkpoint(ckpt_dir, _state(1.0, 100), 100)
    tstate.save_checkpoint(ckpt_dir, _state(2.0, 200), 200)
    os.makedirs(os.path.join(ckpt_dir, "step_300.tmp"))  # an interrupted save
    with open(os.path.join(ckpt_dir, "step_200", tstate.STATE_FILE), "wb") as f:
        f.write(b"damaged")
    assert os.path.basename(tstate.latest_checkpoint(ckpt_dir)) == "step_200"
    restored = tstate.maybe_restore(_state(0.0), ckpt_dir)
    assert restored.step == 100 and float(restored.model.weight[0, 0]) == 1.0
    tstate.save_checkpoint(ckpt_dir, _state(3.0, 400), 400)
    assert not os.path.exists(os.path.join(ckpt_dir, "step_300.tmp"))


def test_topk_smoothed_ranking(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    topk = tstate.TopKCheckpointer(ckpt_dir, monitor="m", mode="max", top_k=3, smooth_k=3)
    for step, acc in {1: 0.20, 2: 0.31, 3: 0.19, 4: 0.21, 5: 0.27, 6: 0.28, 7: 0.285}.items():
        topk.save(_state(float(step), step), step, acc)
    assert os.path.basename(tstate.best_checkpoint(ckpt_dir)) == "step_7"
    topk2 = tstate.TopKCheckpointer(ckpt_dir, monitor="m", mode="max", top_k=3, smooth_k=3)
    topk2.save(_state(8.0, 8), 8, 0.29)
    assert abs(topk2.entries["step_8"] - (0.28 + 0.285 + 0.29) / 3) < 1e-9


# ------------------------------------------------------------------ data and the entry point


def test_vqvae_dataset_matches_jax(tmp_path):
    root = str(tmp_path)
    jgen(root, num_shapes=3, seed=4, split="train", min_parts=2, max_parts=5, n_points=64)
    ref = next(iter(JLoader(JVQDS(root + "/pc_data/train", max_num_part=5), 3, seed=9)))
    out = next(iter(Loader(VQVAEDataset(root + "/pc_data/train", max_num_part=5), 3, seed=9)))
    assert set(out) == set(ref)
    for k in ("part_valids", "num_parts", "data_id"):
        np.testing.assert_array_equal(out[k], ref[k])
    np.testing.assert_allclose(out["part_pcs"], ref["part_pcs"], atol=1e-5)


def _tiny_cfg(root):
    return apply_overrides(Config(), [
        f"data.data_dir={root}/pc_data/train", f"data.data_val_dir={root}/pc_data/val",
        "data.batch_size=2", "data.val_batch_size=2", "data.max_num_part=4",
        "ae.n_embeddings=32", "ae.epochs=2", "trainer.log_every=1",
        f"trainer.output_dir={root}/out",
    ])


def test_trainer_runs_on_cpu_and_needs_cuda_otherwise(tmp_path, monkeypatch):
    root = str(tmp_path)
    generate_dataset(root, num_shapes=4, seed=11, split="train", min_parts=2, max_parts=4,
                     n_points=1000)
    generate_dataset(root, num_shapes=2, seed=12, split="val", min_parts=2, max_parts=4,
                     n_points=1000)
    cfg = _tiny_cfg(root)
    state = ttrain.train(cfg, max_steps=2, device="cpu")
    assert state.step == 2
    ckpt = os.path.join(root, "out", "everyday", "vqvae", "ckpt")
    assert _steps(ckpt) == ["step_2"]
    with open(os.path.join(root, "out", "everyday", "vqvae", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r[k]) for r in recs for k in ttrain.METRIC_KEYS)
    # resuming from the checkpoint continues the step counter
    assert ttrain.train(cfg, max_steps=3, device="cpu").step == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main([f"data.data_dir={root}/pc_data/train"])
