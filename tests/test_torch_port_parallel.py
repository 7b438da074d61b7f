"""Data parallelism of the port (``parallel/``) on the CPU: gloo, world size 2.

One step of each trainer at world size 2 on a global batch is held to the one-process step
on the same batch (the same code, ``training/parity.py::dp_steps`` at world 1) and to the JAX
package's step on a 2-device ``data_parallel_mesh(2)`` (conftest gives 8 virtual devices);
``run_inference`` at world size 2 is held to world size 1; the multi-process dry run passes.

Tolerances and why:
  * world 2 against world 1: loss and metrics 1e-6 relative (the same float32 sums, split in
    two and added); gradients, BatchNorm statistics and the parameters after AdamW within
    ``training/parity.py::compare``'s tolerances (the one-process parity tolerances);
    BatchNorm's running statistics on the two ranks bit-equal.
  * world 2 against the JAX mesh step: the tolerances of the one-process JAX parity tests
    (``test_torch_port_training.py``, ``test_torch_port_denoiser_training.py``,
    ``test_torch_port_verifier.py``): loss 1e-5 relative; BatchNorm statistics 1e-5; the
    parameters after AdamW within 1e-6 where the gradient exceeds 1e-4 of its largest entry
    elsewhere within 2 lr; an entry is clear by the port's gradient (the one-process JAX
    parity tests hold it to the JAX package's). Two biases have true gradient 0, so both
    sides hold float noise there and only the 2 lr bound applies: each SA conv's (a
    train-mode BatchNorm subtracts it; the port's noise must stay below 1e-4 of its kernel's
    largest gradient entry) and the verifier's key projection's (below 1e-5). Dropout is off
    on both sides (their masks cannot agree).
  * run_inference: the per-shape ``breakdown.jsonl`` records and ``num_samples`` equal;
    the mean metrics within 1e-6 relative.
Each spawned group is bounded by ``join_timeout_s`` and its collectives by a 60 s timeout.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import jit_init

from puzzlefusion_plusplus_tpu.convert.torch_ckpt import (
    convert_denoiser,
    convert_verifier,
    convert_vqvae,
)
from puzzlefusion_plusplus_tpu.inference import sampler as jsampler
from puzzlefusion_plusplus_tpu.models import scheduler as jsched
from puzzlefusion_plusplus_tpu.models.denoiser import DenoiserTransformer as JDen
from puzzlefusion_plusplus_tpu.models.verifier import VerifierTransformer as JVer
from puzzlefusion_plusplus_tpu.models.vqvae import VQVAE as JVQ
from puzzlefusion_plusplus_tpu.parallel import mesh as jmesh
from puzzlefusion_plusplus_tpu.training import denoiser as jden_train
from puzzlefusion_plusplus_tpu.training import state as jstate
from puzzlefusion_plusplus_tpu.training import verifier as jver_train
from puzzlefusion_plusplus_tpu.training import vqvae as jvq_train
from puzzlefusion_plusplus_tpu_torch.convert import from_jax
from puzzlefusion_plusplus_tpu_torch.data import generate_dataset
from puzzlefusion_plusplus_tpu_torch.inference import run as R
from puzzlefusion_plusplus_tpu_torch.models.denoiser import DenoiserTransformer as TDen
from puzzlefusion_plusplus_tpu_torch.models.verifier import VerifierTransformer as TVer
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE as TVQ
from puzzlefusion_plusplus_tpu_torch.parallel import dryrun, launch, mesh
from puzzlefusion_plusplus_tpu_torch.training import parity
from puzzlefusion_plusplus_tpu_torch.training import vqvae as tvq_train
from puzzlefusion_plusplus_tpu_torch.utils.config import Config, apply_overrides

torch.set_num_threads(2)
JOIN_S = 60  # each spawned group; they take 3-15 s here

VQ_KW = dict(n_embeddings=32, embedding_dim=16, num_point=5, num_dim=64, local_decode_pts=40,
             sa_npoints=(64, 32), sa_nsamples=(8, 16, 16))
ENC_KW = dict(n_embeddings=32, embedding_dim=16, num_point=25, num_dim=64,
              sa_npoints=(24, 12), sa_nsamples=(8, 8, 8))
B, P, N = 4, 3, 200  # the global batch of every case
DEN_P, DEN_N = 4, 96
E, NODES = 15, 6
LR = {"vqvae": 5e-4, "denoiser": 2e-4, "verifier": 2e-4}
METRICS = {"vqvae": tvq_train.METRIC_KEYS, "denoiser": ("mse_loss",),
           "verifier": ("cls_loss", "cls_acc", "cls_precision", "cls_recall",
                        "cls_f1_score")}


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


# ------------------------------------------------------------------ the three cases


def _vqvae_case(rng):
    """A VQ-VAE with non-trivial BatchNorm and a unit-scale codebook, and a global batch
    whose halves hold 5 and 2 valid parts."""
    model = JVQ(**VQ_KW)
    v = _np_tree(jit_init(model, jax.random.key(3), jnp.zeros((1, N, 3)), train=False))
    params, stats = v["params"], v["batch_stats"]
    for sa in ("sa1", "sa2", "sa3"):
        for j in range(3):
            c = params["pn2"][sa][f"bn{j}"]["scale"].shape[0]
            params["pn2"][sa][f"bn{j}"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            params["pn2"][sa][f"bn{j}"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
            stats["pn2"][sa][f"bn{j}"]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            stats["pn2"][sa][f"bn{j}"]["var"] = rng.uniform(0.5, 2, c).astype(np.float32)
    params["pn2"]["fc3"]["kernel"] = params["pn2"]["fc3"]["kernel"] * 40.0
    params["vector_quantization"]["embedding"] = rng.uniform(-1, 1, (32, 16)).astype(np.float32)
    batch = {"part_pcs": rng.uniform(-1, 1, size=(B, P, N, 3)).astype(np.float32),
             "part_valids": np.array([[1, 1, 1], [1, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)}
    jbatch_state = jstate.create_state({"params": params, "batch_stats": stats},
                                       jstate.adamw_multistep(LR["vqvae"], (100,), 0.5, 1e-6))
    case = dict(kind="vqvae", make_model=functools.partial(TVQ, **VQ_KW),
                state_dict=from_jax.vqvae_state_dict(params, stats), batch=batch)
    return case, dict(model=model, state=jbatch_state, params=params)


def _denoiser_case(rng):
    """A small frozen encoder and denoiser (dropout off), a global batch of 4 with an
    invalid slot and reference parts, and the JAX draws of its loss."""
    vq = JVQ(remat=False, **ENC_KW)
    v = _np_tree(jit_init(vq, jax.random.key(0), jnp.zeros((1, DEN_N, 3)), train=False))
    vq_params, vq_stats = v["params"], v["batch_stats"]
    vq_params["vector_quantization"]["embedding"] = rng.uniform(
        -1, 1, size=(32, 16)).astype(np.float32)
    den = JDen(embed_dim=32, num_layers=2, num_heads=2, num_dim=64, num_point=25,
               max_parts=DEN_P, num_ada_embeds=1000, dropout=0.0, pe_dropout=0.0)
    dv = jit_init(den, jax.random.key(1), jnp.zeros((1, DEN_P, 7)), jnp.zeros((1,), jnp.int32),
                  jnp.zeros((1, DEN_P, 25, 64)), jnp.zeros((1, DEN_P, 25, 3)),
                  jnp.ones((1, DEN_P)), jnp.ones((1, DEN_P, 1)), jnp.zeros((1, DEN_P), bool),
                  train=False)
    den_params = _np_tree(dv["params"])
    quat = rng.normal(size=(B, DEN_P, 4)).astype(np.float32)
    batch = {
        "part_pcs": (rng.normal(size=(B, DEN_P, DEN_N, 3)) * 0.4).astype(np.float32),
        "part_valids": np.array([[1, 1, 1, 0], [1, 1, 1, 1], [1, 1, 0, 0], [1, 1, 1, 0]],
                                np.float32),
        "part_scale": rng.uniform(0.2, 1.0, size=(B, DEN_P, 1)).astype(np.float32),
        "part_trans": (rng.normal(size=(B, DEN_P, 3)) * 0.3).astype(np.float32),
        "part_rots": quat / np.linalg.norm(quat, axis=-1, keepdims=True),
        "ref_part": np.array([[True, False, False, False], [False, False, True, False],
                              [False, True, False, False], [True, False, False, False]]),
    }
    jrng = jax.random.key(7)
    t_rng, n_rng, _ = jax.random.split(jrng, 3)  # the draws of loss_fn, in its order
    timesteps = np.asarray(jax.random.randint(t_rng, (B,), 0, 1000))
    noise = np.asarray(jax.random.normal(n_rng, (B, DEN_P, 7)))
    make_model = functools.partial(TDen, 32, 2, 2, 64, max_parts=DEN_P, num_ada_embeds=1000,
                                   dropout=0.0, pe_dropout=0.0)
    case = dict(kind="denoiser", make_model=make_model,
                state_dict=from_jax.denoiser_state_dict(den_params), batch=batch,
                make_encoder=parity.encoder_maker(
                    functools.partial(TVQ, **ENC_KW), from_jax.vqvae_state_dict(vq_params,
                                                                                vq_stats)),
                timesteps=torch.tensor(timesteps), noise=torch.tensor(noise))
    jenc = jsampler.make_frozen_encoder(vq, vq_params, vq_stats)
    return case, dict(model=den, params=den_params, rng=jrng, jenc=jenc)


def _verifier_case(rng):
    model = JVer(embed_dim=32, num_layers=2, num_heads=2, max_nodes=NODES, ff_dim=64)
    v = jit_init(model, jax.random.key(2), jnp.zeros((1, E, 7)),
                 jnp.zeros((1, E, 2), jnp.int32), jnp.ones((1, E)), train=False)
    valids = np.ones((B, E), np.float32)
    valids[1, 9:] = 0
    valids[2, 4:] = 0
    batch = {
        "edge_features": rng.random((B, E, 7)).astype(np.float32),
        "edge_indices": np.stack(np.triu_indices(NODES, 1), -1)[None].repeat(B, 0)
        .astype(np.int64),
        "edge_valids": valids,
        "cls_gt": (rng.random((B, E)) < 0.4).astype(np.float32) * valids,
    }
    params = _np_tree(v["params"])
    case = dict(kind="verifier",
                make_model=functools.partial(TVer, 32, 2, 2, max_nodes=NODES, ff_dim=64,
                                             dropout=0.0),
                state_dict=from_jax.verifier_state_dict(params), batch=batch)
    return case, dict(model=model, params=params)


@pytest.fixture(scope="module")
def steps():
    """Every case's step at world 2 (one spawned group), at world 1, and on the JAX mesh."""
    rng = np.random.default_rng(40)
    cases, jax_side = {}, {}
    for name, make in (("vqvae", _vqvae_case), ("denoiser", _denoiser_case),
                       ("verifier", _verifier_case)):
        cases[name], jax_side[name] = make(rng)
    two = parity.dp_steps(cases, 2, "cpu", join_timeout_s=JOIN_S)
    one = parity.dp_steps(cases, 1, "cpu")
    return cases, jax_side, one, two


def _jax_mesh_step(name, case, js):
    """The JAX package's step on a 2-device data mesh -> (metrics, params after,
    batch_stats after or None)."""
    m = jmesh.data_parallel_mesh(2)
    batch = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
             for k, v in case["batch"].items()}
    sharded = jmesh.shard_batch(batch, m)
    lr = LR[name]
    if name == "vqvae":
        tx = jstate.adamw_multistep(lr, (100,), 0.5, 1e-6)
        new, metrics = jvq_train.train_step(jmesh.replicate(js["state"], m), sharded,
                                            js["model"], tx)
        return metrics, new.params, new.batch_stats
    if name == "denoiser":
        tx = jstate.adamw_reference(lr, 0.95, 0.999, 1e-6)
        state = jmesh.replicate(jstate.create_state({"params": js["params"]}, tx), m)
        new, metrics = jden_train.train_step(state, sharded, js["rng"], js["model"],
                                             js["jenc"], jsched.DDPMParams.piecewise(), tx)
        return metrics, new.params, None
    # dropout off: the package's loss with train=False, and its AdamW update
    tx = jstate.adamw_reference(lr, 0.95, 0.999, 1e-6)
    params = jmesh.replicate(jax.tree.map(jnp.asarray, js["params"]), m)
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jver_train.loss_fn(p, js["model"], b, 0.2, False), has_aux=True))(
        params, sharded)
    updates, _ = tx.update(grads, tx.init(params), params)
    return metrics, jax.tree.map(lambda p, u: p + u, params, updates), None


CONVERT = {"vqvae": convert_vqvae, "denoiser": convert_denoiser, "verifier": convert_verifier}


@pytest.mark.parametrize("name", ["vqvae", "denoiser", "verifier"])
def test_step_at_world_2_equals_one_process_step(steps, name):
    cases, _, one, two = steps
    for k in METRICS[name]:
        np.testing.assert_allclose(two[name]["metrics"][k], one[name]["metrics"][k], rtol=1e-6,
                                   err_msg=k)
    errs = parity.compare(one[name], two[name], METRICS[name])
    assert errs["param_after_step_any"] <= 2 * LR[name] + 1e-6
    if name == "vqvae":
        # the ranks hold 5 and 2 valid parts: the mean of the ranks' own means differs
        valid = cases[name]["batch"]["part_valids"]
        assert valid[:2].sum() != valid[2:].sum()
        assert two[name]["metrics"]["valid_parts"] == valid.sum()
        halves = parity.dp_steps(
            {f"half{i}": {**cases[name], "batch": {k: v[2 * i:2 * i + 2] for k, v in
                                                    cases[name]["batch"].items()}}
             for i in (0, 1)}, 1, "cpu")
        per_rank_mean = np.mean([halves[f"half{i}"]["metrics"]["cd_loss"] for i in (0, 1)])
        global_cd = two[name]["metrics"]["cd_loss"]
        assert abs(per_rank_mean - global_cd) > 1e-3 * abs(global_cd)


@pytest.mark.parametrize("name", ["vqvae", "denoiser", "verifier"])
def test_step_at_world_2_equals_jax_mesh_step(steps, name):
    cases, jax_side, _, two = steps
    jm, jnew, jstats = _jax_mesh_step(name, cases[name], jax_side[name])
    out = two[name]
    for k in METRICS[name]:
        np.testing.assert_allclose(out["metrics"][k], float(jm[k]), rtol=1e-5, err_msg=k)
    model = cases[name]["make_model"]()
    model.load_state_dict({**out["params"], **out["buffers"]}, strict=False)
    after = CONVERT[name](model.state_dict())
    # which gradient entries are clear of 0: the port's (the one-process JAX parity tests
    # hold them to the JAX package's)
    grad_tree = CONVERT[name]({**model.state_dict(), **out["grads"]})["params"]
    if jstats is not None:
        for path, ref in jax.tree_util.tree_leaves_with_path(_np_tree(jstats)):
            got = after["batch_stats"]
            for key in path:
                got = got[key.key]
            np.testing.assert_allclose(np.asarray(got), ref, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(path))
    got = dict(jax.tree_util.tree_leaves_with_path(after["params"]))
    grads = dict(jax.tree_util.tree_leaves_with_path(_np_tree(grad_tree)))
    lr = LR[name]
    for path, ref in jax.tree_util.tree_leaves_with_path(_np_tree(jnew)):
        key = jax.tree_util.keystr(path)
        g = np.abs(grads[path])
        keys = [k.key for k in path]
        pre_bn_bias = (name == "vqvae" and keys[1].startswith("sa") and keys[2].startswith("conv")
                       and keys[3] == "bias")
        scale = (np.abs(grads[path[:-1] + (jax.tree_util.DictKey("kernel"),)]).max()
                 if pre_bn_bias or key.endswith("['k_proj']['bias']") else g.max())
        err = np.abs(np.asarray(got[path]) - ref)
        if key.endswith("['k_proj']['bias']"):
            assert g.max() <= 1e-5 * scale, key  # true gradient 0: float noise on both sides
        elif pre_bn_bias:  # true gradient 0 (BatchNorm subtracts it): float noise
            assert g.max() <= 1e-4 * scale, key
        else:
            assert err[g > 1e-4 * scale].max(initial=0) <= 1e-6, key
        assert err.max() <= 2 * lr + 1e-6, key


def test_batchnorm_running_stats_equal_on_both_ranks_and_one_process(steps):
    _, _, one, two = steps
    ranks = two["vqvae"]["rank_buffers"]
    assert len(ranks) == 2
    bn = [n for n in ranks[0] if n.endswith(("running_mean", "running_var"))]
    assert len(bn) == 18
    for n in bn:
        assert torch.equal(ranks[0][n], ranks[1][n]), n
        torch.testing.assert_close(ranks[0][n], one["vqvae"]["buffers"][n], rtol=1e-6,
                                   atol=1e-7, msg=n)


# ------------------------------------------------------------------ mesh helpers


def test_world_size_rules(monkeypatch):
    assert mesh.world_size(-1, "cpu") == 1
    assert mesh.world_size(3, "cpu") == 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.world_size(-1, "cuda") == 2
    with pytest.raises(ValueError, match="only 2 CUDA devices"):
        mesh.world_size(4, "cuda")
    with pytest.raises(ValueError, match="not divisible"):
        mesh.world_size(2, "cuda", batch_size=5)
    with pytest.raises(ValueError, match="-1 or positive"):
        mesh.world_size(0, "cpu")


def test_pad_and_shard_batch_match_jax():
    rng = np.random.default_rng(1)
    batch = {"a": rng.normal(size=(5, 3)).astype(np.float32),
             "b": np.arange(5, dtype=np.int32)}
    padded, n = mesh.pad_batch_to_devices(batch, 4)
    jpadded, jn = jmesh.pad_batch_to_devices(batch, 4)
    assert n == jn == 5
    for k in batch:
        np.testing.assert_array_equal(padded[k], jpadded[k])
    rows = [mesh.shard_batch(padded, r, 4) for r in range(4)]
    for k in batch:
        np.testing.assert_array_equal(np.concatenate([r[k] for r in rows]), padded[k])
    assert mesh.shard_batch(batch, 0, 1) is batch
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_batch(batch, 0, 2)


def test_collectives_are_the_identity_on_one_process():
    x = torch.arange(4.0, requires_grad=True)
    assert mesh.all_reduce_sum(x) is x
    assert mesh.global_sum(x) is x
    assert mesh.all_ranks(True) and not mesh.all_ranks(False)
    assert mesh.world() == 1 and mesh.rank() == 0 and mesh.is_main()
    assert not launch.needs_spawn(1) and launch.needs_spawn(2)
    assert launch.backend("cpu") == "gloo" and launch.backend("cuda") == "nccl"
    assert launch.backend("cuda", share_card=True) == "gloo"


def test_model_reduces_only_over_the_group_it_is_handed(monkeypatch):
    """Inside a process group a train-mode VQ-VAE that was handed no group computes its own
    batch's statistics with no collective (a model run on some ranks alone cannot hang);
    handed one, it sums every BatchNorm statistic and the quantizer's count and histogram
    over it (here a stand-in group whose sum is the identity, so the outputs agree)."""
    calls = []
    monkeypatch.setattr(mesh, "initialized", lambda: True)
    monkeypatch.setattr(mesh, "world", lambda group=None: 2)
    monkeypatch.setattr(mesh.dist, "all_reduce",
                        lambda t, op=None, group=None: calls.append(group))
    torch.manual_seed(0)
    model = TVQ(**VQ_KW).train()
    x = torch.rand(3, N, 3) * 2 - 1
    mask = torch.tensor([1.0, 1.0, 0.0])
    local = model(x, mask=mask)
    assert calls == []
    group = object()
    torch.manual_seed(0)
    summed = TVQ(**VQ_KW).train().reduce_over(group)(x, mask=mask)
    # 9 BatchNorms x (count, mean, variance), then the quantizer's count and histogram
    assert calls == [group] * 29
    for k in ("embedding_loss", "perplexity", "pc_offset"):
        torch.testing.assert_close(summed[k], local[k], rtol=0, atol=0, msg=k)
    assert launch.entry(mesh.world, (), 2, "cpu") is launch.HERE  # inside a group: no spawn


def test_replicate_broadcasts_dtypes_in_one_order(monkeypatch):
    """Every rank must broadcast its buckets in one order: the dtypes as they first appear
    (the order of a set of dtypes differs between processes)."""
    sent = []
    monkeypatch.setattr(mesh, "world", lambda group=None: 2)
    monkeypatch.setattr(mesh.dist, "broadcast", lambda t, src, group=None: sent.append(t.dtype))
    model = TVQ(**VQ_KW)  # float32 parameters first, then BatchNorm's int64 counters
    mesh.replicate(model)
    assert sent == [torch.float32, torch.int64]


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(Exception, match="not divisible by 2 ranks"):
        launch.run(mesh.shard_batch, ({"a": np.zeros(3)}, 0, 2), 2, "cpu",
                   join_timeout_s=JOIN_S)


def test_measured_reads_one_process():
    out = parity.measured(mesh.world, (), calls=2)
    assert out["result"] == 1 and len(out["seconds"]) == 2 and out["peak_bytes"] == [0]
    assert set(out["launches"]) == {*"SFGNMABRPD", "S int8", "S int8 quantize", "S pre-split"}
    assert not any(out["launches"].values())


# ------------------------------------------------------------------ inference, dry run


def _read(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _inference_cfg(root, out, batch_size):
    return apply_overrides(Config(), [
        f"data.data_val_dir={root}/pc_data/val", f"data.matching_data_path={root}/matching_data",
        "data.max_num_part=4", "ae.n_embeddings=32", "denoiser.embed_dim=32",
        "denoiser.num_layers=1", "denoiser.num_heads=2", "denoiser.num_inference_steps=3",
        "verifier.embed_dim=32", "verifier.num_layers=1", "verifier.num_heads=2",
        "verifier.max_iters=3", "verifier.threshold=0.0", f"inference.batch_size={batch_size}",
        "inference.save_trajectories=false", "inference.save_breakdown=true",
        f"trainer.output_dir={out}",
    ])


def test_run_inference_at_world_2_matches_world_1(tmp_path):
    """5 shapes at batch 4: a full batch split 2 + 2, then one real shape padded to 2 rows
    (its repeat dropped); verifier threshold 0, so reference parts spread along every edge
    and the shapes finish early."""
    root = str(tmp_path / "data")
    generate_dataset(root, num_shapes=5, seed=44, split="val", min_parts=2, max_parts=3)
    cfg = _inference_cfg(root, tmp_path / "out", 4)
    results = {}
    for world in (1, 2):
        cfg.trainer.num_devices = world
        cfg.inference.inference_dir = f"w{world}"
        results[world] = R.run_inference(cfg, "cpu", join_timeout_s=JOIN_S)
    assert results[1]["num_samples"] == results[2]["num_samples"] == 5
    base = tmp_path / "out" / cfg.trainer.experiment_name / "inference"
    one, two = _read(base / "w1" / "breakdown.jsonl"), _read(base / "w2" / "breakdown.jsonl")
    assert len(one) == 5 and one == two
    assert results[1]["n_iters"] == results[2]["n_iters"]
    assert results[1]["n_merged_pairs"] == results[2]["n_merged_pairs"]
    for k in R.METRIC_KEYS:
        np.testing.assert_allclose(results[2][f"eval/{k}"], results[1][f"eval/{k}"],
                                   rtol=1e-6, err_msg=k)


def test_engine_keeps_finished_shapes_while_other_ranks_go_on(tmp_path):
    """The ranks leave the loop together (``all_done``): a rank whose shapes are all done
    runs the iterations another rank still needs, and its shapes' results stay as they
    were at their own exit."""
    from puzzlefusion_plusplus_tpu_torch.data import DenoiserDataset, Loader
    from puzzlefusion_plusplus_tpu_torch.data.bucketing import part_bucket, slice_batch_parts
    from puzzlefusion_plusplus_tpu_torch.inference.engine import (
        auto_agglomerate_batch,
        draw_noise,
    )
    from puzzlefusion_plusplus_tpu_torch.inference.sampler import FrozenEncoder
    from puzzlefusion_plusplus_tpu_torch.models.scheduler import DDPMParams

    root = str(tmp_path / "data")
    generate_dataset(root, num_shapes=2, seed=44, split="val", min_parts=2, max_parts=3)
    cfg = _inference_cfg(root, tmp_path / "out", 2)
    ds = DenoiserDataset(cfg.data.data_val_dir, mode="test",
                         matching_data_path=cfg.data.matching_data_path, max_num_part=4)
    batch = next(iter(Loader(ds, 2, shuffle=False, drop_last=False)))
    batch = slice_batch_parts(batch, part_bucket(int(np.max(batch["num_parts"]))))
    t = {k: torch.as_tensor(np.asarray(batch[k])) for k in R.SAMPLE_KEYS}
    vq, den, ver = (m.eval() for m in R.make_models(cfg))
    acfg = R.agg_config(cfg)
    noise = draw_noise(acfg, *t["part_valids"].shape, torch.Generator().manual_seed(0), "cpu")
    args = (den, ver, FrozenEncoder(vq), DDPMParams.piecewise(), t, acfg)
    with torch.inference_mode():
        own = auto_agglomerate_batch(*args, noise=noise)
        held = auto_agglomerate_batch(*args, noise=noise, all_done=lambda flag: False)
    assert own["n_iters"] < held["n_iters"] == acfg.max_iters
    for k in ("pred_trans", "pred_rots"):
        assert torch.equal(own[k], held[k]), k
    for a, b in zip(own["final_state"], held["final_state"]):
        assert torch.equal(a, b)


def test_trainer_joins_the_group_that_torchrun_starts(tmp_path):
    """Under ``torchrun`` the entry reads RANK/WORLD_SIZE/LOCAL_RANK and spawns nothing: 2
    steps of the verifier on 2 CPU processes, one metrics record a step (rank 0's)."""
    import subprocess
    import sys

    root = str(tmp_path)
    generate_dataset(root, num_shapes=6, seed=34, split="train", min_parts=2, max_parts=5,
                     n_points=64)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
         "-m", "puzzlefusion_plusplus_tpu_torch.training.verifier", "--cpu",
         f"data.verifier_data_path={root}/verifier_data", "data.batch_size=2",
         "verifier.embed_dim=32", "verifier.num_layers=1", "verifier.num_heads=2",
         "verifier.epochs=1", "trainer.log_every=1", "trainer.num_devices=2",
         f"trainer.output_dir={root}/out"],
        cwd=repo, env=env, check=True, timeout=JOIN_S, capture_output=True)
    out = os.path.join(root, "out", "everyday", "verifier")
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    assert [r["step"] for r in recs if "cls_loss" in r] == [0, 1]


def test_dryrun_on_two_processes():
    out = dryrun.dryrun_multiprocess(2, join_timeout_s=JOIN_S)
    assert np.isfinite(out["loss"]) and out["step"] == 1
    assert out["mesh"] == {"data": 1, "model": 2}
    assert out["ff_weight_placement"] == "(Shard(dim=0),)"
    assert out["ff_weight_local_shape"] == [128, 32]  # GEGLU's 2 x 128 out-features, halved
