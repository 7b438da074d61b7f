"""Checkpoint loading in the port: its own ``state.pt`` checkpoints by the best/latest
rules, the original repo's Lightning files (``convert/lightning_ckpt.py``) against the JAX
package's converter (``convert/torch_ckpt.py``), the JAX package's orbax checkpoints through
``scripts/jax_ckpt_to_torch.py``, and the inference entry serving the three trained
checkpoints on the CPU.

Tolerances: weights exact (both converters only move and transpose arrays); forwards as in
``tests/test_torch_port_models.py``: the denoiser and verifier 1e-4, the encoder's z_e
within 1e-4 of its largest entry and its token centres 1e-5 (the JAX CPU path runs
BatchNorm unfolded, the port folds it); the served results of a checkpoint-loaded engine
equal those of the same weights passed as ``state_dicts`` exactly (one process, one
device)."""

import copy
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import jit_apply, jit_init

from puzzlefusion_plusplus_tpu.convert import torch_ckpt as jconv
from puzzlefusion_plusplus_tpu.models.denoiser import DenoiserTransformer as JDen
from puzzlefusion_plusplus_tpu.models.verifier import VerifierTransformer as JVer
from puzzlefusion_plusplus_tpu.models.vqvae import VQVAE as JVQ
from puzzlefusion_plusplus_tpu.training import state as jstate
from puzzlefusion_plusplus_tpu_torch.convert import from_jax, lightning_ckpt
from puzzlefusion_plusplus_tpu_torch.data import generate_dataset
from puzzlefusion_plusplus_tpu_torch.inference import run as R
from puzzlefusion_plusplus_tpu_torch.models.denoiser import DenoiserTransformer as TDen
from puzzlefusion_plusplus_tpu_torch.models.verifier import VerifierTransformer as TVer
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE as TVQ
from puzzlefusion_plusplus_tpu_torch.training import denoiser as tden
from puzzlefusion_plusplus_tpu_torch.training import state as tstate
from puzzlefusion_plusplus_tpu_torch.training import verifier as tver
from puzzlefusion_plusplus_tpu_torch.training import vqvae as tvq
from puzzlefusion_plusplus_tpu_torch.utils.config import Config, apply_overrides

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VQ_KW = dict(n_embeddings=32, embedding_dim=16, num_point=25, num_dim=64,
             sa_npoints=(24, 12), sa_nsamples=(8, 8, 8))
PORT = {
    "vqvae": lambda: TVQ(**VQ_KW),
    "denoiser": lambda: TDen(32, 2, 2, 16, max_parts=4, num_ada_embeds=1000),
    "verifier": lambda: TVer(32, 2, 2, max_nodes=6, ff_dim=64),
}
PREFIX = {"vqvae": "ae.", "denoiser": "denoiser.", "verifier": "verifier."}


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _port_model(kind: str, seed: int) -> torch.nn.Module:
    torch.manual_seed(seed)
    m = PORT[kind]()
    if kind == "vqvae":  # non-trivial BatchNorm statistics
        with torch.no_grad():
            for name, buf in m.named_buffers():
                if name.endswith("running_mean"):
                    buf.normal_(0, 0.1)
                elif name.endswith("running_var"):
                    buf.uniform_(0.5, 2.0)
    return m.eval()


def _lightning_file(path: str, kind: str, drop: str | None = None) -> dict:
    """A Lightning-style file of a seeded port model: its keys under the kind's prefix,
    keys the converters do not map beside them (the VQ-VAE decoder's, an
    AutoAgglomerative file's encoder), no ``num_batches_tracked``. -> the model's
    state_dict."""
    sd = _port_model(kind, 11).state_dict()
    lsd = {PREFIX[kind] + k: v for k, v in sd.items()
           if not k.endswith("num_batches_tracked") and k != drop}
    if kind == "vqvae":
        lsd["ae.decoder.fold.0.weight"] = torch.ones(4, 3)
    if kind == "denoiser":
        lsd.update({"encoder." + k: v for k, v in _port_model("vqvae", 12).state_dict().items()})
    torch.save({"state_dict": lsd, "epoch": 3, "global_step": 120}, path)
    return sd


def _jax_outputs(kind: str, tree: dict, inputs: dict):
    if kind == "vqvae":
        model = JVQ(remat=False, **VQ_KW)
        return jit_apply(model, tree, inputs["pcs"], train=False,
                         method=lambda m, x, train: m.pn2.encode(x, train))
    if kind == "denoiser":
        model = JDen(embed_dim=32, num_layers=2, num_heads=2, num_dim=16, num_point=5,
                     max_parts=4, num_ada_embeds=1000)
        return jit_apply(model, tree, *[inputs[k] for k in ("x", "t", "latent", "xyz",
                                                           "valids", "scale", "ref")],
                         train=False)
    model = JVer(embed_dim=32, num_layers=2, num_heads=2, max_nodes=6, ff_dim=64)
    return jit_apply(model, tree, inputs["feats"], inputs["idx"], inputs["valids_e"],
                     train=False)


def _port_outputs(kind: str, model, inputs: dict):
    with torch.no_grad():
        if kind == "vqvae":
            out = model.eval().encode(T(inputs["pcs"]))
            return out["z_e"], out["xyz"]
        if kind == "denoiser":
            return model.eval()(*[T(inputs[k]) for k in ("x", "t", "latent", "xyz", "valids",
                                                         "scale", "ref")])
        return model.eval()(T(inputs["feats"]), T(inputs["idx"]).long(), T(inputs["valids_e"]))


def _inputs() -> dict:
    rng = np.random.default_rng(41)
    B, P, L, E = 2, 4, 5, 15
    valids = np.ones((B, P), np.float32)
    valids[1, 2:] = 0
    valids_e = np.ones((2, E), np.float32)
    valids_e[1, 9:] = 0
    return {
        "pcs": (rng.normal(size=(3, 96, 3)) * 0.4).astype(np.float32),
        "x": rng.normal(size=(B, P, 7)).astype(np.float32),
        "t": np.array([950, 0], np.int32),
        "latent": rng.normal(size=(B, P, L, 16)).astype(np.float32),
        "xyz": rng.normal(size=(B, P, L, 3)).astype(np.float32),
        "valids": valids,
        "scale": rng.uniform(0.1, 1.0, size=(B, P, 1)).astype(np.float32),
        "ref": np.array([[False, True, False, False], [False] * 4]),
        "feats": rng.random((2, E, 7)).astype(np.float32),
        "idx": np.stack(np.triu_indices(6, 1), -1)[None].repeat(2, 0).astype(np.int32),
        "valids_e": valids_e,
    }


def _assert_outputs_close(kind, out, ref):
    if kind == "vqvae":
        (z_e, xyz), (jz_e, jxyz) = out, ref
        jz_e = np.asarray(jz_e)
        assert np.abs(z_e.numpy() - jz_e).max() <= 1e-4 * np.abs(jz_e).max()
        np.testing.assert_allclose(xyz.numpy(), np.asarray(jxyz), atol=1e-5)
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------------ the port's own format


def test_state_pt_loads_by_the_best_and_latest_rules(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    topk = tstate.TopKCheckpointer(ckpt, monitor="val_cls_acc", mode="max", top_k=3)
    for step, acc in {1: 0.5, 2: 0.9, 3: 0.7}.items():
        model = torch.nn.Linear(2, 2)
        with torch.no_grad():
            model.weight.fill_(float(step))
        topk.save(tstate.adamw_reference(model, 1e-3), step, acc)

    def weight(path):
        return float(tstate.load_model_state(path)["weight"][0, 0])

    assert weight(ckpt) == weight(ckpt + "/best") == 2.0
    assert weight(ckpt + "/latest") == 3.0
    assert weight(ckpt + "/step_1") == 1.0
    open(str(tmp_path / "model.ckpt"), "wb").close()
    with pytest.raises(ValueError, match="kind"):
        tstate.load_model_state(str(tmp_path / "model.ckpt"))


# ------------------------------------------------------------------ Lightning files


@pytest.mark.parametrize("kind", ["vqvae", "denoiser", "verifier", "encoder_of_denoiser_file"])
def test_lightning_checkpoint_matches_the_jax_converter(tmp_path, kind):
    path = str(tmp_path / "model.ckpt")
    file_kind = "denoiser" if kind == "encoder_of_denoiser_file" else kind
    src = _lightning_file(path, file_kind)
    lsd = torch.load(path, map_location="cpu", weights_only=True)["state_dict"]
    if kind == "encoder_of_denoiser_file":
        kind = "vqvae"
        src = _port_model("vqvae", 12).state_dict()
        tree = jconv.convert_denoiser_checkpoint(lsd)["encoder"]
    else:
        tree = {"vqvae": jconv.convert_vqvae_checkpoint, "denoiser": jconv.convert_denoiser,
                "verifier": jconv.convert_verifier}[kind](
            lsd if kind == "vqvae" else jconv.strip_prefix(lsd, PREFIX[kind]))
    sd = tstate.load_model_state(path, kind)
    assert sorted(sd) == sorted(src)  # decoder and encoder keys left out of the others
    assert all(torch.equal(sd[k], v) for k, v in src.items()
               if not k.endswith("num_batches_tracked"))
    model = _port_model(kind, 99)  # other weights, all replaced by the strict load
    model.load_state_dict(sd)
    inputs = _inputs()
    _assert_outputs_close(kind, _port_outputs(kind, model, inputs),
                          _jax_outputs(kind, tree, {k: jnp.asarray(v) for k, v in
                                                    inputs.items()}))


@pytest.mark.parametrize("kind,key", [
    ("vqvae", "pn2.sa2.mlp_bns.1.running_var"),
    ("denoiser", "transformer_layers.1.global_attn.to_k.weight"),
    ("verifier", "transformer_encoder.layers.0.self_attn.in_proj_bias"),
])
def test_lightning_checkpoint_missing_key_raises(tmp_path, kind, key):
    path = str(tmp_path / "model.ckpt")
    _lightning_file(path, kind, drop=key)
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        tstate.load_model_state(path, kind)
    with pytest.raises(KeyError, match="no verifier keys"):
        lightning_ckpt.convert({"ae.pn2.conv6.weight": torch.zeros(1)}, "verifier")


# ------------------------------------------------------------------ orbax checkpoints


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(REPO, "scripts", "jax_ckpt_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_variables(kind: str) -> dict:
    """Seeded flax variables of the kind's small model, as numpy trees."""
    sd = _port_model(kind, 13).state_dict()
    if kind == "vqvae":
        tree = jconv.convert_vqvae(sd)
    else:
        tree = {"denoiser": jconv.convert_denoiser,
                "verifier": jconv.convert_verifier}[kind](sd)
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("kind", ["vqvae", "denoiser", "verifier"])
def test_orbax_checkpoint_round_trips_through_the_converter(tmp_path, kind):
    variables = _jax_variables(kind)
    state = jstate.create_state(variables, jstate.adamw_reference(1e-3))._replace(step=7)
    orbax_dir = str(tmp_path / "orbax")
    step_dir = jstate.save_checkpoint(orbax_dir, state, 7)
    for path in (orbax_dir, step_dir):  # an orbax dir names the converter
        with pytest.raises(FileNotFoundError, match="jax_ckpt_to_torch"):
            tstate.load_model_state(path)
    out = _converter().convert(orbax_dir, str(tmp_path / "port"), kind)
    assert os.path.basename(out) == "step_7"
    sd = tstate.load_model_state(str(tmp_path / "port"))
    ref = (from_jax.vqvae_state_dict(variables["params"], variables["batch_stats"])
           if kind == "vqvae" else getattr(from_jax, f"{kind}_state_dict")(variables["params"]))
    assert sorted(sd) == sorted(ref)
    assert all(torch.equal(sd[k], v) for k, v in ref.items())
    model = _port_model(kind, 99)
    model.load_state_dict(sd)
    inputs = _inputs()
    _assert_outputs_close(kind, _port_outputs(kind, model, inputs),
                          _jax_outputs(kind, variables, {k: jnp.asarray(v) for k, v in
                                                         inputs.items()}))


# ------------------------------------------------------------------ the inference entry


def test_run_inference_serves_the_three_trained_checkpoints(tmp_path):
    """One step of each trainer on the CPU, then the entry serves their checkpoints by
    ``*.ckpt_path``: the same results as the same weights passed as ``state_dicts``, and
    other results than the seeded weights."""
    root = str(tmp_path)
    generate_dataset(root, num_shapes=2, seed=42, split="train", min_parts=2, max_parts=3)
    generate_dataset(root, num_shapes=2, seed=43, split="val", min_parts=2, max_parts=3)
    cfg = apply_overrides(Config(), [
        f"data.data_dir={root}/pc_data/train", f"data.data_val_dir={root}/pc_data/val",
        f"data.matching_data_path={root}/matching_data",
        f"data.verifier_data_path={root}/verifier_data", "data.batch_size=2",
        "data.val_batch_size=2", "data.max_num_part=4", "ae.n_embeddings=32",
        "denoiser.embed_dim=32", "denoiser.num_layers=1", "denoiser.num_heads=2",
        "verifier.embed_dim=32", "verifier.num_layers=1", "verifier.num_heads=2",
        "verifier.max_iters=1", "inference.batch_size=2", "inference.save_trajectories=false",
        f"trainer.output_dir={root}/out", "trainer.log_every=1",
    ])
    run = f"{root}/out/everyday"
    tvq.train(cfg, max_steps=1, device="cpu")
    cfg.denoiser.encoder_ckpt_path = f"{run}/vqvae/ckpt"
    tden.train(cfg, max_steps=1, device="cpu")
    tver.train(cfg, max_steps=1, device="cpu")
    seeded = R.run_inference(apply_overrides(copy.deepcopy(cfg),
                                             ["denoiser.encoder_ckpt_path="]), "cpu")
    cfg.denoiser.ckpt_path = f"{run}/denoiser/ckpt/latest"
    cfg.verifier.ckpt_path = f"{run}/verifier/ckpt"
    served = R.run_inference(cfg, "cpu")
    sds = {name: tstate.load_checkpoint(f"{run}/{stage}/ckpt")["model"]
           for name, stage in (("vqvae", "vqvae"), ("denoiser", "denoiser"),
                               ("verifier", "verifier"))}
    plain = apply_overrides(copy.deepcopy(cfg), ["denoiser.encoder_ckpt_path=",
                                                 "denoiser.ckpt_path=", "verifier.ckpt_path="])
    given = R.run_inference(plain, engine=R.build_engine_fn(plain, "cpu", state_dicts=sds))
    assert served == given
    assert served["num_samples"] == 2 and np.isfinite(served["eval/shape_cd"])
    assert served != seeded
