"""Parity of the port's models with the JAX package: the same flax weights, carried across
by ``convert/from_jax.py``, and the same seeded inputs go through both.

Tolerances: denoiser and verifier forwards 1e-4; the frozen encoder's cached indices exact,
its geometry and token centres 1e-5, and its quantized codes the same entry wherever the distance
from the code to the second-nearest codebook entry exceeds the nearest by more than 1e-4
(the JAX CPU path runs BatchNorm unfolded, the port folds it, so codes within float error of
a tie may snap either way)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.helpers import jit_apply, jit_init

from puzzlefusion_plusplus_tpu.convert.torch_ckpt import (
    convert_denoiser,
    convert_verifier,
    convert_vqvae,
)
from puzzlefusion_plusplus_tpu.inference import sampler as jsampler
from puzzlefusion_plusplus_tpu.models.denoiser import DenoiserTransformer as JDen
from puzzlefusion_plusplus_tpu.models.verifier import VerifierTransformer as JVer
from puzzlefusion_plusplus_tpu.models.vqvae import VQVAE as JVQ
from puzzlefusion_plusplus_tpu_torch.convert import from_jax
from puzzlefusion_plusplus_tpu_torch.inference import sampler as tsampler
from puzzlefusion_plusplus_tpu_torch.models.denoiser import DenoiserTransformer as TDen
from puzzlefusion_plusplus_tpu_torch.models.verifier import VerifierTransformer as TVer
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE as TVQ

torch.set_num_threads(2)


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


VQ_KW = dict(n_embeddings=32, embedding_dim=16, num_point=25, num_dim=64,
             sa_npoints=(24, 12), sa_nsamples=(8, 8, 8))


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), jax.device_get(tree))


def _perturb_bn(params, stats, rng):
    """Non-trivial BatchNorm scale/bias and running statistics."""
    for sa in ("sa1", "sa2", "sa3"):
        for j in range(3):
            bn, st = params["pn2"][sa][f"bn{j}"], stats["pn2"][sa][f"bn{j}"]
            c = bn["scale"].shape[0]
            bn["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            bn["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
            st["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            st["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return params, stats


@pytest.fixture(scope="module")
def vq_weights():
    model = JVQ(remat=False, **VQ_KW)
    v = _np_tree(jit_init(model, jax.random.key(0), jnp.zeros((1, 96, 3)), train=False))
    params, stats = _perturb_bn(v["params"], v["batch_stats"], np.random.default_rng(0))
    return model, params, stats


@pytest.fixture(scope="module")
def den_weights():
    model = JDen(embed_dim=32, num_layers=2, num_heads=2, num_dim=16, num_point=5,
                 max_parts=4, num_ada_embeds=1000)
    B, P, L = 2, 4, 5
    v = jit_init(model, jax.random.key(1), jnp.zeros((B, P, 7)), jnp.zeros((B,), jnp.int32),
                 jnp.zeros((B, P, L, 16)), jnp.zeros((B, P, L, 3)), jnp.ones((B, P)),
                 jnp.ones((B, P, 1)), jnp.zeros((B, P), bool), train=False)
    return model, _np_tree(v["params"])


@pytest.fixture(scope="module")
def ver_weights():
    model = JVer(embed_dim=32, num_layers=2, num_heads=2, max_nodes=6, ff_dim=64)
    E = 15
    v = jit_init(model, jax.random.key(2), jnp.zeros((1, E, 7)), jnp.zeros((1, E, 2), jnp.int32),
                 jnp.ones((1, E)), train=False)
    return model, _np_tree(v["params"])


def _port_vq(params, stats):
    m = TVQ(**VQ_KW)
    m.load_state_dict(from_jax.vqvae_state_dict(params, stats))
    return m.eval()


def _tree_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    jax.tree.map(lambda x, y: np.testing.assert_array_equal(np.asarray(x), np.asarray(y)),
                 a, b)


def test_weight_bridge_round_trip(vq_weights, den_weights, ver_weights):
    """convert_*(port.state_dict()) reproduces the flax trees exactly."""
    _, params, stats = vq_weights
    back = convert_vqvae(_port_vq(params, stats).state_dict())
    _tree_equal(back["params"], params)
    _tree_equal(back["batch_stats"], stats)

    _, dparams = den_weights
    den = TDen(32, 2, 2, 16, max_parts=4, num_ada_embeds=1000)
    den.load_state_dict(from_jax.denoiser_state_dict(dparams))
    _tree_equal(convert_denoiser(den.state_dict())["params"], dparams)

    _, vparams = ver_weights
    ver = TVer(32, 2, 2, max_nodes=6, ff_dim=64)
    ver.load_state_dict(from_jax.verifier_state_dict(vparams))
    _tree_equal(convert_verifier(ver.state_dict())["params"], vparams)


def test_denoiser_forward(den_weights):
    model, params = den_weights
    rng = np.random.default_rng(3)
    B, P, L = 2, 4, 5
    x = rng.normal(size=(B, P, 7)).astype(np.float32)
    t = np.array([950, 0], np.int64)
    latent = rng.normal(size=(B, P, L, 16)).astype(np.float32)
    xyz = rng.normal(size=(B, P, L, 3)).astype(np.float32)
    valids = np.ones((B, P), np.float32)
    valids[1, 2:] = 0
    scale = rng.uniform(0.1, 1.0, size=(B, P, 1)).astype(np.float32)
    ref = np.zeros((B, P), bool)
    ref[0, 1] = True
    jout = jit_apply(model, {"params": params}, x, t.astype(np.int32), latent, xyz, valids,
                     scale, ref, train=False)
    den = TDen(32, 2, 2, 16, max_parts=4, num_ada_embeds=1000)
    den.load_state_dict(from_jax.denoiser_state_dict(params))
    with torch.no_grad():
        tout = den.eval()(T(x), T(t), T(latent), T(xyz), T(valids), T(scale), T(ref))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-4, rtol=1e-4)


def test_verifier_forward_with_padding(ver_weights):
    model, params = ver_weights
    rng = np.random.default_rng(4)
    E = 15
    feats = rng.random((2, E, 7)).astype(np.float32)
    idx = np.stack(np.triu_indices(6, 1), -1)[None].repeat(2, 0).astype(np.int64)
    valids = np.ones((2, E), np.float32)
    valids[1, 9:] = 0  # padded edges are masked keys (-1e9)
    jout = jit_apply(model, {"params": params}, feats, idx.astype(np.int32), valids,
                     train=False)
    ver = TVer(32, 2, 2, max_nodes=6, ff_dim=64)
    ver.load_state_dict(from_jax.verifier_state_dict(params))
    with torch.no_grad():
        tout = ver.eval()(T(feats), T(idx), T(valids))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-4, rtol=1e-4)


def test_frozen_encoder_cached_features(vq_weights):
    model, params, stats = vq_weights
    rng = np.random.default_rng(5)
    B, P, N = 2, 3, 96
    pcs = rng.normal(size=(B, P, N, 3)).astype(np.float32) * 0.4
    valids = np.array([[1, 1, 0], [1, 1, 1]], np.float32)
    noisy = rng.normal(size=(B, P, 7)).astype(np.float32)

    jenc = jsampler.make_frozen_encoder(model, params, stats)
    jcache = jsampler.build_feature_cache(jenc, jnp.asarray(pcs), jnp.asarray(valids))
    jlat, jxyz = jax.jit(lambda c: jsampler.extract_features(
        jenc, jnp.asarray(pcs), jnp.asarray(valids), jnp.asarray(noisy), c))(jcache)

    tenc = tsampler.FrozenEncoder(_port_vq(params, stats))
    with torch.no_grad():
        tcache = tsampler.build_feature_cache(tenc, T(pcs), T(valids))
        tlat, txyz = tsampler.extract_features(tenc, T(pcs), T(noisy), tcache)
    for (jf, jg), (tf, tg) in zip(jcache.idx_stages, tcache.idx_stages):
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    for (jn, jgeo), (tn, tgeo) in zip(jcache.geom_stages, tcache.geom_stages):
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
        np.testing.assert_allclose(tgeo.numpy(), np.asarray(jgeo), atol=1e-5)
    np.testing.assert_allclose(txyz.numpy(), np.asarray(jxyz), atol=1e-5)

    # quantized codes: exact where the codebook decision has a margin
    q = tsampler.quat_normalize(T(noisy)[..., 3:])
    from puzzlefusion_plusplus_tpu_torch.utils.masking import compact_parts

    rot = tsampler.quat_to_matrix(compact_parts(q, tcache.src).reshape(B * P, 4))
    with torch.no_grad():
        z_e = tenc.encode(tcache.idx_stages, tcache.geom_stages, rot)["z_e"]
    z = z_e.reshape(B * P, -1, 16)
    d = torch.cdist(z, tenc.w["codebook"][None]) ** 2
    two = d.topk(2, dim=-1, largest=False).values
    margin = (two[..., 1] - two[..., 0]).reshape(B * P, 25, 4)
    margin = tsampler.scatter_parts(margin.reshape(B, P, 25, 4), tcache.order,
                                    tcache.slot_valid)
    clear = (margin > 1e-4).repeat_interleave(16, dim=-1).numpy()  # [B, P, 25, 64]
    valid = valids.astype(bool)[:, :, None, None]
    assert (clear & valid).mean() > 0.5 * valid.mean()
    # the JAX path returns the straight-through z + (z_q - z), equal to z_q up to float
    # rounding (~1e-8); a different code would be off by the codebook spacing (~1e-2)
    np.testing.assert_allclose(tlat.numpy()[clear], np.asarray(jlat)[clear], rtol=0,
                               atol=1e-6)
    assert not tlat.numpy()[~valids.astype(bool)].any()  # invalid parts are zero
