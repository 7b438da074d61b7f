"""Parity of the port's auto-agglomerative engine with the JAX engine.

* graph pieces (connected components, edge histograms with last-write-wins, the
  interpenetration keep-mask) on seeded inputs;
* ``verify_phase -> merge_geometry -> commit_merge`` on random states with a fake verifier
  whose logits force merges (the fixture of tests/test_engine_vs_simulator.py);
* one 20-step denoise phase and the whole ``auto_agglomerate_batch`` (2 iterations, with
  forced merges: no reference part, verifier threshold 0) with the JAX engine's noise
  replayed from its key schedule, on small damped (contractive) weights so the DDPM
  recurrence does not amplify float rounding.

Tolerances: graph state (ref_part, classified, adj, pivots, valids, n_iters) exact; poses,
affines and merged clouds 1e-4 after one verify/merge pass and 1e-3 over whole trajectories
(float32 rounding of XLA vs PyTorch accumulated over 20-40 DDPM steps)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.helpers import jit_init

from puzzlefusion_plusplus_tpu.data import generate_dataset
from puzzlefusion_plusplus_tpu.data.datasets import DenoiserDataset
from puzzlefusion_plusplus_tpu.data.loader import Loader
from puzzlefusion_plusplus_tpu.inference import engine as JE
from puzzlefusion_plusplus_tpu.inference.sampler import make_frozen_encoder
from puzzlefusion_plusplus_tpu.models.denoiser import DenoiserTransformer as JDen
from puzzlefusion_plusplus_tpu.models.scheduler import DDPMParams as JDDPM
from puzzlefusion_plusplus_tpu.models.verifier import VerifierTransformer as JVer
from puzzlefusion_plusplus_tpu.models.vqvae import VQVAE as JVQ
from puzzlefusion_plusplus_tpu_torch.convert import from_jax
from puzzlefusion_plusplus_tpu_torch.inference import engine as TE
from puzzlefusion_plusplus_tpu_torch.inference.sampler import FrozenEncoder
from puzzlefusion_plusplus_tpu_torch.models.denoiser import DenoiserTransformer as TDen
from puzzlefusion_plusplus_tpu_torch.models.scheduler import DDPMParams as TDDPM
from puzzlefusion_plusplus_tpu_torch.models.verifier import VerifierTransformer as TVer
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE as TVQ

torch.set_num_threads(2)


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def test_connected_components():
    rng = np.random.default_rng(0)
    adj = rng.random((4, 9, 9)) < 0.12
    adj = adj | adj.transpose(0, 2, 1)
    ref = np.stack([np.asarray(JE.connected_components(jnp.asarray(a))) for a in adj])
    np.testing.assert_array_equal(TE.connected_components(T(adj)).numpy(), ref)


def test_edge_histograms_last_write_wins():
    rng = np.random.default_rng(1)
    B, P, A, E, K = 2, 4, 20, 9, 6
    area = (rng.normal(size=(B, P, A, 3)) * 0.05).astype(np.float32)
    edges = rng.integers(0, P, size=(B, E, 2)).astype(np.int32)
    edges[:, 5] = edges[:, 2]  # duplicate cells: the later edge wins ...
    valid = rng.random((B, E)) < 0.8
    valid[:, 7] = False
    edges[:, 7] = edges[:, 3]  # ... even an invalid one, which writes zeros
    src = rng.integers(0, A, size=(B, E, K)).astype(np.int32)
    tgt = rng.integers(0, A, size=(B, E, K)).astype(np.int32)
    count = rng.integers(0, K + 1, size=(B, E)).astype(np.int32)
    ref = np.stack([np.asarray(JE.edge_histograms(
        jnp.asarray(area[b]), jnp.asarray(edges[b]), jnp.asarray(valid[b]),
        jnp.asarray(src[b]), jnp.asarray(tgt[b]), jnp.asarray(count[b]), P)) for b in range(B)])
    out = TE.edge_histograms(T(area), T(edges), T(valid), T(src), T(tgt), T(count), P)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_interpenetration_keep_mask():
    """The JAX CPU reference uses expanded-form distances, the port direct differences:
    masks may differ only for points within 1e-5 of the 1e-3 cutoff."""
    rng = np.random.default_rng(2)
    P, N = 4, 64
    base = rng.uniform(-0.1, 0.1, size=(N, 3)).astype(np.float32)
    pts = np.stack([base + rng.normal(0, 0.01, size=(N, 3)) for _ in range(P)])
    pts = pts.astype(np.float32)
    normals = rng.normal(size=(P, N, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    active = np.zeros((P, P), bool)
    active[0, 1] = active[1, 0] = active[2, 3] = active[3, 2] = True
    ref = np.asarray(JE.interpenetration_keep_mask(jnp.asarray(pts), jnp.asarray(normals),
                                                   jnp.asarray(active), 1e-3))
    out = TE.interpenetration_keep_mask(T(pts)[None], T(normals)[None], T(active)[None],
                                        1e-3)[0].numpy()
    d = ((pts[:, None, :, None] - pts[None, :, None, :]) ** 2).sum(-1).min(-1)
    per_point = d + d.transpose(1, 0, 2)
    near_cut = (np.abs(per_point - 1e-3) < 1e-5).any(axis=1)
    assert (out != ref).sum() == (out != ref)[near_cut].sum()
    assert (~ref).any(), "fixture removes no point"


# ---------------------------------------------------------------- verify / merge


P_S, N_S, A_S, K_S, E_S = 6, 64, 48, 8, 16


def _random_state(rng):
    """tests/test_engine_vs_simulator.py::random_state, as numpy."""
    noisy = rng.normal(size=(P_S, 7)).astype(np.float32)
    noisy[:, 3:] += np.array([2.0, 0, 0, 0], np.float32)
    ref = np.zeros(P_S, bool)
    ref[rng.integers(0, P_S - 2)] = True
    valids = np.ones(P_S, np.float32)
    valids[-1] = 0
    state = dict(
        noisy=noisy, reference_vals=noisy * 0.5, ref_part=ref, part_valids=valids,
        part_scale=rng.uniform(0.04, 0.6, P_S).astype(np.float32),
        part_pcs=rng.normal(size=(P_S, N_S, 3)).astype(np.float32),
        area_pts=rng.normal(size=(P_S, A_S, 3)).astype(np.float32),
        pivot=np.arange(P_S), node_valids=np.ones(P_S, bool),
        init_pose=np.broadcast_to(np.eye(4, dtype=np.float32), (P_S, 4, 4)).copy(),
        classified=rng.random(P_S) < 0.2, adj=np.zeros((P_S, P_S), bool), done=False,
    )
    matching = {
        "match_edges": rng.integers(0, P_S - 1, size=(E_S, 2)).astype(np.int32),
        "match_edge_valid": rng.random(E_S) < 0.8,
        "corr_src": rng.integers(0, A_S, size=(E_S, K_S)).astype(np.int32),
        "corr_tgt": rng.integers(0, A_S, size=(E_S, K_S)).astype(np.int32),
        "corr_count": rng.integers(0, K_S + 1, size=(E_S,)).astype(np.int32),
    }
    return state, matching


@pytest.mark.parametrize("seed", [1, 2, 3, 5])  # seeds whose fake logits merge parts
def test_verify_merge_commit(seed):
    rng = np.random.default_rng(seed)
    state, matching = _random_state(rng)
    triu = JE._triu_indices(P_S)
    logits = rng.normal(size=(len(triu),)).astype(np.float32) * 4.0
    cfg = JE.AgglConfig(normals_k=20)
    jstate = JE.AgglState(**{k: jnp.asarray(v) for k, v in state.items()},
                          rng=jax.random.key(0))
    jnew = JE.verify_and_merge(jstate, lambda f, i, v: jnp.asarray(logits)[None, :, None],
                               {k: jnp.asarray(v) for k, v in matching.items()},
                               jnp.asarray(4), cfg, jnp.asarray(triu))

    tstate = TE.AgglState(**{k: T(v)[None] for k, v in state.items()})
    tnew = TE.verify_and_merge(
        tstate, lambda f, i, v: T(logits)[None, :, None], {k: T(v)[None] for k, v in
                                                           matching.items()},
        torch.tensor([4]), TE.AgglConfig(normals_k=20), TE.triu_indices(P_S))
    for k in ("ref_part", "classified", "adj", "part_valids", "node_valids", "pivot"):
        np.testing.assert_array_equal(getattr(tnew, k)[0].numpy(), np.asarray(getattr(jnew, k)),
                                      err_msg=k)
    assert bool(tnew.done[0]) == bool(jnew.done)
    for k in ("part_scale", "init_pose", "part_pcs", "area_pts", "reference_vals"):
        np.testing.assert_allclose(getattr(tnew, k)[0].numpy(), np.asarray(getattr(jnew, k)),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert np.asarray(jnew.adj).any(), "the fixture must exercise the merge branch"


# ---------------------------------------------------------------- denoise + whole engine


@pytest.fixture(scope="module")
def engine_setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_engine"))
    generate_dataset(root, num_shapes=2, seed=5, split="val", min_parts=3, max_parts=4,
                     n_points=96)
    ds = DenoiserDataset(root + "/pc_data/val", mode="test",
                         matching_data_path=root + "/matching_data", max_num_part=4,
                         max_corr=32, max_edges_dense=12)
    batch = next(iter(Loader(ds, 2, shuffle=False, drop_last=False)))
    B, P = batch["part_valids"].shape
    vq = JVQ(n_embeddings=32, embedding_dim=16, num_point=25, num_dim=64,
             sa_npoints=(24, 12), sa_nsamples=(8, 8, 8), remat=False)
    den = JDen(embed_dim=32, num_layers=1, num_heads=2, num_dim=64, num_point=25,
               max_parts=P, num_ada_embeds=1000)
    ver = JVer(embed_dim=32, num_layers=1, num_heads=2, max_nodes=20, ff_dim=64)
    E = P * (P - 1) // 2
    vv = jax.device_get(jit_init(vq, jax.random.key(0), jnp.zeros((1, 96, 3)), train=False))
    dp = jit_init(den, jax.random.key(1), jnp.zeros((1, P, 7)), jnp.zeros((1,), jnp.int32),
                  jnp.zeros((1, P, 25, 64)), jnp.zeros((1, P, 25, 3)), jnp.ones((1, P)),
                  jnp.ones((1, P, 1)), jnp.zeros((1, P), bool), train=False)["params"]
    vp = jit_init(ver, jax.random.key(2), jnp.zeros((1, E, 7)), jnp.zeros((1, E, 2), jnp.int32),
                  jnp.ones((1, E)), train=False)["params"]
    # damped weights: contractive recurrence (tests/test_bucketing.py); verifier sigmoid ~0.5
    dp = jax.device_get(jax.tree.map(lambda x: 0.05 * x, dp))
    vp = jax.device_get(jax.tree.map(lambda x: 0.05 * x, vp))
    jax_side = dict(
        enc=make_frozen_encoder(vq, vv["params"], vv["batch_stats"]),
        dapply=lambda *a: den.apply({"params": dp}, *a, train=False),
        vapply=lambda *a: ver.apply({"params": vp}, *a, train=False),
    )
    tvq = TVQ(32, 16, 25, 64, sa_npoints=(24, 12), sa_nsamples=(8, 8, 8))
    tvq.load_state_dict(from_jax.vqvae_state_dict(vv["params"], vv["batch_stats"]))
    tden = TDen(32, 1, 2, 64, max_parts=P, num_ada_embeds=1000)
    tden.load_state_dict(from_jax.denoiser_state_dict(dp))
    tver = TVer(32, 1, 2, max_nodes=20, ff_dim=64)
    tver.load_state_dict(from_jax.verifier_state_dict(vp))
    port = dict(enc=FrozenEncoder(tvq.eval()), den=tden.eval(), ver=tver.eval())
    return batch, jax_side, port


def _replay_noise(rngs, P, n_steps):
    """The JAX engine's key schedule: one split for the initial noise, one per step."""
    init, steps = [], []
    for key in rngs:
        key, k = jax.random.split(key)
        init.append(JE._per_part_normal(k, P))
        row = []
        for _ in range(n_steps):
            key, k = jax.random.split(key)
            row.append(JE._per_part_normal(k, P))
        steps.append(jnp.stack(row))
    return T(np.stack(init)), T(np.stack(steps).transpose(1, 0, 2, 3))


SAMPLE_KEYS = ("part_pcs", "part_trans", "part_rots", "part_scale", "part_valids",
               "ref_part", "num_parts", "area_pts", "n_area", *JE.MATCHING_KEYS)


def test_denoise_phase_with_injected_noise(engine_setup):
    batch, js, ps = engine_setup
    cfg = JE.AgglConfig(max_iters=1)
    rngs = jax.random.split(jax.random.key(3), 2)
    sample = {k: jnp.asarray(batch[k]) for k in SAMPLE_KEYS}
    phase = JE.make_denoise_phase(js["dapply"], js["enc"], JDDPM.piecewise(), cfg)
    jstate = jax.vmap(JE.make_init_state)(sample, rngs)
    _, jtraj = jax.jit(jax.vmap(phase))(jstate)

    P = batch["part_valids"].shape[1]
    init, steps = _replay_noise(rngs, P, 20)
    tbatch = {k: T(batch[k]) for k in SAMPLE_KEYS}
    with torch.no_grad():
        tstate = TE.make_init_state(tbatch, init)
        _, ttraj = TE.denoise_phase(tstate, ps["den"], ps["enc"], TDDPM.piecewise(),
                                    TE.AgglConfig(max_iters=1), steps)
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(jtraj), atol=1e-3)


def test_auto_agglomerate_batch_replayed_noise(engine_setup):
    batch, js, ps = engine_setup
    # forced merges: no reference part and threshold 0, so every valid edge is predicted
    batch = dict(batch, ref_part=np.zeros_like(batch["ref_part"]))
    jcfg = JE.AgglConfig(max_iters=2, threshold=0.0)
    rngs = jax.random.split(jax.random.key(7), 2)
    sample = {k: jnp.asarray(batch[k]) for k in SAMPLE_KEYS}
    jout = jax.device_get(jax.jit(lambda s, r: JE.auto_agglomerate_batch(
        js["dapply"], js["vapply"], js["enc"], JDDPM.piecewise(), s, r, jcfg))(sample, rngs))

    P = batch["part_valids"].shape[1]
    noise = _replay_noise(rngs, P, 2 * 20)
    with torch.no_grad():
        tout = TE.auto_agglomerate_batch(
            ps["den"], ps["ver"], ps["enc"], TDDPM.piecewise(),
            {k: T(batch[k]) for k in SAMPLE_KEYS}, TE.AgglConfig(max_iters=2, threshold=0.0),
            noise=noise)
    jfs, tfs = jout["final_state"], tout["final_state"]
    assert np.asarray(jfs.adj).any(), "merges never fired"
    assert tout["n_iters"] == int(jout["n_iters"])
    for k in ("adj", "ref_part", "node_valids", "pivot", "part_valids", "classified", "done"):
        np.testing.assert_array_equal(getattr(tfs, k).numpy(), np.asarray(getattr(jfs, k)),
                                      err_msg=k)
    np.testing.assert_allclose(tout["pred_trans"].numpy(), np.asarray(jout["pred_trans"]),
                               atol=1e-3)
    np.testing.assert_allclose(tout["trajectory"].numpy(), np.asarray(jout["trajectory"]),
                               atol=1e-3)
    # quaternions up to sign
    tq, jq = tout["pred_rots"].numpy(), np.asarray(jout["pred_rots"])
    sign = np.sign((tq * jq).sum(-1, keepdims=True))
    np.testing.assert_allclose(tq * sign, jq, atol=1e-3)
