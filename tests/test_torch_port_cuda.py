"""GPU-only tests of the port: each CUDA kernel against its plain PyTorch version on the card,
and a small engine on the card against the same engine on the CPU.

Marked ``cuda``; they skip without a card. This file imports neither JAX nor the JAX package,
so on a machine without JAX it runs with the conftest left out:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py``.

Tolerances: FPS / gather / NN indices and values exact (the kernels compute distances with
the plain version's rounding, no FMA); S 1e-4 (FP32 sums in another order); engine
trajectories 1e-3 on damped weights, discrete outcomes exact."""

import numpy as np
import pytest
import torch

from puzzlefusion_plusplus_tpu_torch.data import DenoiserDataset, Loader, generate_dataset
from puzzlefusion_plusplus_tpu_torch.inference import run as R
from puzzlefusion_plusplus_tpu_torch.inference.engine import draw_noise
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE
from puzzlefusion_plusplus_tpu_torch.ops import chamfer as tch
from puzzlefusion_plusplus_tpu_torch.ops import fps as tfps
from puzzlefusion_plusplus_tpu_torch.ops import gather as tga
from puzzlefusion_plusplus_tpu_torch.ops import sa_fused as tsa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA only)")
    return torch.device("cuda")


def test_kernels_match_plain_on_card(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((3, 700, 3), generator=g, device=dev)
    y = torch.randn((3, 513, 3), generator=g, device=dev)
    mask = torch.rand((3, 700), generator=g, device=dev) < 0.5
    assert torch.equal(tfps.farthest_point_sample(x, 64, mask),
                       tfps.farthest_point_sample_plain(x, 64, mask))
    idx = torch.randint(0, 700, (3, 9, 5), generator=g, device=dev)
    assert torch.equal(tga.gather_points(x, idx), tga.gather_points_plain(x, idx))
    for a, b in zip(tch.nn_distance(x, y), tch.nn_distance_plain(x, y)):
        assert torch.equal(a, b)
    pm = torch.rand((2, 3, 3), generator=g, device=dev) < 0.5
    pts = x[:2, None, :300].expand(2, 3, 300, 3).contiguous()
    assert torch.equal(tch.masked_pairwise_nn(pts, pm), tch.masked_pairwise_nn_plain(pts, pm))

    M, S, K, N2, D, C1, C2, C3 = 3, 20, 32, 40, 16, 64, 64, 128
    r = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    gidx = torch.randint(0, N2, (M, S, K), generator=g, device=dev)
    feats, k1f = r(M, N2, D), r(D, C1) * D ** -0.5
    args = (r(M, S, K, 3), r(M, 3, C1), feats, gidx, k1f, r(C1), r(C1, C2) * C1 ** -0.5,
            r(C2), r(C2, C3) * C2 ** -0.5, r(C3))
    out = tsa.sa_stage_fused_cached(*args)
    ref = tsa.sa_stage_plain(args[0], args[1], feats @ k1f, gidx, *args[5:])
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_kernel_wrappers_reject_bad_input(dev):
    x = torch.randn((2, 10, 3), device=dev)
    with pytest.raises(TypeError):
        tch.nn_distance(x.double(), x.double())
    with pytest.raises(ValueError):
        tfps.farthest_point_sample(x, 4, torch.ones((2, 9), dtype=torch.bool, device=dev))
    args = [torch.randn(s, device=dev) for s in ((1, 4, 6, 3), (1, 3, 64), (64,), (64, 64),
                                                   (64,), (64, 64), (64,))]
    with pytest.raises(ValueError, match="K dividing 64"):  # K = 6
        tsa.sa_stage_fused_cached(args[0], args[1], None, None, None, *args[2:])


def test_engine_on_card_matches_cpu(dev, tmp_path):
    root = str(tmp_path)
    generate_dataset(root, num_shapes=2, seed=4, split="val", min_parts=3, max_parts=5,
                     n_points=96)
    cfg = R.Config()
    cfg.data.max_num_part = 5
    cfg.denoiser.embed_dim = cfg.verifier.embed_dim = 32
    cfg.denoiser.num_layers = cfg.verifier.num_layers = 1
    cfg.denoiser.num_heads = cfg.verifier.num_heads = 2
    cfg.verifier.max_iters = 2
    cfg.verifier.threshold = 0.0  # forced merges: every valid edge is predicted

    def models():
        _, den, ver = R.make_models(cfg)
        return VQVAE(32, 16, 25, 64, sa_npoints=(24, 12), sa_nsamples=(8, 8, 8)), den, ver

    sds = {n: m.state_dict() for n, m in zip(("vqvae", "denoiser", "verifier"), models())}
    with torch.no_grad():
        for t in sds["denoiser"].values():
            t.mul_(0.05)  # contractive recurrence
    ds = DenoiserDataset(root + "/pc_data/val", mode="test",
                         matching_data_path=root + "/matching_data", max_num_part=5)
    batch = next(iter(Loader(ds, 2, shuffle=False, drop_last=False)))
    batch["ref_part"] = np.zeros_like(batch["ref_part"])
    noise = draw_noise(R.agg_config(cfg), 2, 5, torch.Generator().manual_seed(0), "cpu")
    cpu = R.build_engine_fn(cfg, "cpu", sds, models())(batch, noise=noise)
    gpu = R.build_engine_fn(cfg, "cuda", sds, models())(
        batch, noise=tuple(n.cuda() for n in noise))
    assert cpu["n_merged_pairs"].sum() > 0
    for k in ("n_iters", "n_merged_pairs", "acc_per_part"):
        np.testing.assert_array_equal(gpu[k], cpu[k])
    np.testing.assert_allclose(gpu["trajectory"], cpu["trajectory"], atol=1e-3)
