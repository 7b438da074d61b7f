"""GPU-only tests of the port: each CUDA kernel against its plain PyTorch version on the card,
and a small engine on the card against the same engine on the CPU.

Marked ``cuda``; they skip without a card. This file imports neither JAX nor the JAX package,
so on a machine without JAX it runs with the conftest left out:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py``.

Tolerances: FPS (F and P) / gather (G and A) / NN (N and M) indices and values exact (the
kernels compute distances with the plain version's rounding, no FMA; P equals F too; N and M
also across two launches; S's int8 codes and scales bit-equal); S (exact and int8) and R 1e-4
of the largest output (3xTF32 products on the tensor cores, FP32 sums in another order),
and bit-equal across two launches (no float atomics);
B 1e-5 of the largest sum against the plain index_add_, which adds with atomics in no fixed
order on the card, and bit for bit against the CPU's index_add_ and its own second launch
(it adds in row order); engine trajectories 1e-3 on damped weights, discrete outcomes exact;
a VQ-VAE and a denoiser training step on the card against the CPU within
``training/parity.py``'s tolerances; the denoiser's replayed CUDA graph bit for bit against
its eager body (the same kernels on the same inputs), and a b8 engine call with it against the
same call with the eager body; kernel D (3xTF32) 1e-5 of the largest output against a float64
product, bit-equal across two launches, and the denoiser's forward on D 1e-4 of its largest
pose entry against the same weights through fp32 ``F.linear``."""

import gc

import numpy as np
import pytest
import torch

from puzzlefusion_plusplus_tpu_torch import ops
from puzzlefusion_plusplus_tpu_torch.data import (
    DenoiserDataset,
    Loader,
    VQVAEDataset,
    generate_dataset,
)
from puzzlefusion_plusplus_tpu_torch.inference import run as R
from puzzlefusion_plusplus_tpu_torch.inference.engine import draw_noise
from puzzlefusion_plusplus_tpu_torch.inference.sampler import make_frozen_encoder
from puzzlefusion_plusplus_tpu_torch.models.denoiser import (
    GRAPH_WARMUP_CALLS,
    DenoiserTransformer,
    make_denoiser,
)
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE
from puzzlefusion_plusplus_tpu_torch.ops import chamfer as tch
from puzzlefusion_plusplus_tpu_torch.ops import cuda_build
from puzzlefusion_plusplus_tpu_torch.ops import dense as tdense
from puzzlefusion_plusplus_tpu_torch.ops import fps as tfps
from puzzlefusion_plusplus_tpu_torch.ops import gather as tga
from puzzlefusion_plusplus_tpu_torch.ops import sa_fused as tsa
from puzzlefusion_plusplus_tpu_torch.training import parity
from puzzlefusion_plusplus_tpu_torch.utils.metrics import shape_cd_clouds
from puzzlefusion_plusplus_tpu_torch.utils.transforms import quat_normalize

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA only)")
    return R.resolve_device("cuda")  # fp32 matmuls without TF32, as the entry points run


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


@pytest.mark.parametrize("S", [25, 7])  # neither a multiple of a block's centres
@pytest.mark.parametrize("K,D,widths,M", [
    (32, 0, (64, 64, 128), 3),  # SA1: 128-row blocks, two an SM, no features
    (64, 128, (128, 128, 256), 3),  # SA2: 128-row blocks; a centre spans four warps
    (64, 256, (256, 256, 512), 3),  # SA3: 128-row blocks, one an SM, h2 in place of h1
    (64, 0, (384, 384, 64), 3),  # 64-row blocks, h2 beside h1, a weight ring of one tile
    (64, 128, (128, 128, 256), 8),  # SA2 and SA3 at a b1 and a b8 engine's clouds
    (64, 128, (128, 128, 256), 160),
    (64, 256, (256, 256, 512), 8),
    (64, 256, (256, 256, 512), 160),
])
def test_sa_cached_kernel_matches_plain_on_card(dev, K, D, widths, S, M):
    """S given W2 and W3 split beforehand (``tf32_planes``, as the frozen encoder hands
    them) bit-equal to S splitting the plain weights itself, bit-equal across two launches,
    and within 1e-4 of the largest output of the plain version; only the launches given
    planes count as pre-split."""
    g = torch.Generator(device=dev).manual_seed(7)
    N2 = 40
    C1, C2, C3 = widths
    r = lambda *s, scale=1.0: torch.randn(s, generator=g, device=dev) * scale  # noqa: E731
    feats = r(M, N2, D).relu() if D else None
    gidx = torch.randint(0, N2, (M, S, K), generator=g, device=dev) if D else None
    k1f = r(D, C1, scale=D ** -0.5) if D else None
    args = (r(M, S, K, 3, scale=0.1), r(M, 3, C1, scale=3 ** -0.5), feats, gidx, k1f,
            r(C1, scale=0.1), r(C1, C2, scale=C1 ** -0.5), r(C2, scale=0.1),
            r(C2, C3, scale=C2 ** -0.5), r(C3, scale=0.1))
    split = list(args)
    split[6], split[8] = tsa.tf32_planes(args[6]), tsa.tf32_planes(args[8])
    ops.reset_launch_counts()
    out = tsa.sa_stage_fused_cached(*args)
    pre = tsa.sa_stage_fused_cached(*split)
    again = tsa.sa_stage_fused_cached(*split)
    counts = ops.launch_counts()
    assert (counts["S"], counts["S pre-split"]) == (3, 2)
    assert torch.equal(pre, out)  # the planes are the wrapper's own split
    assert torch.equal(pre, again)  # bit-reproducible
    proj = None if feats is None else feats @ k1f
    ref = tsa.sa_stage_plain(args[0], args[1], proj, gidx, *args[5:])
    torch.testing.assert_close(pre, ref, rtol=0, atol=1e-4 * ref.abs().max().item())


@pytest.mark.parametrize("S", [25, 7])
@pytest.mark.parametrize("K,D,widths", [
    (64, 128, (128, 128, 256)),  # SA2: 8 chunks of 16 codes a row
    (64, 256, (256, 256, 512)),  # SA3: 16 chunks a row
    (32, 24, (32, 64, 64)),      # C1 = 32: two chunks a row, 128-row blocks
])
def test_sa_int8_kernels_match_plain_on_card(dev, K, D, widths, S):
    """S's int8 mode: the quantize kernel bit-equal to its plain version (an all-zero column
    included), S's int8 instantiation within 1e-4 of the largest output of its plain version
    and bit-equal across two launches, one launch of each counted."""
    g = torch.Generator(device=dev).manual_seed(8)
    M, N2 = 3, 40
    C1, C2, C3 = widths
    r = lambda *s, scale=1.0: torch.randn(s, generator=g, device=dev) * scale  # noqa: E731
    feats = r(M, N2, D).relu()
    k1f = r(D, C1, scale=D ** -0.5)
    k1f[:, 1] = 0
    gidx = torch.randint(0, N2, (M, S, K), generator=g, device=dev)
    args = (r(M, S, K, 3, scale=0.1), r(M, 3, C1, scale=3 ** -0.5), feats, gidx, k1f,
            r(C1, scale=0.1), r(C1, C2, scale=C1 ** -0.5), r(C2, scale=0.1),
            r(C2, C3, scale=C2 ** -0.5), r(C3, scale=0.1))
    proj = feats @ k1f
    q, scale = tsa.sa_quantize(proj)
    q_ref, scale_ref = tsa.sa_quantize_plain(proj)
    assert torch.equal(q, q_ref) and torch.equal(scale, scale_ref)
    assert bool((q[:, :, 1] == 0).all()) and int(q.abs().max()) == 127
    ops.reset_launch_counts()
    out = tsa.sa_stage_fused_cached(*args, gather_impl="int8")
    counts = ops.launch_counts()
    assert (counts["S"], counts["S int8"], counts["S int8 quantize"]) == (0, 1, 1)
    assert torch.equal(out, tsa.sa_stage_fused_cached(*args, gather_impl="int8"))
    ref = tsa.sa_stage_plain(args[0], args[1], q_ref.float() * scale_ref[:, None, :], gidx,
                             *args[5:])
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * ref.abs().max().item())
    cpu = tsa.sa_stage_fused_cached(*(a.cpu() for a in args), gather_impl="int8")
    torch.testing.assert_close(out.cpu(), cpu, rtol=0, atol=1e-4 * cpu.abs().max().item())


@pytest.mark.parametrize("N,C,shape", [(1000, 3, (1000,)), (256, 128, (128, 64)),
                                       (40, 33, (7, 5)), (5000, 16, (300,))])
def test_gather_approx_and_scatter_add_match_plain_on_card(dev, N, C, shape):
    g = torch.Generator(device=dev).manual_seed(1)
    B = 3
    pts = torch.randn((B, N, C), generator=g, device=dev, requires_grad=True)
    idx = torch.randint(0, N, (B,) + shape, generator=g, device=dev)
    up = torch.randn((B,) + shape + (C,), generator=g, device=dev)
    ops.reset_launch_counts()
    out = tga.gather_points_approx(pts, idx)
    assert torch.equal(out, tga.gather_points_plain(pts, idx))
    out.backward(up)
    assert ops.launch_counts()["A"] == 1 and ops.launch_counts()["B"] == 1
    flat_idx, flat_up = idx.reshape(B, -1), up.reshape(B, -1, C)
    ref = tga.scatter_add_plain(flat_up, flat_idx, N)
    torch.testing.assert_close(pts.grad, ref, rtol=0, atol=1e-5 * ref.abs().max().item())
    again = tga.scatter_add(flat_up, flat_idx, N)
    assert torch.equal(again, pts.grad)  # deterministic
    assert torch.equal(again.cpu(), tga.scatter_add_plain(flat_up.cpu(), flat_idx.cpu(), N))


@pytest.mark.parametrize("B,N,C,shape", [
    (3, 50, 1, (37,)),          # one-float rows
    (3, 1000, 3, (9, 37)),      # the xyz gathers' scalar path; 333 rows: a partial tile
    (64, 1000, 3, (256, 32)),   # more tiles than one wave of warps: each warp strides
    (2, 30, 4, (35,)),          # one float4 a row
    (3, 40, 33, (7, 5)),        # rows that are not whole float4s
    (2, 256, 128, (29, 3)),     # SA2's feature width; 87 rows, not a multiple of the unroll
    (2, 128, 256, (25, 3)),     # SA3's: two 32-lane steps a row
])
def test_gather_kernel_paths_on_card(dev, B, N, C, shape):
    g = torch.Generator(device=dev).manual_seed(3)
    pts = torch.randn((B, N, C), generator=g, device=dev)
    idx = torch.randint(0, N, (B,) + shape, generator=g, device=dev, dtype=torch.int32)
    assert tga.gather_width(C, pts.data_ptr()) == (4 if C % 4 == 0 else 1)
    ops.reset_launch_counts()
    assert torch.equal(tga.gather_points(pts, idx), tga.gather_points_plain(pts, idx))
    assert torch.equal(tga.gather_points(pts, idx.long()), tga.gather_points_plain(pts, idx))
    assert ops.launch_counts()["G"] == 2


@pytest.mark.parametrize("B,N,C,shape", [
    (3, 50, 1, (37,)),          # one-value rows: 2-byte units
    (3, 40, 12, (7, 5)),        # rows that are not whole 16-byte units
    (2, 30, 8, (35,)),          # one 16-byte unit a row
    (4, 256, 128, (128, 64)),   # SA2's feature gather at M = 4
    (4, 128, 256, (25, 64)),    # SA3's
])
def test_gather_kernel_takes_bf16_rows_on_card(dev, B, N, C, shape):
    """Kernels G and A on bf16 points: the same kernel on 16-byte units (8 values) where a
    row is whole units, else 2-byte units; exact against the plain version, counted."""
    g = torch.Generator(device=dev).manual_seed(5)
    pts = torch.randn((B, N, C), generator=g, device=dev).bfloat16()
    idx = torch.randint(0, N, (B,) + shape, generator=g, device=dev, dtype=torch.int32)
    assert tga.gather_width(C, pts.data_ptr(), 2) == (8 if C % 8 == 0 else 1)
    ops.reset_launch_counts()
    for fn in (tga.gather_points, tga.gather_points_approx):
        out = fn(pts, idx)
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, tga.gather_points_plain(pts, idx))
    assert ops.launch_counts()["G"] == 1 and ops.launch_counts()["A"] == 1


def test_gather_of_an_unaligned_view_takes_the_scalar_path(dev):
    """A points view one float into its storage is not 16-byte aligned: the wrapper picks
    one-float units, and the launch refuses a float4 request on it."""
    B, N, C = 2, 64, 128
    buf = torch.randn(B * N * C + 1, device=dev)
    pts = buf[1:].view(B, N, C)
    assert pts.is_contiguous() and pts.data_ptr() % 16 == 4
    assert tga.gather_width(C, pts.data_ptr()) == 1
    idx = torch.randint(0, N, (B, 40), device=dev, dtype=torch.int32)
    assert torch.equal(tga.gather_points_approx(pts, idx), tga.gather_points_plain(pts, idx))
    out = torch.empty((B, 40, C), device=dev)
    fn = cuda_build.function("gather", "pfpp_gather")
    code = fn(pts.data_ptr(), idx.data_ptr(), out.data_ptr(), B, N, 40, C, 1,
              cuda_build.stream_ptr(pts))
    assert code != 0


def test_gather_without_grad_skips_autograd_and_counts_its_launch(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    pts = torch.randn((2, 100, 64), generator=g, device=dev, requires_grad=True)
    idx = torch.randint(0, 100, (2, 16, 8), generator=g, device=dev)
    ops.reset_launch_counts()
    with_grad = tga.gather_points(pts, idx)
    assert with_grad.grad_fn is not None and ops.launch_counts()["G"] == 1
    with torch.no_grad():
        fast = tga.gather_points(pts, idx)
    assert fast.grad_fn is None and ops.launch_counts()["G"] == 2
    assert torch.equal(fast, with_grad.detach())
    detached = tga.gather_points_approx(pts.detach(), idx)  # needs no gradient either
    assert detached.grad_fn is None and ops.launch_counts()["A"] == 1
    assert torch.equal(detached, with_grad.detach())


@pytest.mark.parametrize("case,B,R,N,C", [
    ("random", 3, 1000, 1000, 3),
    ("random", 2, 37, 11, 4),         # R not a multiple of the unroll or of a warp
    ("random", 2, 300, 40, 33),
    ("random", 2, 8192, 256, 128),    # SA2's backward: 32 CSR warps a cloud
    ("random", 2, 1600, 128, 256),
    ("one_index", 3, 1000, 1000, 3),  # every row to n = 0: one list of R rows
    ("one_index", 2, 2000, 256, 128),
    ("n_is_1", 2, 333, 1, 5),
    ("untouched", 2, 20, 5000, 16),   # most rows of the output take no row
    ("limit", 2, 3000, tga.SCATTER_MAX_N, 3),  # one warp's counts fill shared memory
    ("fused_wide_n", 2, 100, 20000, 3),  # one launch with one sorting warp
    ("n_is_1", 2, 333, 1, 3),         # one launch: all rows to n = 0 by construction
])
def test_scatter_add_kernel_paths_on_card(dev, case, B, R, N, C):
    g = torch.Generator(device=dev).manual_seed(6)
    up = torch.randn((B, R, C), generator=g, device=dev)
    idx = (torch.zeros((B, R), dtype=torch.int32, device=dev) if case == "one_index" else
           torch.randint(0, N, (B, R), generator=g, device=dev, dtype=torch.int32))
    ops.reset_launch_counts()
    out = tga.scatter_add(up, idx, N)
    again = tga.scatter_add(up, idx, N)
    assert ops.launch_counts()["B"] == 2  # one a call, though each call runs two kernels
    assert torch.equal(out, again)  # deterministic
    cpu = tga.scatter_add_plain(up.cpu(), idx.cpu(), N)
    assert torch.equal(out.cpu(), cpu)  # rows added in order, as the CPU's index_add_
    hit = torch.zeros((B, N), dtype=torch.bool)
    hit.scatter_(1, idx.long().cpu(), True)
    assert (out.cpu()[~hit] == 0).all()
    if case in ("untouched", "one_index"):
        assert (~hit).any()


def test_scatter_add_refuses_n_above_its_limit(dev):
    up = torch.randn((1, 4, 3), device=dev)
    idx = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        tga.scatter_add(up, idx, tga.SCATTER_MAX_N + 1)


def test_nn_distance_gradient_on_card_matches_cpu(dev):
    g = torch.Generator().manual_seed(2)
    x, y = torch.rand((2, 300, 3), generator=g), torch.rand((2, 250, 3), generator=g)
    w = torch.randn((2, 300), generator=g)
    grads = []
    for d in ("cpu", dev):
        xd, yd = x.to(d, copy=True).requires_grad_(), y.to(d, copy=True).requires_grad_()
        (tch.nn_distance(xd, yd)[0] * w.to(d)).sum().backward()
        grads.append((xd.grad.cpu(), yd.grad.cpu()))
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


def _nn_check(x, y):
    """Kernel N's bare launch, and its wrapper twice: distances and indices bit-equal to the
    plain version (its launch shape changes with the targets at csrc/nn.cu's tile)."""
    ref = tch.nn_distance_plain(x, y)
    out = tuple(torch.full_like(r, -1) for r in ref)
    tch._launch_nn(x, y, *out)
    assert all(torch.equal(o, r) for o, r in zip(out, ref))
    for _ in range(2):
        assert all(torch.equal(o, r) for o, r in zip(tch.nn_distance(x, y), ref))


@pytest.mark.parametrize("B", [1, 160])
@pytest.mark.parametrize("N", [1, 31, 33, 257, 513, 1025, 4097])
def test_nn_kernel_at_ragged_sizes_on_card(dev, B, N):
    """N queries against M targets for every M of the same list: sizes around the queries a
    block (64 Q), the chunk (16), the tile (1024) and a group's share of it."""
    g = torch.Generator(device=dev).manual_seed(N)
    x = torch.randn((B, N, 3), generator=g, device=dev)
    for M in (1, 31, 33, 257, 513, 1025, 4097):
        _nn_check(x, torch.randn((B, M, 3), generator=g, device=dev))


@pytest.mark.parametrize("M", [700, 2500])  # one tile, then three with a ragged last one
@pytest.mark.parametrize("case", ["duplicates", "query_on_targets", "identical", "grid",
                                  "shape_cd_parts"])
def test_nn_kernel_ties_go_to_the_lowest_index_on_card(dev, case, M):
    g = torch.Generator(device=dev).manual_seed(M)
    y = torch.randn((3, M, 3), generator=g, device=dev)
    x = torch.randn((3, 300, 3), generator=g, device=dev)
    if case == "shape_cd_parts":  # the metric's clouds: blobs of 100 points, padding at 1e3
        P = M // 100
        pts = 0.4 * torch.randn((3, P, 1, 3), generator=g, device=dev) + 0.05 * torch.randn(
            (3, P, 100, 3), generator=g, device=dev)
        valids = (torch.arange(P, device=dev) < torch.tensor([[2], [P // 2], [P]], device=dev))
        poses = [(0.1 * torch.randn((3, P, 3), generator=g, device=dev),
                  quat_normalize(torch.randn((3, P, 4), generator=g, device=dev)))
                 for _ in range(2)]
        x, y = shape_cd_clouds(pts, poses[0][0], poses[1][0], poses[0][1], poses[1][1],
                               valids.float())
    if case == "duplicates":  # a third of the targets copied over others, across chunks
        src = torch.randint(0, M, (M // 3,), generator=g, device=dev)
        dst = torch.randint(0, M, (M // 3,), generator=g, device=dev)
        y[:, dst] = y[:, src]
    elif case == "query_on_targets":  # each query equal to four targets in four tiles/chunks
        for k in range(4):
            y[:, k * (M // 4) + 5 : k * (M // 4) + 5 + 100] = x[:, :100]
    elif case == "identical":  # every distance ties
        x, y = torch.ones_like(x), torch.ones_like(y)
    else:  # integer points: many exact distance ties
        x, y = (2 * x).round(), (2 * y).round()
    _nn_check(x, y)


@pytest.mark.parametrize("case", ["none_active", "all_active", "asymmetric", "odd_n",
                                  "many_pairs"])
def test_masked_pairwise_kernel_matches_plain_on_card(dev, case):
    """Kernel M bit-equal to the plain version and across two launches; the
    mask passes as the bool tensor's own bytes, also from a non-contiguous view. many_pairs
    has more pairs than a block has threads, so each thread ranks several."""
    g = torch.Generator(device=dev).manual_seed(7)
    B, P, N = {"odd_n": (2, 5, 303), "many_pairs": (8, 20, 40)}.get(case, (3, 6, 1000))
    pts = 0.3 * torch.randn((B, P, N, 3), generator=g, device=dev)
    if case == "none_active":
        pm = torch.zeros((B, P, P), dtype=torch.bool, device=dev)
    elif case == "all_active":
        pm = torch.ones((B, P, P), dtype=torch.bool, device=dev)
    else:
        pm = (torch.rand((B, P, P), generator=g, device=dev) < 0.3).transpose(1, 2)
    ref = tch.masked_pairwise_nn_plain(pts, pm)
    out = torch.full_like(ref, -1)
    tch._launch_masked(pts, pm.contiguous(), out)
    assert torch.equal(out, ref)
    for _ in range(2):
        assert torch.equal(tch.masked_pairwise_nn(pts, pm), ref)
    assert torch.equal(tch.masked_pairwise_nn(pts, pm.to(torch.uint8)), ref)


def test_training_step_on_card_matches_cpu(dev, tmp_path):
    """The card's step has gradients at all (the kernels' outputs carry ``grad_fn``) and
    they equal the CPU's."""
    root = str(tmp_path)
    generate_dataset(root, num_shapes=2, seed=5, split="train", min_parts=3, max_parts=4,
                     n_points=300)
    batch = next(iter(Loader(VQVAEDataset(root + "/pc_data/train", max_num_part=4), 2,
                             shuffle=False)))

    def make():
        return VQVAE(64, 16, 5, 64, 40, sa_npoints=(96, 48), sa_nsamples=(16, 32, 32))

    model = make()
    parity.spread_codebook(model)
    sd = model.state_dict()
    ops.reset_launch_counts()
    gpu = parity.step_on(make, sd, batch, dev)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in "FGNAB"), counts
    cpu = parity.step_on(make, sd, batch, "cpu")
    parity.compare(cpu, gpu)


def _raw_sa_args(g, dev, M, N, Cin, S, K, widths):
    pts = torch.randn((M, N, Cin), generator=g, device=dev)
    fidx = torch.randint(0, N, (M, S), generator=g, device=dev)
    gidx = torch.randint(0, N, (M, S, K), generator=g, device=dev)
    weights, cin = [], Cin
    for c in widths:
        weights.append((torch.randn((cin, c), generator=g, device=dev) * cin ** -0.5,
                        torch.randn((c,), generator=g, device=dev) * 0.1))
        cin = c
    return pts, fidx, gidx, weights


@pytest.mark.parametrize("N,Cin,S,K,widths", [
    (1000, 3, 256, 32, (64, 64, 128)),  # SA1
    (256, 131, 128, 64, (128, 128, 256)),  # SA2
    (128, 259, 25, 64, (256, 256, 512)),  # SA3: S not a multiple of the block's centres
    (50, 35, 7, 8, (64, 64, 128)),
    (1000, 3, 25, 32, (64, 64, 128)),  # S not a multiple of the centres of 128 rows
    (256, 131, 7, 64, (128, 128, 256)),
    (128, 259, 7, 64, (256, 256, 512)),
    (128, 387, 7, 64, (384, 384, 64)),  # 64-row blocks with a 2-stage weight ring
])
def test_sa_raw_kernel_matches_plain_on_card(dev, N, Cin, S, K, widths):
    g = torch.Generator(device=dev).manual_seed(3)
    args = _raw_sa_args(g, dev, 3, N, Cin, S, K, widths)
    ops.reset_launch_counts()
    out = tsa.sa_stage_fused(*args)
    again = tsa.sa_stage_fused(*args)
    assert ops.launch_counts()["R"] == 2
    assert torch.equal(out, again)  # bit-reproducible
    ref = tsa.sa_stage_fused_plain(*args)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * ref.abs().max().item())


@pytest.mark.parametrize("B,N,npoint,masked", [
    (12, 12000, 1000, True), (2, 20000, 1000, True), (96, 1000, 256, False), (3, 700, 64, True),
    (48, 12000, 1000, True),  # the b8 engine's merge resample
    (160, 1000, 256, False),  # more clouds than the card's 132 SMs
    (3, 1000, 1000, True),  # npoint above the count of valid points
    (3, 8193, 64, True),  # F's streaming variant
])
def test_fps_per_cloud_kernel_matches_f_and_plain_on_card(dev, B, N, npoint, masked):
    g = torch.Generator(device=dev).manual_seed(4)
    xyz = torch.randn((B, N, 3), generator=g, device=dev)
    mask = (torch.rand((B, N), generator=g, device=dev) < 0.6) if masked else None
    if masked:
        mask[0] = False  # a cloud with no valid point starts at 0, as F does
        mask[1, : N // 2] = False
    ops.reset_launch_counts()
    out = tfps.farthest_point_sample_per_cloud(xyz, npoint, mask)
    assert ops.launch_counts()["P"] == 1 and ops.launch_counts()["F"] == 0
    assert torch.equal(out, tfps.farthest_point_sample(xyz, npoint, mask))
    assert torch.equal(out, tfps.farthest_point_sample_per_cloud_plain(xyz, npoint, mask))
    assert torch.equal(out, tfps.farthest_point_sample_per_cloud(xyz, npoint, mask))


def _fps_variants(N, cls):
    """Every shape kernel F (cl = 1) or P can take at N points, and the streaming variant at
    two widths besides."""
    return tfps.launch_shapes(N, cls) + [(cl, 0, w) for cl in cls for w in (128, 1024)]


@pytest.mark.parametrize("case", ["duplicates", "few_valid", "all_invalid", "unmasked"])
def test_fps_kernels_at_every_block_shape_on_card(dev, case):
    """F and P at every shape they can take, P at each cluster size, against the plain
    version: valid points at distance 0 (duplicates of chosen ones) must beat invalid ones at
    -1e10, npoint may exceed the valid points, and a cloud without one returns 0 throughout."""
    g = torch.Generator(device=dev).manual_seed(5)
    B, N, npoint = 3, 1500, 200
    xyz = torch.randn((B, N, 3), generator=g, device=dev)
    mask = torch.rand((B, N), generator=g, device=dev) < 0.5
    if case == "duplicates":  # every point twice, and 40 distinct valid points in cloud 1
        xyz[:, N // 2:] = xyz[:, : N - N // 2]
        mask[1] = False
        mask[1, 100:120] = True
        mask[1, N // 2 + 100: N // 2 + 120] = True
    elif case == "few_valid":
        mask[:] = False
        mask[:, 7:12] = True
    elif case == "all_invalid":
        mask[:] = False
    else:
        mask = None
    ref = tfps.farthest_point_sample_plain(xyz, npoint, mask)
    if case == "all_invalid":
        assert not ref.any()
    for cl, ppt, threads in _fps_variants(N, (1,)):
        out = tfps._launch(xyz, npoint, mask, cl, ppt, threads, per_cloud=False)
        assert torch.equal(out, ref), ("F", ppt, threads)
    for cl, ppt, threads in _fps_variants(N, (1, 2, 4, 8)):
        out = tfps._launch(xyz, npoint, mask, cl, ppt, threads, per_cloud=True)
        assert torch.equal(out, ref), ("P", cl, ppt, threads)


@pytest.mark.parametrize("N", [1, 31, 33, 256, 257, 513, 1024, 1025, 2049, 4096, 4097, 8192,
                               8193, 16385])
def test_fps_kernels_at_tier_boundaries_on_card(dev, N):
    """N at each edge of the register tiers and of P's cluster sizes, rarely a multiple of the
    block; F and P equal the plain version and their own second launch."""
    g = torch.Generator(device=dev).manual_seed(N)
    xyz = torch.randn((4, N, 3), generator=g, device=dev)
    mask = torch.rand((4, N), generator=g, device=dev) < 0.7
    npoint = min(N + 3, 96)
    ref = tfps.farthest_point_sample_plain(xyz, npoint, mask)
    for fn in (tfps.farthest_point_sample, tfps.farthest_point_sample_per_cloud):
        out = fn(xyz, npoint, mask)
        assert torch.equal(out, ref), fn.__name__
        assert torch.equal(out, fn(xyz, npoint, mask)), fn.__name__


def test_fps_launch_refuses_a_shape_it_cannot_run(dev):
    xyz = torch.randn((2, 1000, 3), device=dev)
    for cl, ppt, threads in ((1, 4, 128), (3, 4, 256), (1, 3, 512), (1, 16, 1024), (1, 4, 100)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            tfps._launch(xyz, 8, None, cl, ppt, threads, per_cloud=True)
    with pytest.raises(ValueError):
        tfps.farthest_point_sample(torch.randn((2, 0, 3), device=dev), 4)


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
    # the int8 instantiation checks its codes and scales as the exact one checks proj
    g_rel, gidx = torch.randn((1, 4, 8, 3), device=dev), torch.zeros((1, 4, 8), device=dev)
    q = torch.zeros((1, 5, 64), dtype=torch.int8, device=dev)
    scale = torch.ones((1, 64), device=dev)
    for bad_q, bad_scale, gi, err in ((q.float(), scale, gidx, TypeError),
                                      (q[:, :, :32], scale, gidx, ValueError),
                                      (q, scale[:, :32], gidx, ValueError),
                                      (q, scale, gidx[:, :3], ValueError)):
        with pytest.raises(err):
            tsa.sa_stage_cached_int8(g_rel, args[1], bad_q, bad_scale, gi, *args[2:])


def test_kernels_without_backward_refuse_inputs_that_need_grad(dev):
    """S and M write through raw pointers: where autograd would need their gradient they
    raise rather than return an output without ``grad_fn``; under no_grad they run."""
    pts = torch.randn((1, 2, 50, 3), device=dev, requires_grad=True)
    pm = torch.ones((1, 2, 2), dtype=torch.bool, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        tch.masked_pairwise_nn(pts, pm)
    with torch.no_grad():
        assert torch.equal(tch.masked_pairwise_nn(pts, pm),
                           tch.masked_pairwise_nn_plain(pts.detach(), pm))
    args = [torch.randn(s, device=dev) for s in ((1, 4, 8, 3), (1, 3, 64), (64,), (64, 64),
                                                   (64,), (64, 64), (64,))]
    args[3].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tsa.sa_stage_fused_cached(args[0], args[1], None, None, None, *args[2:])
    with torch.no_grad():
        tsa.sa_stage_fused_cached(args[0], args[1], None, None, None, *args[2:])
    g = torch.Generator(device=dev).manual_seed(5)
    pts, fidx, gidx, weights = _raw_sa_args(g, dev, 1, 40, 35, 4, 8, (64, 64, 128))
    weights[1][0].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tsa.sa_stage_fused(pts, fidx, gidx, weights)
    with torch.no_grad():
        tsa.sa_stage_fused(pts, fidx, gidx, weights)


@pytest.mark.parametrize("encode_cached", [False, True])
def test_denoiser_step_on_card_matches_cpu(dev, tmp_path, encode_cached):
    """One denoiser train_step on the card (the frozen encoder's kernels F, G, A, or S when
    cached) against the CPU, from the same weights, batch, timesteps and noise."""
    root = str(tmp_path)
    generate_dataset(root, num_shapes=2, seed=6, split="train", min_parts=3, max_parts=4,
                     n_points=300)
    batch = next(iter(Loader(DenoiserDataset(root + "/pc_data/train", mode="train",
                                             max_num_part=4), 2, shuffle=False)))
    torch.manual_seed(0)
    vq = VQVAE(64, 16, 25, 64, sa_npoints=(96, 48), sa_nsamples=(16, 32, 32))
    parity.spread_codebook(vq)
    vq_sd = vq.state_dict()

    def make():
        return DenoiserTransformer(64, 2, 4, 64, max_parts=4, num_ada_embeds=1000,
                                   dropout=0.0, pe_dropout=0.0)

    def make_encoder(device):
        m = VQVAE(64, 16, 25, 64, sa_npoints=(96, 48), sa_nsamples=(16, 32, 32))
        m.load_state_dict(vq_sd)
        return make_frozen_encoder(m.to(device))

    sd = make().state_dict()
    g = torch.Generator().manual_seed(1)
    timesteps, noise = torch.randint(0, 1000, (2,), generator=g), torch.randn((2, 4, 7),
                                                                             generator=g)
    ops.reset_launch_counts()
    gpu = parity.denoiser_step_on(make, sd, make_encoder, batch, dev, timesteps, noise,
                                  encode_cached)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("SFG" if encode_cached else "FGA")), counts
    cpu = parity.denoiser_step_on(make, sd, make_encoder, batch, "cpu", timesteps, noise,
                                  encode_cached)
    assert min(cpu["code_margin"], gpu["code_margin"]) > 1e-4
    parity.compare(cpu, gpu, ("mse_loss",))


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


# ------------------------------------------------------------------ the matcher's shapes


@pytest.mark.parametrize("N,C,shape", [
    (5000, 3, (1024, 32)),   # sa1's ball grouping of the flat 5000-point cloud
    (64, 512, (16, 32)),     # sa4's feature grouping
    (16, 1024, (64, 3)),     # fp4's 3-NN interpolation of sa4's 1024 channels
    (1024, 128, (5000, 3)),  # fp1's interpolation up to every point
    (5000, 128, (5000, 16)),  # the PointTransformer's kNN keys and values
])
def test_gather_and_scatter_add_at_the_matchers_shapes_on_card(dev, N, C, shape):
    """Kernel G exact and kernel B (its backward) bit-equal to the CPU's in-order sum at the
    matcher's batch-1 shapes (the PointTransformer's is B's CSR route at R = 80000)."""
    g = torch.Generator(device=dev).manual_seed(7)
    pts = torch.randn((1, N, C), generator=g, device=dev, requires_grad=True)
    idx = torch.randint(0, N, (1,) + shape, generator=g, device=dev, dtype=torch.int32)
    up = torch.randn((1,) + shape + (C,), generator=g, device=dev)
    ops.reset_launch_counts()
    out = tga.gather_points(pts, idx)
    assert torch.equal(out, tga.gather_points_plain(pts, idx))
    out.backward(up)
    assert ops.launch_counts()["G"] == 1 and ops.launch_counts()["B"] == 1
    cpu = tga.scatter_add_plain(up.reshape(1, -1, C).cpu(), idx.reshape(1, -1).cpu(), N)
    assert torch.equal(pts.grad.cpu(), cpu)


@pytest.mark.parametrize("N,npoint,valid_share", [(5000, 1024, 1.0), (5000, 1024, 0.7),
                                                   (1024, 256, 1.0), (256, 64, 1.0),
                                                   (64, 16, 1.0)])
def test_fps_at_the_matchers_shapes_on_card(dev, N, npoint, valid_share):
    """Kernel F on the matcher's four stages of one flat cloud, masked by the point
    validity (every point valid in a real batch), against the plain indices."""
    g = torch.Generator(device=dev).manual_seed(8)
    xyz = torch.randn((1, N, 3), generator=g, device=dev)
    mask = torch.rand((1, N), generator=g, device=dev) < valid_share
    assert torch.equal(tfps.farthest_point_sample(xyz, npoint, mask),
                       tfps.farthest_point_sample_plain(xyz, npoint, mask))


def test_matching_step_on_card_matches_cpu(dev, tmp_path):
    """One small matcher step on the card against the CPU, within
    ``training/parity.py::MATCHING_SMALL`` (the small sizes' losses 2e-3 relative;
    ``chip_smoke.py``'s matching_parity holds the full-width step to ``MATCHING``)."""
    import functools

    from puzzlefusion_plusplus_tpu_torch.matching import train as mtrain
    from puzzlefusion_plusplus_tpu_torch.matching.dataset import AllPieceMatchingDataset

    generate_dataset(str(tmp_path), num_shapes=2, seed=4, split="val", min_parts=3,
                     max_parts=5, n_points=96, with_matching=False, with_verifier=False)
    ds = AllPieceMatchingDataset(str(tmp_path / "pc_data" / "val"), num_points=160,
                                 max_num_part=5)
    batch = next(iter(Loader(ds, 2, shuffle=False)))
    make = functools.partial(mtrain.make_model, pc_feat_dim=32, aff_feat_dim=16,
                             sa_npoints=(32, 16, 8, 4), max_num_part=5)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        sd = make().state_dict()
    ops.reset_launch_counts()
    gpu = parity.matching_step_on(make, sd, batch, "cuda")
    assert all(ops.launch_counts()[k] > 0 for k in "FGB")
    cpu = parity.matching_step_on(make, sd, batch, "cpu")
    parity.compare(cpu, gpu, mtrain.METRIC_KEYS, parity.MATCHING_SMALL)


def test_matcher_eval_shapes_match_plain_on_card(dev):
    """The matcher at 1000 points with sa_npoints (1024, ...): F selects more centres than a
    cloud has points (once every valid point is taken, the first valid index repeats); B at
    the batch-4 PointTransformer backward, [4, 2000 x 16, 128] (the CSR route)."""
    g = torch.Generator(device=dev).manual_seed(9)
    xyz = torch.randn((4, 1000, 3), generator=g, device=dev) * 0.3
    mask = torch.ones((4, 1000), dtype=torch.bool, device=dev)
    mask[1, :100] = False  # 900 valid points
    for m in (mask, None):
        out = tfps.farthest_point_sample(xyz, 1024, m)
        assert torch.equal(out, tfps.farthest_point_sample_plain(xyz, 1024, m))
        assert (out[:, 1000:] == out[:, :1]).all()
    up = torch.randn((4, 2000 * 16, 128), generator=g, device=dev)
    idx = torch.randint(0, 2000, (4, 2000 * 16), generator=g, device=dev, dtype=torch.int32)
    assert tga.scatter_scratch_ints(4, 2000 * 16, 2000, 128) > 0  # the CSR route
    out = tga.scatter_add(up, idx, 2000)
    ref = tga.scatter_add_plain(up, idx, 2000)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert torch.equal(out.cpu(), tga.scatter_add_plain(up.cpu(), idx.cpu(), 2000))


# ------------------------------------------------ the denoiser's inference forward as a graph


def _graph_denoiser(dev, precision="fp32", seed=0):
    """The denoiser at ``Config()``'s published widths, in ``eval()`` on the card."""
    cfg = R.Config()
    cfg.trainer.precision = precision
    torch.manual_seed(seed)
    return make_denoiser(cfg).to(dev).eval(), cfg


def _graph_inputs(dev, cfg, B, P, seed):
    """One call's inputs at batch B and part pad P: some pad parts, one reference part."""
    g = torch.Generator(device=dev).manual_seed(seed)
    L, D = cfg.denoiser.num_point, cfg.denoiser.num_dim
    n = torch.randint(2, P + 1, (B,), generator=g, device=dev)
    valid = (torch.arange(P, device=dev)[None] < n[:, None]).float()
    ref = torch.zeros((B, P), dtype=torch.bool, device=dev)
    ref[:, 0] = True
    return (torch.randn((B, P, 7), generator=g, device=dev),
            torch.randint(0, 1000, (B,), generator=g, device=dev),
            torch.randn((B, P, L, D), generator=g, device=dev),
            torch.randn((B, P, L, 3), generator=g, device=dev), valid,
            torch.rand((B, P, 1), generator=g, device=dev) + 0.5, ref)


def _graph_spans(fn):
    """(fn(), counts of the program's pfpp.denoiser.* spans while it ran)."""
    from puzzlefusion_plusplus_tpu_torch.utils import profiling

    assert not profiling.profiling_on()  # ends the last session
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.profiling_on()  # starts this one, empty even where fn() opens no span
        out = fn()
    return out, {n: v["count"] for n, v in profiling.snapshot()["spans"].items()
                 if n.startswith("pfpp.denoiser.")}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("P", [8, 12, 16, 20])
def test_denoiser_graph_equals_eager_at_engine_shapes(dev, precision, P):
    den, cfg = _graph_denoiser(dev, precision)
    calls = [_graph_inputs(dev, cfg, 8, P, seed) for seed in range(3)]
    with torch.inference_mode():
        got, spans = _graph_spans(lambda: [den(*a) for a in calls])
        want = [den._forward_eager(*a) for a in calls]
    assert spans == {"pfpp.denoiser.capture": 1, "pfpp.denoiser.replay": 3}
    assert len(den._graphs) == 1
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (8, P, 7)
        assert torch.equal(g, w)
    assert got[0].data_ptr() != got[1].data_ptr()  # a fresh tensor a call


def test_denoiser_graph_inference_mode_and_no_grad(dev):
    den, cfg = _graph_denoiser(dev)
    a = _graph_inputs(dev, cfg, 8, 12, 1)
    with torch.inference_mode():
        inf = den(*a)
        inf_ref = den._forward_eager(*a)
    with torch.no_grad():
        ng = den(*a)
        ng_ref = den._forward_eager(*a)
    assert len(den._graphs) == 2  # the no_grad caller cannot write inference tensors
    with torch.inference_mode():
        assert torch.equal(den(*a), inf_ref)
    assert len(den._graphs) == 2
    assert torch.equal(inf, inf_ref) and torch.equal(ng, ng_ref)
    assert not ng.is_inference() and inf.is_inference()


def test_denoiser_graph_sees_in_place_weight_updates(dev):
    den, cfg = _graph_denoiser(dev)
    a = _graph_inputs(dev, cfg, 8, 16, 2)
    g = torch.Generator(device=dev).manual_seed(5)
    with torch.no_grad():
        before = den(*a)
        for p in den.parameters():  # as an optimizer step updates them
            p.add_(torch.randn(p.shape, generator=g, device=dev), alpha=1e-2)
        after = den(*a)
        want = den._forward_eager(*a)
    assert len(den._graphs) == 1
    assert not torch.equal(before, after)
    assert torch.equal(after, want)


def test_denoiser_graph_recaptured_after_to_and_assign(dev):
    den, cfg = _graph_denoiser(dev)
    a = _graph_inputs(dev, cfg, 8, 8, 3)
    with torch.inference_mode():
        den(*a)
    first = den._graph_params
    for move in ("to", "assign"):
        # the old tensors held, so that the allocator cannot hand their addresses back
        held = [t.detach() for t in (*den.parameters(), *den.buffers())]
        if move == "to":
            den.to("cpu").to(dev)
        else:
            sd = {k: v.clone() for k, v in den.state_dict().items()}
            den.load_state_dict(sd, assign=True)
        with torch.inference_mode():
            out, spans = _graph_spans(lambda: den(*a))
            want = den._forward_eager(*a)
        assert spans == {"pfpp.denoiser.capture": 1, "pfpp.denoiser.replay": 1}, move
        assert den._graph_params != first and len(den._graphs) == 1
        assert torch.equal(out, want), move
        first = den._graph_params
        del held


def test_denoiser_train_mode_is_eager_and_frees_the_graphs(dev):
    den, cfg = _graph_denoiser(dev)
    a = _graph_inputs(dev, cfg, 8, 20, 4)
    with torch.inference_mode():
        den(*a)
    assert den._graphs and den._graph_pool is not None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    den.train()
    gc.collect()
    torch.cuda.empty_cache()
    assert den._graphs == {} and den._graph_pool is None
    assert torch.cuda.memory_reserved() < held  # the pool went back to the card
    with torch.no_grad():
        torch.manual_seed(6)  # the same dropout masks in both calls
        out, spans = _graph_spans(lambda: den(*a))
        torch.manual_seed(6)
        want = den._forward_eager(*a)
    assert spans == {} and den._graphs == {}
    assert torch.equal(out, want)


def test_engine_call_with_denoiser_graph_equals_eager(dev, tmp_path):
    root = str(tmp_path)
    generate_dataset(root, num_shapes=8, seed=4, split="val", min_parts=3, max_parts=8,
                     n_points=96)
    cfg = R.Config()  # the published denoiser and verifier; a small VQ-VAE
    cfg.data.max_num_part = 8
    cfg.verifier.max_iters = 2
    torch.manual_seed(0)
    _, den, ver = R.make_models(cfg)
    vq = VQVAE(32, 16, 25, 64, sa_npoints=(24, 12), sa_nsamples=(8, 8, 8))
    engine = R.build_engine_fn(cfg, "cuda", models=(vq, den, ver))
    ds = DenoiserDataset(root + "/pc_data/val", mode="test",
                         matching_data_path=root + "/matching_data", max_num_part=8)
    batch = next(iter(Loader(ds, 8, shuffle=False, drop_last=False)))
    P = batch["part_valids"].shape[1]
    noise = draw_noise(R.agg_config(cfg), 8, P, torch.Generator().manual_seed(0), "cpu")
    noise = tuple(n.cuda() for n in noise)
    graphed, spans = _graph_spans(lambda: engine(batch, noise=noise))
    steps = int(graphed["n_iters"][0]) * cfg.denoiser.num_inference_steps
    assert spans == {"pfpp.denoiser.capture": 1, "pfpp.denoiser.replay": steps}
    den.forward = den._forward_eager  # the eager engine
    try:
        eager = engine(batch, noise=noise)
    finally:
        del den.forward
    assert graphed.keys() == eager.keys()
    for k in graphed:
        np.testing.assert_array_equal(graphed[k], eager[k], err_msg=k)


def _encoder_spans(fn):
    """(fn(), counts of the program's pfpp.encoder.* spans while it ran)."""
    from puzzlefusion_plusplus_tpu_torch.utils import profiling

    assert not profiling.profiling_on()  # ends the last session
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.profiling_on()  # starts this one, empty even where fn() opens no span
        out = fn()
    return out, {n: v["count"] for n, v in profiling.snapshot()["spans"].items()
                 if n.startswith("pfpp.encoder.")}


def test_frozen_encoder_splits_its_weights_once_for_kernel_s(dev, tmp_path):
    """Building the frozen encoder opens pfpp.encoder.weight_split once, its planes are
    ``tf32_planes`` of its folded W2 and W3 bit for bit; a b8 engine call opens no split, and
    every launch of S in it took the planes."""
    torch.manual_seed(0)
    vq = VQVAE(32, 16, 25, 64, sa_npoints=(24, 12), sa_nsamples=(8, 8, 8)).to(dev)
    enc, spans = _encoder_spans(lambda: make_frozen_encoder(vq))
    assert spans == {"pfpp.encoder.weight_split": 1}
    for sa in ("sa1", "sa2", "sa3"):
        (_, _), (w2, _), (w3, _) = enc.w[sa]
        for got, w in zip(enc.planes[sa], (w2, w3)):
            assert got.is_cuda and torch.equal(got, tsa.tf32_planes(w))
    assert make_frozen_encoder(vq, "always").planes == {}

    root = str(tmp_path)
    generate_dataset(root, num_shapes=8, seed=4, split="val", min_parts=3, max_parts=8,
                     n_points=96)
    cfg = R.Config()
    cfg.data.max_num_part = 8
    cfg.verifier.max_iters = 2
    _, den, ver = R.make_models(cfg)
    engine, spans = _encoder_spans(lambda: R.build_engine_fn(cfg, "cuda",
                                                             models=(vq, den, ver)))
    assert spans == {"pfpp.encoder.weight_split": 1}
    ds = DenoiserDataset(root + "/pc_data/val", mode="test",
                         matching_data_path=root + "/matching_data", max_num_part=8)
    batch = next(iter(Loader(ds, 8, shuffle=False, drop_last=False)))
    ops.reset_launch_counts()
    out, spans = _encoder_spans(lambda: engine(batch))
    counts = ops.launch_counts()
    assert spans == {} and np.isfinite(out["part_acc"]).all()
    assert counts["S"] > 0 and counts["S pre-split"] == counts["S"]


# ------------------------------------------- kernel D: the denoiser's inference linears


# (K, N, GEGLU epilogue) of the denoiser's linears at width 512, and the M of each engine
# cell's denoiser (25 tokens a part at the b8 pads 8-20 and the b1 pads 4-20)
DENSE_LINEARS = [(512, 1536, False), (512, 512, False), (512, 4096, True), (2048, 512, False)]
DENSE_M = [1600, 2400, 3200, 4000, 100, 200, 300, 400, 500]


def _dense_case(dev, M, K, N, geglu, seed=0):
    """x, D's planes and bias, and the float64 product (h * gelu(gate) with ``geglu``)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev)
    w = torch.randn((N, K), generator=g, device=dev) * K ** -0.5
    b = torch.randn((N,), generator=g, device=dev) * 0.1

    def product(x, w, b):
        y = torch.nn.functional.linear(x, w, b)
        if not geglu:
            return y
        h, gate = y.chunk(2, dim=-1)
        return h * torch.nn.functional.gelu(gate)
    return (x, tdense.weight_planes(w, geglu), tdense.bias_order(b, geglu),
            product(x.double(), w.double(), b.double()), product(x, w, b))


@pytest.mark.parametrize("K,N,geglu", DENSE_LINEARS)
@pytest.mark.parametrize("M", DENSE_M)
def test_dense_kernel_matches_float64_at_engine_shapes(dev, M, K, N, geglu):
    x, planes, bias, ref, cublas = _dense_case(dev, M, K, N, geglu)
    ops.reset_launch_counts()
    out = tdense.split_linear(x, planes, bias, geglu)
    scale = ref.abs().max().item()
    rel = (out.double() - ref).abs().max().item() / scale
    print(f"D M={M} K={K} N={N}: {rel:.3e} of the largest output; cuBLAS fp32 "
          f"{(cublas.double() - ref).abs().max().item() / scale:.3e}")
    assert out.shape == (M, N // 2 if geglu else N)
    assert rel <= 1e-5
    assert torch.equal(out, tdense.split_linear(x, planes, bias, geglu))  # no atomics
    assert ops.launch_counts()["D"] == 2


@pytest.mark.parametrize("M,K,N,geglu", [(1600, 2048, 512, False), (500, 512, 4096, True),
                                         (100, 512, 512, False), (4000, 512, 1536, False)])
def test_dense_kernel_at_every_block_shape_and_split(dev, M, K, N, geglu):
    """Every instantiation the wrapper may pick, each against float64 and across launches."""
    x, planes, bias, ref, _ = _dense_case(dev, M, K, N, geglu, seed=1)
    ran = 0
    for bm, bn, split in tdense.WAVE_COST:
        if N % bn or K % (split * tdense.KT):
            continue
        out = tdense._launch(x, planes, bias, geglu, bm, bn, split)
        rel = (out.double() - ref).abs().max().item() / ref.abs().max().item()
        assert rel <= 1e-5, (bm, bn, split, rel)
        assert torch.equal(out, tdense._launch(x, planes, bias, geglu, bm, bn, split))
        ran += 1
    assert ran == len(tdense.WAVE_COST)


def test_dense_kernel_without_bias_and_refusals(dev):
    x, planes, _, _, _ = _dense_case(dev, 300, 512, 1536, False, seed=2)
    w = tdense.weight_join(planes)
    out = tdense.split_linear(x, planes)
    ref = torch.nn.functional.linear(x.double(), w.double())
    assert (out.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    with pytest.raises(ValueError):
        tdense.split_linear(x[:, :256], planes)
    with pytest.raises(ValueError):
        tdense.split_linear(x, planes, geglu=True)  # the GEGLU epilogue needs its bias
    with pytest.raises(RuntimeError):
        tdense.split_linear(x.requires_grad_(), planes)


def _kernel_names(fn):
    """The CUDA kernels fn() launched (its device activity under torch.profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def test_denoiser_graph_runs_its_linears_on_kernel_d(dev):
    """A captured b8 forward launches D 36 times (6 layers: two fused q|k|v, two
    out-projections, the GEGLU projection, the feed-forward's out-projection), a replay adds
    those 36 to D's launch count, and a replay runs at least the 60 layer linears' worth fewer
    fp32 GEMM kernels than the forward through F.linear."""
    den, cfg = _graph_denoiser(dev)
    a = _graph_inputs(dev, cfg, 8, 12, 7)
    ops.reset_launch_counts()
    with torch.inference_mode():
        den(*a)  # warm-up calls and the capture
    per_forward = ops.launch_counts()["D"] // (GRAPH_WARMUP_CALLS + 1)
    assert per_forward == 36 and ops.launch_counts()["D"] % (GRAPH_WARMUP_CALLS + 1) == 0
    with torch.inference_mode():
        replay = _kernel_names(lambda: den(*a))
    with torch.enable_grad():  # autograd on: every linear through F.linear
        plain = _kernel_names(lambda: den._forward_eager(*a))
    # each replay counts the 36 launches it runs, as the capture's first one did
    assert ops.launch_counts()["D"] == 36 * (GRAPH_WARMUP_CALLS + 2)
    assert sum("dense_kernel" in n for n in replay) == 36
    assert not any("dense_kernel" in n for n in plain)
    gemm = lambda names: sum("gemm" in n.lower() and "dense_kernel" not in n  # noqa: E731
                             for n in names)
    assert gemm(plain) >= 60 and gemm(replay) <= gemm(plain) - 60, (gemm(replay), gemm(plain))


def _f_linear_forward(den, a):
    """The denoiser's forward with every linear through fp32 F.linear (autograd on keeps D
    out), from the weights as they are now."""
    with torch.enable_grad():
        return den._forward_eager(*a).detach()


@pytest.mark.parametrize("change", ["in_place", "to", "assign", "in_place_no_grad"])
def test_denoiser_on_kernel_d_follows_weight_changes(dev, change):
    """After an in-place update (as an optimizer step), a move away and back, and
    ``load_state_dict(assign=True)`` of new values, the replayed graph and the eager body
    both match a fresh F.linear forward of the new weights, not only each other. The planes
    first built under inference mode are rebuilt under ``no_grad`` too ("in_place_no_grad":
    as the sampler and verifier-data generation call after the engine)."""
    den, cfg = _graph_denoiser(dev)
    a = _graph_inputs(dev, cfg, 8, 16, 8)
    g = torch.Generator(device=dev).manual_seed(9)
    with torch.inference_mode():
        before = den(*a)
    held = [t.detach() for t in (*den.parameters(), *den.buffers())]
    if change.startswith("in_place"):
        with torch.no_grad():
            for p in den.parameters():
                p.add_(torch.randn(p.shape, generator=g, device=dev), alpha=1e-2)
    elif change == "to":
        den.to("cpu")
        with torch.no_grad():
            for p in den.parameters():
                p.mul_(1.01)
        den.to(dev)
    else:
        sd = {k: v + 1e-2 * torch.randn(v.shape, generator=g, device=dev)
              if v.is_floating_point() else v.clone() for k, v in den.state_dict().items()}
        den.load_state_dict(sd, assign=True)
    with torch.no_grad() if change == "in_place_no_grad" else torch.inference_mode():
        graphed = den(*a)
        eager = den._forward_eager(*a)
    want = _f_linear_forward(den, a)
    scale = want.abs().max().item()
    assert (before - want).abs().max().item() > 1e-3 * scale  # the change shows
    for got in (graphed, eager):
        assert (got - want).abs().max().item() <= 1e-4 * scale, change
    assert torch.equal(graphed, eager)
    del held


def test_denoiser_planes_stay_out_of_state_dict_and_train_mode(dev):
    den, cfg = _graph_denoiser(dev)
    keys = set(den.state_dict())
    with torch.inference_mode():
        den(*_graph_inputs(dev, cfg, 8, 8, 10))
    layer = den.transformer_layers[0]
    assert layer.self_attn._qkv.planes is not None and layer.ff._split.planes is not None
    assert set(den.state_dict()) == keys
    den.train()
    assert layer.self_attn._qkv.planes is None and layer.ff.net[0]._split.planes is None
