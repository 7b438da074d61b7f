"""Kernel D's CPU side (``ops/dense.py``) and where the denoiser takes it
(``models/denoiser.py``).

* The plain version (the three split products in FP32) against ``F.linear``: 1e-6 of the
  largest output (the split drops only small*small, about 2^-21 of a product).
* The weights' planes: bit for bit back to the weight, ``tf32_planes``' rounding of W^T.
* ``tile_shape``: the block shapes the kernel takes, and at the engine's sizes a shape within
  15% of the card's sweep's fastest.
* The gate: on CPU tensors, under autograd, in training mode, under bf16 and with a forward
  hook, every linear runs through ``F.linear`` and D counts no launch; the model takes D only
  in fp32 at a width D's block shapes divide (``_d_capable``) and hands its layers no
  ``split`` off the graph's path.
* ``SplitWeights``: rebuilt into the same tensors after an in-place update and after a new
  parameter, as ordinary tensors even under inference mode (so that a rebuild under
  ``no_grad`` may write them); the denoiser's one watch rebuilds only when a source changed;
  planes never in ``state_dict()`` and dropped in training mode.
The kernel itself runs only on the card (``tests/test_torch_port_cuda.py``)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from puzzlefusion_plusplus_tpu_torch import ops
from puzzlefusion_plusplus_tpu_torch.inference import run as R
from puzzlefusion_plusplus_tpu_torch.models import denoiser as tden
from puzzlefusion_plusplus_tpu_torch.ops import dense as tdense
from puzzlefusion_plusplus_tpu_torch.ops import sa_fused as tsa


def _linear_ref(x, w, b, geglu):
    y = F.linear(x.double(), w.double(), None if b is None else b.double())
    if not geglu:
        return y
    h, gate = y.chunk(2, dim=-1)
    return h * F.gelu(gate)


@pytest.mark.parametrize("M,K,N,geglu,with_bias", [
    (100, 512, 1536, False, False),  # the fused q|k|v, batch 1 at the 4-part pad
    (37, 512, 512, False, True),     # an out-projection at a ragged M
    (64, 512, 4096, True, True),     # the GEGLU projection and its epilogue
    (25, 2048, 512, False, True),    # the feed-forward's out-projection
    (3, 32, 64, False, True),
])
def test_plain_version_matches_f_linear(M, K, N, geglu, with_bias):
    g = torch.Generator().manual_seed(M)
    x = torch.randn((2, M, K), generator=g)
    w = torch.randn((N, K), generator=g) * K ** -0.5
    b = torch.randn((N,), generator=g) * 0.1 if with_bias else None
    planes = tdense.weight_planes(w, geglu)
    bias = None if b is None else tdense.bias_order(b, geglu)
    ops.reset_launch_counts()
    out = tdense.split_linear(x, planes, bias, geglu)  # CPU: the plain version
    assert ops.launch_counts()["D"] == 0
    assert torch.equal(out, tdense.split_linear_plain(x, planes, bias, geglu))
    ref = _linear_ref(x, w, b, geglu)
    assert out.shape == (2, M, N // 2 if geglu else N) and out.dtype == torch.float32
    assert (out.double() - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()
    # fp32 F.linear itself sits at the same level
    fl = _linear_ref(x.float(), w, b, geglu).float() if not geglu else None
    if fl is not None:
        assert (fl.double() - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


@pytest.mark.parametrize("geglu", [False, True])
def test_planes_round_trip_and_use_the_kernels_rounding(geglu):
    g = torch.Generator().manual_seed(3)
    w = torch.randn((128, 64), generator=g)
    w[0, :4] = torch.tensor([0.0, -1.5, 1e-40, 3.4e38])  # zero, a subnormal, near the top
    planes = tdense.weight_planes(w, geglu)
    assert planes.shape == (8, 2, 16, 2, 8, 4)
    back = tdense.weight_join(planes, geglu)
    assert np.array_equal(back.numpy().view(np.uint32), w.numpy().view(np.uint32))
    big = planes[:, 0].contiguous().view(torch.int32)
    assert not (big & 0x1FFF).any()  # TF32: 10 mantissa bits
    # the planes are tf32_planes of W^T in the kernel's input (and GEGLU column) order
    order = tdense._k_order(64)
    wt = w.t()[:, tdense._geglu_cols(128)] if geglu else w.t()
    assert torch.equal(planes, tsa.tf32_planes(wt[order].contiguous()))
    assert sorted(order.tolist()) == list(range(64))
    assert order[:8].tolist() == [0, 4, 8, 12, 1, 5, 9, 13]  # a lane's float4 feeds 2 slices
    if geglu:
        cols = tdense._geglu_cols(128).tolist()
        assert cols[:8] == list(range(8)) and cols[8:16] == list(range(64, 72))


def test_tile_shape_fits_the_kernels_constraints():
    for M in (1, 100, 500, 1600, 4000, 100000):
        for K, N in ((512, 1536), (512, 512), (512, 4096), (2048, 512), (32, 64)):
            bm, bn, split = tdense.tile_shape(M, N, K)
            assert (bm, bn, split) in tdense.WAVE_COST
            assert N % bn == 0 and K % (split * tdense.KT) == 0
    for N, K in ((48, 512), (512, 48), (32, 32)):
        with pytest.raises(ValueError):
            tdense.tile_shape(100, N, K)


@pytest.mark.parametrize("M,N,K,fast", [
    # the shapes within 15% of the fastest in the card's sweep (chip_smoke.py's dense_shapes),
    # at batch 1, where a split of 4 over clusters that the card cannot hold at once costs a
    # second wave: 128x64 split 4 took 17.2 us for the out-projection at M = 400 and 64x64
    # split 2 8.8 us
    (400, 512, 512, {(64, 64, 2), (64, 64, 4)}), (500, 512, 512, {(64, 64, 2)}),
    (400, 512, 2048, {(64, 64, 4), (64, 64, 2)}), (500, 512, 2048, {(64, 64, 2)}),
    (300, 1536, 512, {(64, 64, 1), (64, 64, 2)}),
    # and at batch 8, where whole waves of large blocks win
    (4000, 4096, 512, {(128, 128, 1)}), (1600, 1536, 512, {(128, 64, 1), (64, 64, 1),
                                                           (128, 128, 1)}),
])
def test_tile_shape_picks_a_shape_the_sweep_found_fast(M, N, K, fast):
    assert tdense.tile_shape(M, N, K) in fast


def _small_denoiser(dtype=None):
    torch.manual_seed(0)
    return tden.DenoiserTransformer(embed_dim=64, num_layers=1, num_heads=2, num_dim=8,
                                    max_parts=4, num_ada_embeds=16, dtype=dtype)


def _inputs(B=2, P=4, L=3, D=8):
    g = torch.Generator().manual_seed(1)
    valid = torch.ones((B, P))
    valid[0, 3] = 0
    ref = torch.zeros((B, P), dtype=torch.bool)
    ref[:, 0] = True
    return (torch.randn((B, P, 7), generator=g), torch.randint(0, 16, (B,), generator=g),
            torch.randn((B, P, L, D), generator=g), torch.randn((B, P, L, 3), generator=g),
            valid, torch.rand((B, P, 1), generator=g) + 0.5, ref)


@pytest.mark.parametrize("case", ["cpu", "grad", "train", "bf16", "hook"])
def test_denoiser_keeps_f_linear_off_kernel_d(case, monkeypatch):
    """Each case runs the denoiser's forward on the CPU and every linear of its layers goes
    through F.linear (the module path), D counting no launch."""
    den = _small_denoiser(torch.bfloat16 if case == "bf16" else None)
    den.train(case == "train")
    if case == "hook":
        den.transformer_layers[0].ff.net[2].register_forward_hook(lambda *_: None)
    calls = []
    real = F.linear
    monkeypatch.setattr(torch.nn.functional, "linear",
                        lambda x, w, b=None: calls.append(tuple(w.shape)) or real(x, w, b))
    ops.reset_launch_counts()
    with torch.set_grad_enabled(case == "grad"):
        torch.manual_seed(2)
        out = den(*_inputs())
    assert torch.isfinite(out.float()).all()
    assert ops.launch_counts()["D"] == 0
    # the layer's linears: q, k, v, out twice, the GEGLU projection, the FF out-projection
    layer = [(64, 64)] * 8 + [(512, 64), (64, 256)]
    for shape in set(layer):
        assert calls.count(shape) >= layer.count(shape), (shape, calls)


def test_d_only_where_the_model_can_take_it(monkeypatch):
    """D needs fp32 and a width of a multiple of 64; off the graph's path (here: CPU inputs)
    the model hands its layers ``split=False``, whichever entry point runs."""
    assert _small_denoiser()._d_capable
    assert not _small_denoiser(torch.bfloat16)._d_capable
    torch.manual_seed(0)
    assert not tden.DenoiserTransformer(embed_dim=48, num_layers=1, num_heads=2, num_dim=8,
                                        max_parts=4, num_ada_embeds=16)._d_capable
    den = _small_denoiser().eval()
    seen = []
    real = tden.EncoderLayer.forward
    monkeypatch.setattr(tden.EncoderLayer, "forward",
                        lambda self, *a: seen.append(a[-1]) or real(self, *a))
    with torch.inference_mode():
        den(*_inputs())
        den._forward_eager(*_inputs())
    assert seen == [False, False]
    assert den._split_watch is None  # no planes were built


def test_split_weights_rebuild_in_place_and_outside_inference_mode():
    lins = (torch.nn.Linear(64, 64, bias=False), torch.nn.Linear(64, 64, bias=False))
    split = tdense.SplitWeights(lins)
    assert split.sources() == [lins[0].weight, lins[1].weight]
    with torch.inference_mode():  # as the engine first builds them
        split.build()
    planes = split.planes
    assert not planes.is_inference() and split.bias is None
    assert torch.equal(tdense.weight_join(planes),
                       torch.cat([lins[0].weight, lins[1].weight]).detach())
    with torch.no_grad():
        lins[1].weight.add_(1.0)  # in place: rebuilt into the same tensor, under no_grad
        split.build()
    assert split.planes is planes
    assert torch.equal(tdense.weight_join(planes)[64:], lins[1].weight.detach())
    lins[0].weight = torch.nn.Parameter(torch.ones(64, 64))  # a new parameter
    split.build()
    assert split.planes is planes
    assert torch.equal(tdense.weight_join(planes)[:64], torch.ones(64, 64))
    x = torch.randn(5, 64)
    assert torch.allclose(split(x), torch.cat([lin(x) for lin in lins], -1).detach(),
                          rtol=1e-5, atol=1e-5)
    split.drop()
    assert split.planes is None


def test_denoiser_watch_rebuilds_after_in_place_updates_and_stays_out_of_state_dict(
        monkeypatch):
    cfg = R.Config()
    cfg.denoiser.embed_dim, cfg.denoiser.num_layers, cfg.denoiser.num_heads = 64, 2, 2
    den = tden.make_denoiser(cfg).eval()
    keys = set(den.state_dict())
    builds = []
    real = tdense.weight_planes
    monkeypatch.setattr(tdense, "weight_planes", lambda *a: builds.append(1) or real(*a))
    with torch.inference_mode():
        den._refresh_split()
    assert len(builds) == 2 * 6  # each layer's six planes
    layer = den.transformer_layers[1]
    planes = layer.ff._split.planes
    assert planes is not None and layer.self_attn._qkv.planes is not None
    watched = den._split_watch
    den._refresh_split()
    assert den._split_watch is watched and len(builds) == 12  # nothing changed: no rebuild
    with torch.no_grad():
        layer.ff.net[2].weight.mul_(2.0)
        den._refresh_split()  # in place into the planes built under inference mode
    assert layer.ff._split.planes is planes
    assert torch.equal(tdense.weight_join(planes), layer.ff.net[2].weight.detach())
    assert den._split_watch is not watched
    assert set(den.state_dict()) == keys
    den.train()
    assert all(s.planes is None for s in tden._splits(layer)) and den._split_watch is None
