"""``flops.py``'s product counts against ``FlopCounterMode`` on the reference."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from pfpp_bench import flops, harness, manifest
from pfpp_bench.reference import model as R

CFG = manifest.config(manifest.benchmark(), "pfpp_everyday_infer")
SMALL = {**CFG, "denoiser": {**CFG["denoiser"], "embed_dim": 64, "num_layers": 2,
                             "num_heads": 4},
         "verifier": {**CFG["verifier"], "embed_dim": 32, "num_layers": 2, "num_heads": 4,
                      "ff_dim": 64}}


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_encoder_cached_count():
    vq, pts = CFG["vqvae"], 300
    p = harness.draw_weights(CFG, 1, "cpu", ("vqvae",))["vqvae"]
    clouds = torch.rand(2, pts, 3) - 0.5
    stages = R.group(clouds, vq["num_point"], vq["sa_npoints"], vq["sa_nsamples"])
    rot = R.quat_to_matrix(R.quat_normalize(torch.randn(2, 4)))
    got = counted(lambda: R.encode(p, stages, rot, vq["num_dim"], vq["embedding_dim"]))
    assert got == 2 * flops.encoder_cached_flops(vq, pts)
    got = counted(lambda: R.group(clouds, vq["num_point"], vq["sa_npoints"], vq["sa_nsamples"]))
    assert got == 2 * flops.grouping_flops(vq, pts)


def test_encoder_posed_count():
    vq, pts = CFG["vqvae"], 300
    p = harness.draw_weights(CFG, 1, "cpu", ("vqvae",))["vqvae"]
    clouds = torch.rand(3, pts, 3) - 0.5

    def posed():
        stages = R.group(clouds, vq["num_point"], vq["sa_npoints"], vq["sa_nsamples"])
        R.encode(p, stages, None, vq["num_dim"], vq["embedding_dim"])

    assert counted(posed) == 3 * flops.encoder_posed_flops(vq, pts)


def test_denoiser_count():
    dn, L, B, P = SMALL["denoiser"], SMALL["vqvae"]["num_point"], 2, 3
    p = harness.draw_weights(SMALL, 1, "cpu", ("denoiser",))["denoiser"]
    args = (torch.randn(B, P, 7), torch.tensor([5, 900]), torch.randn(B, P, L, dn["num_dim"]),
            torch.randn(B, P, L, 3), torch.ones(B, P), torch.rand(B, P, 1),
            torch.zeros(B, P, dtype=torch.bool))
    got = counted(lambda: R.denoiser(p, dn, *args))
    assert got == B * flops.denoiser_flops(dn, P, L, computed=True)
    assert flops.denoiser_flops(dn, P, L) < flops.denoiser_flops(dn, P, L, computed=True)


def test_verifier_count():
    vf, B, P = SMALL["verifier"], 2, 5
    p = harness.draw_weights(SMALL, 1, "cpu", ("verifier",))["verifier"]
    pairs = torch.combinations(torch.arange(P), 2)
    E = len(pairs)
    got = counted(lambda: R.verifier(p, vf, torch.rand(B, E, 7), pairs[None].expand(B, -1, -1),
                                     torch.ones(B, E)))
    assert got == B * flops.verifier_flops(vf, P)
