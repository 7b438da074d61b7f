"""Operations and bytes that the algorithm needs, counted from the configuration's widths and
each call's shapes; and the card's peaks.

Matrix products count 2 m k n operations, as ``torch.utils.flop_counter`` counts them; other
operations (norms, activations, the distance minima of FPS) are not counted. Every count is of
the work for the valid parts only: padded parts, the repeats that fill the encoder's slots
and masked attention scores are work the implementation chooses, which ``mfu_pct`` shows as
lost. ``computed=True`` counts what the plain reference computes at a pad instead: all part
slots, and part-local attention over all tokens. ``tests/test_flops.py`` holds those counts
against ``FlopCounterMode`` on the reference.
"""

from __future__ import annotations

SA_MLPS = ((64, 64, 128), (128, 128, 256), (256, 256, 512))

# NVIDIA H100 SXM data sheet, dense: TF32 on the tensor cores (the fastest route that is
# float32-accurate when split, as kernel S computes it) and HBM3 bandwidth.
PEAK_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12


def _stage_sizes(vq: dict, points: int):
    """Per SA stage (points in, centres, neighbours, feature width in)."""
    npoints = (vq["sa_npoints"][0], vq["sa_npoints"][1], vq["num_point"])
    n_in, d_in = points, 0
    for s in range(3):
        yield n_in, npoints[s], vq["sa_nsamples"][s], d_in
        n_in, d_in = npoints[s], SA_MLPS[s][-1]


def _tail(vq: dict) -> int:
    """conv6 and the code search of one cloud."""
    L, D, E = vq["num_point"], vq["num_dim"], vq["embedding_dim"]
    return 2 * L * SA_MLPS[2][-1] * D + 2 * (L * D // E) * E * vq["n_embeddings"]


def grouping_flops(vq: dict, points: int) -> int:
    """The ball queries' distance products of one cloud."""
    return sum(2 * S * n * 3 for n, S, _, _ in _stage_sizes(vq, points))


def encoder_cached_flops(vq: dict, points: int) -> int:
    """One cloud through the engine's encoder from its cached grouping: the rotated
    neighbourhoods, conv0 of the xyz offsets plus the projected features gathered, conv1,
    conv2, conv6, the codes, the rotated token centres."""
    total = 0
    for s, (n, S, K, d) in enumerate(_stage_sizes(vq, points)):
        c1, c2, c3 = SA_MLPS[s]
        total += 2 * S * K * 3 * 3 + 2 * S * K * 3 * c1 + 2 * n * d * c1
        total += 2 * S * K * (c1 * c2 + c2 * c3)
    return total + _tail(vq) + 2 * vq["num_point"] * 3 * 3


def encoder_posed_flops(vq: dict, points: int) -> int:
    """One cloud through the training loss's encoder: grouped as posed, conv0 of the
    concatenated offsets and gathered features."""
    total = grouping_flops(vq, points)
    for s, (n, S, K, d) in enumerate(_stage_sizes(vq, points)):
        c1, c2, c3 = SA_MLPS[s]
        total += 2 * S * K * ((3 + d) * c1 + c1 * c2 + c2 * c3)
    return total + _tail(vq)


def encoder_bytes(vq: dict, points: int) -> int:
    """Bytes one cloud's cached encode must move: each stage's offsets, indices and input
    features read once, its output written once (float32, int32 indices)."""
    total = 0
    for s, (n, S, K, d) in enumerate(_stage_sizes(vq, points)):
        total += 4 * (S * K * 3 + (S * K + n * d if d else 0) + S * SA_MLPS[s][-1])
    return total


def encoder_weight_bytes(vq: dict) -> int:
    """The encoder's weights, read once a step whatever the batch."""
    total, cin = 0, 3
    for mlp in SA_MLPS:
        for c in mlp:
            total += 4 * (cin * c + c)
            cin = c
        cin += 3
    return total + 4 * (SA_MLPS[2][-1] * vq["num_dim"] + vq["n_embeddings"] * vq["embedding_dim"])


def denoiser_flops(dn: dict, parts: int, tokens: int, computed: bool = False) -> int:
    """One shape of ``parts`` parts through the denoiser forward (``tokens`` a part). The
    needed count restricts part-local attention to each part's own tokens."""
    C, L, P = dn["embed_dim"], tokens, parts
    T = P * L
    nerf = 1 + 2 * dn["multires"]
    total = 2 * T * (dn["num_dim"] + 4 * nerf) * C + 2 * P * 7 * nerf * C
    local = T * T if computed else T * L
    per_layer = (2 * (2 * C * 2 * C)                    # the two AdaLN projections
                 + 2 * (4 * 2 * T * C * C)              # q, k, v, out of both attentions
                 + 2 * 2 * local * C + 2 * 2 * T * T * C  # scores and values
                 + 2 * T * C * 8 * C + 2 * T * 4 * C * C)  # GEGLU feed-forward
    total += dn["num_layers"] * per_layer
    for out in (3, 4):
        total += 2 * P * (C * C + C * (C // 2) + (C // 2) * out)
    return total


def verifier_flops(vf: dict, parts: int) -> int:
    """One shape's verify pass over its part pairs."""
    E, D, FF = parts * (parts - 1) // 2, vf["embed_dim"], vf["ff_dim"]
    per_layer = 2 * E * D * 3 * D + 2 * 2 * E * E * D + 2 * E * D * D + 2 * 2 * E * D * FF
    return 2 * E * vf["num_features"] * D + vf["num_layers"] * per_layer + 2 * E * D


def engine_shape_flops(cfg: dict, parts: int, iterations: int) -> int:
    """One shape through ``iterations`` engine iterations of S denoising steps, each but the
    loop's last followed by a verify pass, and its grouping once an iteration."""
    vq, dn, vf = cfg["vqvae"], cfg["denoiser"], cfg["verifier"]
    S = cfg["engine"]["num_inference_steps"]
    pts = cfg["data"]["points_per_part"]
    step = parts * encoder_cached_flops(vq, pts) + denoiser_flops(dn, parts, vq["num_point"])
    per_iter = S * step + parts * grouping_flops(vq, pts)
    verifies = min(iterations, cfg["engine"]["max_iters"] - 1)
    return iterations * per_iter + verifies * verifier_flops(vf, parts)


def train_step_flops(cfg: dict, parts_per_shape) -> int:
    """One training step over shapes of these part counts: the posed encode, and the
    denoiser's forward and backward (twice the forward's products)."""
    vq, dn = cfg["vqvae"], cfg["denoiser"]
    pts = cfg["data"]["points_per_part"]
    return sum(n * encoder_posed_flops(vq, pts) + 3 * denoiser_flops(dn, n, vq["num_point"])
               for n in parts_per_shape)
