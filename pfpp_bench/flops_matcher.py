"""Operations and bytes that the Jigsaw matcher's training step needs, counted from the
configuration's widths and each step's shapes (``flops.py`` holds the card's peaks).

Matrix products count 2 m k n, as ``torch.utils.flop_counter`` counts them. A product in
the loss's graph counts once forward and once for each gradient the backward needs: the
weight's always, the input's where the input carries one (not the first conv of SA1 nor the
PointTransformer's first position layer, which take coordinates alone). The distance
products of the queries (ball queries, 3-NN, kNN, the fracture labels, the GT permutation)
count forward only. Norms, softmaxes, the Sinkhorn normalisations and the rigid loss (the
cell's loss stage has none) are not counted.

Every count is of the valid points: a shape's ``num_points`` points (all valid, as the
dataset fills them) and its ``n`` critical points. The program runs its affinity head, its
affinity and its GT permutation's distances over every slot; ``computed=True`` counts what
the plain reference computes instead: the GT permutation's distances over every point.
``pfpp_bench/tests/test_bench_matcher.py::test_flops_match_the_counter_on_the_reference``
holds those counts against ``FlopCounterMode`` on the reference.
"""

from __future__ import annotations


def _dist(a: int, b: int) -> int:
    """One expanded-form squared-distance product of a x b points."""
    return 2 * a * b * 3


def _mlp(rows: int, widths, input_grad: bool = True) -> int:
    """Dense layers widths[0] -> widths[1] -> ... over ``rows`` rows: forward, the weights'
    gradients, and the inputs' gradients (the first layer's only with ``input_grad``)."""
    total = 0
    for j in range(len(widths) - 1):
        total += 2 * rows * widths[j] * widths[j + 1] * (3 if j or input_grad else 2)
    return total


def encoder_flops(m: dict, points: int) -> int:
    """One shape of ``points`` points through PointNet++ MSG, forward and backward."""
    total, n_in, cin, levels = 0, points, 3, []
    for s, level in enumerate(m["sa_plan"]):
        S = m["sa_npoints"][s]
        for nsample, mlp in zip(level["nsamples"], level["mlps"]):
            total += _dist(S, n_in)
            total += _mlp(S * min(nsample, n_in), [cin + 3, *mlp], input_grad=s > 0)
        cin = sum(mlp[-1] for mlp in level["mlps"])
        levels.append((S, cin))
        n_in = S
    fp = dict((k, v) for k, v in m["fp_plan"])
    (s1, w1), (s2, w2), (s3, w3), (s4, w4) = levels
    for fine, coarse, cin, name in ((s3, s4, w3 + w4, "fp4"), (s2, s3, w2 + fp["fp4"][-1], "fp3"),
                                    (s1, s2, w1 + fp["fp3"][-1], "fp2"),
                                    (points, s1, fp["fp2"][-1], "fp1")):
        total += _dist(fine, coarse) + _mlp(fine, [cin, *fp[name]])
    return total + _mlp(points, [fp["fp1"][-1], m["pc_feat_dim"]])


def attention_flops(m: dict, points: int) -> int:
    """The PointTransformer layer and the cross-attention layer over ``points`` points."""
    C, h, k = m["pc_feat_dim"], m["tf_num_heads"], m["tf_num_samples"]
    rows = points * k
    total = 3 * _mlp(points, [C, C]) + _dist(points, points)
    total += _mlp(rows, [3, 3], input_grad=False) + _mlp(rows, [3, C])
    total += _mlp(rows, [C, C // h, C // h]) + 3 * 2 * points * k * C
    total += 4 * _mlp(points, [C, C]) + 3 * 2 * 2 * points * points * C
    return total + _mlp(points, [C, 2 * C, C])


def matching_flops(m: dict, n: int) -> int:
    """The affinity head, the bilinear affinity and the GT permutation's distances of one
    shape's ``n`` critical points."""
    aff = m["aff_feat_dim"]
    hd = aff // 2
    return _mlp(n, [m["pc_feat_dim"], aff]) + 3 * 2 * n * hd * (hd + n) + _dist(n, n)


def train_step_flops(cfg: dict, n_crit, computed: bool = False) -> int:
    """One step over shapes with these critical counts (a shape a count)."""
    m, N = cfg["model"], cfg["data"]["num_points"]
    classifier = 3 * 2 * N * m["pc_feat_dim"] * (1 if m["cls_method"] == "binary" else 2)
    total = 0
    for n in n_crit:
        total += _dist(N, N) + encoder_flops(m, N) + attention_flops(m, N) + classifier
        total += matching_flops(m, n) + (_dist(N, N) - _dist(n, n) if computed else 0)
    return total


def sinkhorn_bytes(n: int, iters: int) -> int:
    """The least bytes of a log-space Sinkhorn over a valid [n, n] float32 block: the matrix
    read once a half-iteration (a row or a column normalisation), the scores read once and
    the result written once. It reads the same whatever implements the loop."""
    return (2 * iters + 2) * n * n * 4
