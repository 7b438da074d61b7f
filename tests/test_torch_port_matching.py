"""Parity of the port's matcher modules (``puzzlefusion_plusplus_tpu_torch/matching/``) with
the JAX package, on the CPU, at the JAX tests' small sizes (160 points of 3-5 parts,
``pc_feat_dim`` 32, ``aff_feat_dim`` 16, ``sa_npoints`` (32, 16, 8, 4)); weights go through
``convert/from_jax.py::matching_state_dict``.

Tolerances and why:
  * ops, masks, indices, counts, the dataset's fields, the oracle, the spanning tree and every
    selection: exact (the same arithmetic; selections that can tie pick the lower index on
    both sides).
  * float ops (squared distances, PCA frames, Sinkhorn, Horn, RANSAC, chordal averaging):
    1e-5 of the largest entry (float32 sums in other orders).
  * modules in eval mode (running statistics): 1e-5 of the largest entry.
  * modules in train mode (batch statistics): 2e-3 of the largest entry. The train-mode
    BatchNorms of the encoder sit over few distinct rows at this size (the ball query repeats
    its first hit), so they amplify float error, and flax's BatchNorm computes its variance
    as E[x^2] - E[x]^2: measured here, the JAX package's train-mode forward sits 2.5e-5 from
    a float64 evaluation after the first SA stage where the port sits 1.7e-6, and the two
    forwards end up to 2.7e-4 to 1.5e-3 of the largest entry apart.
  * Adam under the cosine schedule: the rates 1e-6 relative (optax computes them in
    float32), the parameters 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.helpers import jit_apply, jit_init

from puzzlefusion_plusplus_tpu.data import generate_dataset as jgen
from puzzlefusion_plusplus_tpu.matching import alignment as jal
from puzzlefusion_plusplus_tpu.matching import layers as jlayers
from puzzlefusion_plusplus_tpu.matching import model as jmodel
from puzzlefusion_plusplus_tpu.matching import ops as jops
from puzzlefusion_plusplus_tpu.matching import sinkhorn as jsk
from puzzlefusion_plusplus_tpu.matching.dataset import AllPieceMatchingDataset as JDS
from puzzlefusion_plusplus_tpu.matching.encoder import DGCNN as JDGCNN
from puzzlefusion_plusplus_tpu.matching.encoder import PointNet2MSGPointwise as JPN2
from puzzlefusion_plusplus_tpu.matching.oracle import oracle_matching_stats as joracle
from puzzlefusion_plusplus_tpu.matching.train import make_model as jmake
from puzzlefusion_plusplus_tpu_torch.convert.from_jax import matching_state_dict
from puzzlefusion_plusplus_tpu_torch.matching import alignment as tal
from puzzlefusion_plusplus_tpu_torch.matching import encoder as tenc
from puzzlefusion_plusplus_tpu_torch.matching import layers as tlayers
from puzzlefusion_plusplus_tpu_torch.matching import model as tmodel
from puzzlefusion_plusplus_tpu_torch.matching import ops as tops
from puzzlefusion_plusplus_tpu_torch.matching import sinkhorn as tsk
from puzzlefusion_plusplus_tpu_torch.matching.dataset import AllPieceMatchingDataset as TDS
from puzzlefusion_plusplus_tpu_torch.matching.oracle import oracle_matching_stats as toracle
from puzzlefusion_plusplus_tpu_torch.matching.train import make_model as tmake
from puzzlefusion_plusplus_tpu_torch.training import state as tstate

torch.set_num_threads(2)
N_PTS, P = 160, 5
SMALL = dict(pc_feat_dim=32, aff_feat_dim=16, sa_npoints=(32, 16, 8, 4), max_num_part=P)
EVAL_TOL, TRAIN_TOL = 1e-5, 2e-3


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def close(out, ref, rel, what=""):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, what
    err = np.abs(out - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-30), f"{what}: {err} of {np.abs(ref).max()}"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two 160-point samples of synthetic fractured shapes (3-5 parts) and their labels."""
    root = str(tmp_path_factory.mktemp("match"))
    jgen(root, num_shapes=3, seed=4, split="val", min_parts=3, max_parts=5, n_points=96,
         with_matching=False, with_verifier=False)
    ds = TDS(root + "/pc_data/val", num_points=N_PTS, max_num_part=P)
    rng = np.random.default_rng(0)
    items = [ds.get(i, rng) for i in range(2)]
    b = {k: np.stack([it[k] for it in items]) for k in
         ("part_pcs", "gt_pcs", "piece_id", "part_valids", "critical_label_thresholds")}
    b["n_valid"] = b["part_valids"].sum(-1).astype(np.int32)
    b["labels"] = np.asarray(jops.fracture_point_labels(
        jnp.asarray(b["gt_pcs"]), jnp.asarray(b["piece_id"]), jnp.asarray(b["n_valid"]),
        jnp.asarray(b["critical_label_thresholds"])))
    b["root"] = root
    return b


# ------------------------------------------------------------------ ops


def _op_cases(data):
    pts = data["part_pcs"]
    n_pcs = np.array([[50, 40, 30, 0, 0], [60, 30, 30, 20, 0]])  # a padded tail (id P)
    pid_pad = np.asarray(jops.piece_ids(jnp.asarray(n_pcs), N_PTS))
    nv = np.array([3, 4], np.int32)
    valid = pid_pad < nv[:, None]
    lab = data["labels"]
    return {
        "piece_ids": (lambda m, x: m.piece_ids(x, N_PTS), (n_pcs,)),
        "same_piece_mask": (lambda m, x: m.same_piece_mask(x), (pid_pad,)),
        "valid_point_mask": (lambda m, x, n: m.valid_point_mask(x, n), (pid_pad, nv)),
        "diagonal_square_mask": (lambda m, x, n: m.diagonal_square_mask(x, n), (pid_pad, nv)),
        "square_distance": (lambda m, a: m.square_distance(a, a), (pts,)),
        "pca_canonicalize": (lambda m, a, x, v: m.pca_canonicalize(a, x, v, P),
                             (pts, pid_pad, valid)),
        "knn_piece_aware": (lambda m, a, x: m.knn_piece_aware(a, x, 16), (pts, pid_pad)),
        "knn_cross_piece": (lambda m, a, x: m.knn_piece_aware(a, x, 8, cross_piece=True),
                            (pts, pid_pad)),
        "fracture_point_labels": (lambda m, g, x, n, t: m.fracture_point_labels(g, x, n, t),
                                  (data["gt_pcs"], data["piece_id"], data["n_valid"],
                                   data["critical_label_thresholds"])),
        "compact_critical": (lambda m, lb, a, x: m.compact_critical(lb, a, x),
                             (lab, pts, data["piece_id"][..., None].astype(np.float32))),
        "critical_counts_per_piece": (lambda m, lb, x: m.critical_counts_per_piece(lb, x, P),
                                      (lab, data["piece_id"])),
    }


@pytest.mark.parametrize("name", ["piece_ids", "same_piece_mask", "valid_point_mask",
                                  "diagonal_square_mask", "square_distance",
                                  "pca_canonicalize", "knn_piece_aware", "knn_cross_piece",
                                  "fracture_point_labels", "compact_critical",
                                  "critical_counts_per_piece"])
def test_ops_match_jax(data, name):
    fn, args = _op_cases(data)[name]
    ref = jax.tree.leaves(_np(fn(jops, *[jnp.asarray(a) for a in args])))
    out = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), fn(tops, *[T(a) for a in args])))
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        if r.dtype.kind == "f":
            close(o, r, EVAL_TOL, name)
        else:
            np.testing.assert_array_equal(o.astype(r.dtype), r, err_msg=name)


def test_sinkhorn_log_and_hungarian_match_jax():
    rng = np.random.default_rng(1)
    s = rng.normal(size=(2, 12, 12)).astype(np.float32)
    nr, nc = np.array([12, 7]), np.array([12, 9])
    ref = np.asarray(jsk.sinkhorn_log(jnp.asarray(s), jnp.asarray(nr), jnp.asarray(nc)))
    out = tsk.sinkhorn_log(T(s), T(nr), T(nc)).numpy()
    close(out, ref, EVAL_TOL, "sinkhorn")
    assert (out[1, 7:] == 0).all() and (out[1, :, 9:] == 0).all()
    np.testing.assert_array_equal(tsk.hungarian(out, nr, nc), jsk._hungarian_host(ref, nr, nc))


def test_weighted_horn_and_transform_error_match_jax():
    rng = np.random.default_rng(2)
    src = rng.normal(size=(3, 20, 3)).astype(np.float32)
    tgt = src @ rng.normal(size=(3, 3)).astype(np.float32) + 0.1
    w = rng.random((3, 20)).astype(np.float32)
    w[1, :17] = 0  # three points carry the fit
    jr, jt = jal.weighted_horn(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w))
    tr, tt = tal.weighted_horn(T(src), T(tgt), T(w))
    close(tr.numpy(), jr, EVAL_TOL, "R")
    close(tt.numpy(), jt, EVAL_TOL, "t")
    close(tal.transform_error(tr, tt, T(src), T(tgt)).numpy(),
          jal.transform_error(jr, jt, jnp.asarray(src), jnp.asarray(tgt)), 1e-4, "error")


def test_ransac_with_injected_hypotheses_matches_jax():
    """The JAX function's own draws (the same key split and randint) injected into the
    port's, on matches with 25% outliers and an invalid tail."""
    rng = np.random.default_rng(4)
    src = rng.normal(size=(64, 3)).astype(np.float32)
    q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    q *= np.sign(np.linalg.det(q))
    tgt = (src @ q.T + rng.normal(size=3)).astype(np.float32)
    tgt[::4] += rng.normal(size=(16, 3)).astype(np.float32) * 5
    valid = np.arange(64) < 56
    key = jax.random.key(0)
    jr, jt = jax.jit(jal.ransac_transform)(jnp.asarray(src), jnp.asarray(tgt),
                                           jnp.asarray(valid), key)
    keys = jax.random.split(key, 128)
    hyp = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (3,), 0, 56))(keys))
    tr, tt = tal.ransac_transform(T(src), T(tgt), T(valid), hypotheses=T(hyp))
    close(tr.numpy(), jr, 1e-5, "R")
    close(tt.numpy(), jt, 1e-5, "t")
    # drawn from a generator, the port finds the same transform on these matches
    gr, _ = tal.ransac_transform(T(src), T(tgt), T(valid),
                                 generator=torch.Generator().manual_seed(0))
    close(gr.numpy(), q, 1e-3, "drawn")


def _graph(rng, n, n_edges):
    edges = np.stack([rng.integers(0, n, n_edges), rng.integers(0, n, n_edges)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    rel = np.repeat(np.eye(4)[None], len(edges), 0)
    for m in rel:
        q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        m[:3, :3] = q * np.sign(np.linalg.det(q))
        m[:3, 3] = rng.normal(size=3)
    return edges, rel


@pytest.mark.parametrize("seed", range(4))
def test_spanning_tree_matches_networkx_with_tied_weights(seed):
    """Duplicate pairs, both directions and weights 1/len(matches) that tie often, as the
    writer produces them: the same tree, walked in the same order, as networkx's."""
    rng = np.random.default_rng(seed)
    n = 7
    edges, rel = _graph(rng, n, 25)
    unc = 1.0 / rng.integers(3, 6, len(edges))
    ref = jal.global_alignment(n, edges, rel, unc)
    out = tal.global_alignment(n, edges, rel, unc)
    np.testing.assert_array_equal(out, ref)


def test_global_alignment_chordal_matches_jax():
    rng = np.random.default_rng(9)
    edges, rel = _graph(rng, 5, 12)
    unc = rng.random(len(edges)) + 0.1
    close(tal.global_alignment(5, edges, rel, unc, "chordal"),
          jal.global_alignment(5, edges, rel, unc, "chordal"), 1e-9, "chordal")
    np.testing.assert_array_equal(tal.global_alignment(5, edges[:0], rel[:0], unc[:0]),
                                  np.repeat(np.eye(4)[None], 5, 0))


# ------------------------------------------------------------------ dataset, oracle


def test_dataset_fields_match_jax(data):
    kw = dict(num_points=N_PTS, max_num_part=P)
    jds, tds = JDS(data["root"] + "/pc_data/val", **kw), TDS(data["root"] + "/pc_data/val", **kw)
    assert len(jds) == len(tds) == 3
    for i in range(3):
        a, b = jds.get(i, np.random.default_rng(i)), tds.get(i, np.random.default_rng(i))
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
            else:
                assert a[k] == b[k], k


def test_oracle_matches_jax(data):
    kw = dict(num_points=N_PTS, max_num_part=P, seed=3)
    assert toracle(data["root"] + "/pc_data/val", **kw) == joracle(
        data["root"] + "/pc_data/val", **kw)


# ------------------------------------------------------------------ modules


def _init(module, *args, **kw):
    return _np(jit_init(module, jax.random.key(0), *[jnp.asarray(a) for a in args],
                        train=False, **kw))


def flax_variables(port: torch.nn.Module) -> dict:
    """The flax {params, batch_stats} of a port matcher module (the inverse of
    ``matching_state_dict``): its seeded weights serve as the JAX model's, with no flax
    init to compile."""
    params, stats = {}, {}

    def put(tree, path, leaf, value):
        for k in path:
            tree = tree.setdefault(k, {})
        tree[leaf] = np.array(value.detach().numpy(), np.float32)

    for name, m in port.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(m, tlayers.BatchNormPoints):
            path += ("BatchNorm_0",)
        if isinstance(m, torch.nn.Linear):
            put(params, path, "kernel", m.weight.T)
            if m.bias is not None:
                put(params, path, "bias", m.bias)
        elif isinstance(m, (torch.nn.LayerNorm, torch.nn.BatchNorm2d)):
            put(params, path, "scale", m.weight)
            put(params, path, "bias", m.bias)
            if isinstance(m, torch.nn.BatchNorm2d):
                put(stats, path, "mean", m.running_mean)
                put(stats, path, "var", m.running_var)
        elif isinstance(m, tmodel.AffinityDual):
            put(params, path, "A", m.A)
    return {"params": params, "batch_stats": stats}


def _apply(module, v, *args, train, **kw):
    """-> (outputs, new batch_stats) of a JAX module."""
    jargs = [jnp.asarray(a) for a in args]
    if train:
        out, mut = jit_apply(module, v, *jargs, train=True, mutable=("batch_stats",), **kw)
        return _np(out), _np(mut["batch_stats"])
    return _np(jit_apply(module, v, *jargs, train=False, **kw)), v.get("batch_stats")


def _load(port, v):
    port.load_state_dict(matching_state_dict(v["params"], v.get("batch_stats", {})))
    return port


def _check_stats(port, stats, prefix=""):
    if not stats:
        return
    sd = port.state_dict()
    ref = matching_state_dict({}, stats)
    for k, r in ref.items():
        if "running" in k:
            close(sd[prefix + k].numpy(), r.numpy(), TRAIN_TOL, k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("layer", ["cross_attention", "point_transformer"])
def test_attention_layers_match_jax(data, layer, train):
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(2, N_PTS, 32)).astype(np.float32)
    pid = data["piece_id"]
    if layer == "cross_attention":
        valid = pid < data["n_valid"][:, None]
        valid[1, 100:] = False  # the rows of invalid points are fully masked
        mask = valid[:, None, :] & valid[:, :, None]
        jm, args = jlayers.CrossAttentionLayer(32, 8), (feats, mask)
        port = tlayers.CrossAttentionLayer(32, 8)
        v = _np(jit_init(jm, jax.random.key(0), *[jnp.asarray(a) for a in args]))
        ref = _np(jit_apply(jm, v, *[jnp.asarray(a) for a in args]))
        stats = None
    else:
        jm, args = jlayers.PointTransformerLayer(32, 32, 8, 16), (data["part_pcs"], feats, pid)
        port = tlayers.PointTransformerLayer(32, 32, 8, 16)
        v = _init(jm, *args)
        ref, stats = _apply(jm, v, *args, train=train)
    port = _load(port, v).train(train)
    with torch.no_grad():
        out = port(*[T(a) for a in args])
    close(out.numpy(), ref, TRAIN_TOL if train else EVAL_TOL, layer)
    _check_stats(port, stats)


def test_attention_fully_masked_row_is_uniform():
    """A query that sees no key averages every value, as the JAX softmax over -1e9 fills
    does (``scaled_dot_product_attention`` with a boolean mask gives NaN there)."""
    rng = np.random.default_rng(6)
    x = T(rng.normal(size=(1, 6, 8)).astype(np.float32))
    mask = torch.ones(1, 6, 6, dtype=torch.bool)
    mask[0, 2] = False
    attn = tlayers.MultiHeadAttention(2, 8)
    with torch.no_grad():
        out = attn(x, x, x, mask)
        v = attn.w_vs(x).mean(1)
        expect = attn.layer_norm(attn.fc(v) + x[:, 2])
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[:, 2], expect, rtol=1e-5, atol=1e-6)


MODEL_CASES = {"binary": {}, "multi": {"cls_method": "multi"},
               "canonicalize": {"canonicalize": True}}
FWD_KEYS = ("cls_logits", "part_feats", "ds_mat")
EXACT_KEYS = ("cls_pred", "crit_pid", "crit_order", "crit_slot_valid", "s_mask",
              "n_critical_sum")


@pytest.fixture(scope="module")
def models(data):
    """Per case: the JAX matcher, its variables (the port's seeded binary model:
    'canonicalize' shares them, 'multi' swaps in a 2-class head) with running statistics
    from one train-mode pass, and that pass's outputs and statistics."""
    args = [jnp.asarray(data[k]) for k in ("part_pcs", "piece_id", "n_valid", "labels")]
    with torch.random.fork_rng():
        torch.manual_seed(0)
        base = flax_variables(tmake(**SMALL))
    rng = np.random.default_rng(3)
    out = {}
    for name, kw in MODEL_CASES.items():
        jm = jmake(**SMALL, **kw)
        params = dict(base["params"])
        if name == "multi":
            params["cls_head"] = {"kernel": rng.normal(0, 0.2, (32, 2)).astype(np.float32),
                                  "bias": np.zeros(2, np.float32)}
        v = {"params": params, "batch_stats": base["batch_stats"]}
        train_out, stats = _apply(jm, v, *args, train=True)
        out[name] = (jm, {"params": params, "batch_stats": stats}, v, train_out)
    return out


def _port_model(case, v):
    return _load(tmake(**SMALL, **MODEL_CASES[case]), v)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_jigsaw_model_matches_jax(data, models, case, train):
    """The whole forward, and in train mode every running statistic after the pass."""
    if case == "binary" and not train:  # the weights' round trip through both trees
        with torch.random.fork_rng():
            torch.manual_seed(0)
            port = tmake(**SMALL)
        sd = matching_state_dict(**flax_variables(port))
        assert sorted(sd) == sorted(port.state_dict())
        assert all(torch.equal(sd[k], v) for k, v in port.state_dict().items())
    jm, v, v0, train_out = models[case]
    args = (data["part_pcs"], data["piece_id"], data["n_valid"], data["labels"])
    if train:  # the fixture's pass, from the initial statistics
        ref, port = train_out, _port_model(case, v0).train()
    else:
        ref, port = _apply(jm, v, *args, train=False)[0], _port_model(case, v).eval()
    with torch.no_grad():
        out = port(*[T(a) for a in args])
    for k in FWD_KEYS:
        close(out[k].numpy(), ref[k], TRAIN_TOL if train else EVAL_TOL, k)
    for k in EXACT_KEYS:
        np.testing.assert_array_equal(out[k].numpy().astype(ref[k].dtype), ref[k], err_msg=k)
    if train:
        _check_stats(port, v["batch_stats"])


@pytest.mark.parametrize("kind", ["pointnet2", "dgcnn"])
def test_encoder_matches_jax_in_train_mode(data, models, kind):
    """Each encoder alone on the batch statistics (the model tests hold PointNet++ in eval
    mode too): its features and its running statistics after the pass."""
    pts, pid = data["part_pcs"], data["piece_id"]
    valid = pid < data["n_valid"][:, None]
    if kind == "pointnet2":
        npoints = SMALL["sa_npoints"]
        jm, port = JPN2(32, npoints), tenc.PointNet2MSGPointwise(32, npoints)
        v0 = models["binary"][2]
        v = {"params": v0["params"]["encoder"], "batch_stats": v0["batch_stats"]["encoder"]}
    else:
        jm, port = JDGCNN(32), tenc.DGCNN(32)
        v = flax_variables(port)
    ref, stats = _apply(jm, v, pts, pid, valid, train=True)
    port = _load(port, v).train()
    with torch.no_grad():
        out = port(T(pts), T(pid), T(valid))
    close(out.numpy(), ref, TRAIN_TOL, kind)
    _check_stats(port, stats)


def test_jigsaw_model_with_predicted_labels_matches_jax(data, models):
    """Test mode, as the writer runs it: the classifier's own labels pick the critical
    points."""
    jm, v = models["binary"][:2]
    args = (data["part_pcs"], data["piece_id"], data["n_valid"], np.zeros_like(data["labels"]))
    ref = _np(jit_apply(jm, v, *[jnp.asarray(a) for a in args], train=False,
                        use_pred_labels=True))
    port = _load(tmake(**SMALL), v).eval()
    with torch.no_grad():
        out = port(*[T(a) for a in args], use_pred_labels=True)
    close(out["ds_mat"].numpy(), ref["ds_mat"], EVAL_TOL, "ds_mat")
    for k in ("cls_pred", "crit_pid", "n_critical_sum"):
        np.testing.assert_array_equal(out[k].numpy(), ref[k], err_msg=k)


# ------------------------------------------------------------------ losses


@pytest.fixture(scope="module")
def loss_inputs(data):
    """A random near-doubly-stochastic matrix over 120 compacted critical slots of 4 parts."""
    rng = np.random.default_rng(8)
    Nc, n = 128, np.array([120, 90])
    pid = np.sort(rng.integers(0, 4, (2, Nc)), axis=1).astype(np.int32)
    slot = np.arange(Nc)[None] < n[:, None]
    pid = np.where(slot, pid, 4)
    cross = (pid[:, :, None] != pid[:, None, :]) & slot[:, :, None] & slot[:, None, :]
    s = rng.normal(size=(2, Nc, Nc)).astype(np.float32)
    ds = np.asarray(jsk.sinkhorn_log(jnp.asarray(np.where(cross, s, -1e6)), jnp.asarray(n),
                                     jnp.asarray(n)))
    pts = rng.normal(size=(2, Nc, 3)).astype(np.float32)
    return dict(ds=ds, pts=pts, pid=pid, slot=slot, cross=cross, n=n)


def test_rigid_loss_pairs_matches_jax(loss_inputs):
    li = loss_inputs
    args = (li["ds"], li["pts"], li["pid"], li["slot"])
    jfn = jax.jit(jax.value_and_grad(lambda d, *r: jmodel.rigid_loss_pairs(d, *r, P)))
    ref, jgrad = jfn(*[jnp.asarray(a) for a in args])
    ds = T(li["ds"]).requires_grad_(True)
    out = tmodel.rigid_loss_pairs(ds, *[T(a) for a in args[1:]], P)
    out.backward()
    close(out.item(), float(ref), 1e-5, "rigid loss")
    close(ds.grad.numpy(), jgrad, 1e-4, "rigid loss gradient")


def test_permutation_loss_and_f1_match_jax(loss_inputs):
    li = loss_inputs
    gt = np.asarray(jmodel.gt_permutation(jnp.asarray(li["pts"]), jnp.asarray(li["cross"])))
    np.testing.assert_array_equal(
        tmodel.gt_permutation(T(li["pts"]), T(li["cross"])).numpy(), gt)
    jfn = jax.value_and_grad(jmodel.permutation_loss)
    ref, jgrad = jfn(jnp.asarray(li["ds"]), jnp.asarray(gt), jnp.asarray(li["n"]))
    ds = T(li["ds"]).requires_grad_(True)
    out = tmodel.permutation_loss(ds, T(gt), T(li["n"]))
    out.backward()
    close(out.item(), float(ref), 1e-5, "permutation loss")
    close(ds.grad.numpy(), jgrad, 1e-5, "permutation loss gradient")
    perm = tmodel.hungarian_perm(li["ds"], li["n"])
    ref_f1 = _np(jmodel.matching_f1(jnp.asarray(perm), jnp.asarray(gt),
                                    jnp.asarray(li["cross"], jnp.float32)))
    out_f1 = tmodel.matching_f1(T(perm), T(gt), T(li["cross"]).float())
    for k, r in ref_f1.items():
        close(out_f1[k].item(), r, 1e-6, k)


def test_adam_cosine_matches_optax():
    """Update k (from 0) runs at optax.cosine_decay_schedule(lr, T)(k), constant 0 after T,
    and the first updates equal optax.adam's."""
    lr, steps = 1e-3, 5
    sched = optax.cosine_decay_schedule(lr, steps)
    rng = np.random.default_rng(7)
    w0 = rng.normal(size=6).astype(np.float32)
    w = torch.nn.Parameter(T(w0))
    module = torch.nn.Module()
    module.w = w
    state = tstate.adam_cosine(module, lr, steps)
    tx = optax.adam(sched)
    opt_state, jw = tx.init(jnp.asarray(w0)), jnp.asarray(w0)
    seen = []
    for k in range(steps + 2):
        g = rng.normal(size=6).astype(np.float32)
        seen.append(state.optimizer.param_groups[0]["lr"])
        w.grad = T(g)
        state.optimizer.step()
        state.scheduler.step()
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, jw)
        jw = jw + upd
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), atol=1e-7, rtol=0)
    # optax evaluates the schedule in float32
    assert seen == pytest.approx([float(sched(k)) for k in range(steps + 2)], rel=1e-6,
                                 abs=1e-12)
