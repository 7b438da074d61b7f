"""The port's matcher drivers and run tooling (``puzzlefusion_plusplus_tpu_torch/scripts/``)
against the root ``scripts/`` of the JAX package, on the CPU, at the matcher tests' small
widths (``pc_feat_dim`` 32, ``aff_feat_dim`` 16, ``sa_npoints`` (32, 16, 8, 4), 400 points
of 2-4 parts); the JAX scripts are loaded unedited, by path.

* matcher_diagnosis: the device half (``diag_forward``) against ``_diag_device`` with the
  weights carried across by ``convert/from_jax``: the GT permutations, cross masks,
  critical counts and the classifier's counts exact; ``ds_mat`` and the oracle Sinkhorn
  within ``training/parity.py::MATCHING_SMALL``'s 2e-3 of the largest entry. The host half
  (``split_stats``) fed the JAX arrays gives the JAX F1 table exactly (the Hungarian over a
  near-uniform ``ds_mat`` can flip on float error, so each side's own arrays are not
  compared there).
* matcher_train_eval end to end at N_TRAIN=4 N_VAL=2 EPOCHS=2: the oracle ceiling equal to
  the JAX ``oracle_matching_stats`` (exact), the JAX payloads' keys, the written npz files,
  and the engine comparison with the three stage checkpoints and without them.
* matching_sensitivity_probe: its table and verdict equal to the JAX script's own
  statements run on the same records, in each of the verdict's three branches.
* kernel F's plain version at more selections than points, and the matcher encoder there,
  against the JAX package (exact; the encoder 1e-5 of its largest entry).
* the launchers, the supervisor, the stall watchdog and the evidence queue.
"""

import ast
import contextlib
import importlib.util
import inspect
import io
import json
import math
import os
import re
import shlex
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import jit_apply
from tests.test_torch_port_matching import flax_variables
from tests.test_torch_port_scripts import _jax_script, _narrow

from puzzlefusion_plusplus_tpu.matching.encoder import PointNet2MSGPointwise as JPN2
from puzzlefusion_plusplus_tpu.matching.oracle import oracle_matching_stats as joracle
from puzzlefusion_plusplus_tpu.matching.train import make_model as jmake
from puzzlefusion_plusplus_tpu.matching.train import numeric_batch
from puzzlefusion_plusplus_tpu.ops.fps import farthest_point_sample_xla
from puzzlefusion_plusplus_tpu_torch.convert.from_jax import matching_state_dict
from puzzlefusion_plusplus_tpu_torch.data.loader import Loader
from puzzlefusion_plusplus_tpu_torch.inference.run import make_models
from puzzlefusion_plusplus_tpu_torch.matching import train as mtrain
from puzzlefusion_plusplus_tpu_torch.matching.dataset import AllPieceMatchingDataset
from puzzlefusion_plusplus_tpu_torch.matching.encoder import PointNet2MSGPointwise
from puzzlefusion_plusplus_tpu_torch.ops.fps import farthest_point_sample
from puzzlefusion_plusplus_tpu_torch.scripts import Clock
from puzzlefusion_plusplus_tpu_torch.scripts import matcher_diagnosis as diag
from puzzlefusion_plusplus_tpu_torch.scripts import matcher_train_eval as mte
from puzzlefusion_plusplus_tpu_torch.scripts import matching_sensitivity_probe as probe
from puzzlefusion_plusplus_tpu_torch.scripts.synthetic_train_eval import ensure_splits
from puzzlefusion_plusplus_tpu_torch.training import parity
from puzzlefusion_plusplus_tpu_torch.training.state import (
    adamw_reference,
    best_checkpoint,
    load_model_state,
    save_checkpoint,
)
from puzzlefusion_plusplus_tpu_torch.training.vqvae import to_device
from puzzlefusion_plusplus_tpu_torch.utils.config import Config, apply_overrides

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCRIPTS = os.path.join(REPO, "puzzlefusion_plusplus_tpu_torch", "scripts")
SMALL = dict(pc_feat_dim=32, aff_feat_dim=16, sa_npoints=(32, 16, 8, 4))
N_PTS, MAX_PARTS, N_TRAIN, N_VAL = 400, 4, 4, 2
RUN_KW = dict(n_train=N_TRAIN, n_val=N_VAL, epochs=2, batch=2, num_points=N_PTS, val_every=1,
              mat_epoch=0, rig_epoch=1, model_kw=SMALL, device="cpu")


# ------------------------------------------------------------------ matcher_train_eval


@pytest.fixture(scope="module")
def matcher_run(tmp_path_factory):
    """The driver on a 4 + 2 shape root (2-4 parts, made beforehand: the driver then skips
    its 2-20-part generation), first without the stage checkpoints, then with seeded ones."""
    root = str(tmp_path_factory.mktemp("gen"))
    ev = str(tmp_path_factory.mktemp("evidence"))
    ensure_splits(root, N_TRAIN, N_VAL, Clock(), max_parts=MAX_PARTS)
    cfg = _narrow([f"data.max_num_part={MAX_PARTS}"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        first = mte.run(cfg, root, evidence_dir=ev, **RUN_KW)
    for name, model in zip(("vqvae", "denoiser", "verifier"), make_models(cfg)):
        save_checkpoint(f"{root}/out/everyday/{name}/ckpt", adamw_reference(model, 1e-4))
    second = mte.run(cfg, root, evidence_dir=ev, **RUN_KW)
    return dict(root=root, ev=ev, cfg=cfg, first=first, first_out=out.getvalue(),
                second=second)


def test_matcher_train_eval_writes_the_jax_payloads(matcher_run):
    r = matcher_run
    out = r["root"] + "/matcher_out"
    oracle = json.load(open(out + "/oracle_ceiling.summary.json"))
    assert set(oracle) == {"oracle", "num_points", "n_train", "epochs", "canonicalize",
                           "reference_schedule"}
    assert (oracle["num_points"], oracle["n_train"], oracle["epochs"]) == (N_PTS, N_TRAIN, 2)
    # without the three stage checkpoints: the JAX message, no comparison, no error
    assert mte.NO_ENGINE in r["first_out"] and r["first"]["comparison"] is None
    assert r["first"]["written"] == N_VAL
    files = sorted(os.listdir(r["root"] + "/matching_data_matcher_out"))
    assert len(files) == N_VAL and all(f.endswith(".npz") for f in files)
    assert r["second"]["checkpoint"] == best_checkpoint(out + "/ckpt") is not None
    comp = json.load(open(out + "/engine_matching_comparison.summary.json"))
    assert set(comp) == {"comparison", "num_points", "n_val", "matcher_epochs", "pos_weight",
                         "canonicalize", "reference_loop"}
    assert set(comp["comparison"]) == {"model", "gt-synthetic"}
    for agg in comp["comparison"].values():
        assert agg["num_samples"] == N_VAL and math.isfinite(agg["eval/part_acc"])
    metrics = [json.loads(line) for line in open(out + "/metrics.jsonl")]
    f1s = [m["val_mat_f1"] for m in metrics if "val_mat_f1" in m]
    assert len(f1s) == 2 and all(0 <= f <= 1 for f in f1s)  # VAL_EVERY=1 over 2 epochs
    dst = os.path.join(r["ev"], f"gen{N_TRAIN}", "matcher_out")
    assert {"oracle_ceiling.summary.json", "engine_matching_comparison.summary.json",
            "metrics.jsonl"} <= set(os.listdir(dst))


def test_matcher_oracle_ceiling_matches_jax(matcher_run):
    val_dir = matcher_run["root"] + "/pc_data/val"
    assert matcher_run["second"]["oracle"] == joracle(val_dir, num_points=N_PTS,
                                                      num_shapes=min(N_VAL, 16))


def test_matcher_stage_epochs_scale_as_the_jax_script():
    assert mte.stage_epochs(250) == (10, 200)
    assert mte.stage_epochs(120) == (4, 96)
    assert mte.stage_epochs(10) == (1, 8)


# ------------------------------------------------------------------ matcher_diagnosis


@pytest.fixture(scope="module")
def diag_setup(matcher_run):
    """The JAX script (its module constants set to this root's sizes), the JAX matcher with
    the trained checkpoint's weights and the port matcher loaded from them."""
    cache = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    saved = sys.modules.get("evidence")
    sys.modules["evidence"] = _jax_script("evidence")  # the script imports its sibling
    try:
        jmod = _jax_script("matcher_diagnosis")
    finally:
        if saved is None:
            del sys.modules["evidence"]
        else:
            sys.modules["evidence"] = saved
        # the script points JAX's compilation cache at the repository's: restore the suite's
        jax.config.update("jax_compilation_cache_dir", cache[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", cache[1])
    jmod.NUM_POINTS, jmod.MAX_PARTS, jmod.BATCH, jmod.N_SHAPES = N_PTS, MAX_PARTS, 2, 2
    trained = mtrain.make_model(**SMALL)
    ckpt = matcher_run["root"] + "/matcher_out/ckpt"
    trained.load_state_dict(load_model_state(ckpt))
    v = flax_variables(trained)
    port = mtrain.make_model(**SMALL)
    port.load_state_dict(matching_state_dict(v["params"], v["batch_stats"]))
    return dict(jmod=jmod, jm=jmake(**SMALL), v=v, port=port.eval(), ckpt=ckpt,
                root=matcher_run["root"])


def _jax_fn(s):
    jmod, v = s["jmod"], s["v"]
    return lambda b: jax.device_get(jmod._diag_device(v["params"], v["batch_stats"],
                                                      numeric_batch(b), s["jm"]))


def _first_batch(split_dir):
    ds = AllPieceMatchingDataset(split_dir, num_points=N_PTS, max_num_part=MAX_PARTS)
    return next(iter(Loader(ds, 2, shuffle=False, drop_last=False, seed=0)))


def test_diagnosis_device_half_matches_jax(diag_setup):
    s = diag_setup
    batch = _first_batch(s["root"] + "/pc_data/val")
    ref, ref_cls = _jax_fn(s)(batch)
    out, cls = diag.diag_forward(s["port"], to_device(batch, "cpu"))
    assert list(out) == list(ref) == list("ABCD")
    tol = parity.MATCHING_SMALL.metric_rel
    for name, (scores, n_crit, gtp, cross) in out.items():
        r_scores, r_n, r_gtp, r_cross = ref[name]
        np.testing.assert_array_equal(n_crit.numpy(), r_n, err_msg=name)
        np.testing.assert_array_equal(gtp.numpy(), r_gtp, err_msg=name)
        np.testing.assert_array_equal(cross.numpy(), r_cross, err_msg=name)
        # on the cross-piece pairs within the 2e-3; elsewhere the fills (0, -1e6) alike
        c, err = r_cross.astype(bool), np.abs(scores.numpy() - r_scores)
        scale = np.abs(r_scores[c]).max()
        assert err[c].max() <= tol * scale and err[~c].max() <= tol * scale, (name, err.max())
    assert int(ref["B"][1].sum()) > 0  # GT critical points exist
    assert {k: float(v) for k, v in cls.items()} == {k: float(v) for k, v in ref_cls.items()}


@pytest.mark.parametrize("split", ["val", "train"])
def test_diagnosis_host_half_fed_the_jax_arrays_matches_jax(diag_setup, split):
    s = diag_setup
    split_dir = f"{s['root']}/pc_data/{split}"
    ref = s["jmod"]._split_stats(split_dir, s["jm"], s["v"]["params"], s["v"]["batch_stats"])
    out = diag.split_stats(split_dir, _jax_fn(s), N_PTS, MAX_PARTS, 2, 2)
    assert out == ref and out["n_shapes"] == 2


def test_diagnosis_run_writes_the_jax_payload(diag_setup, tmp_path):
    s = diag_setup
    res = diag.run(s["root"], s["ckpt"], num_points=N_PTS, max_parts=MAX_PARTS, batch=2,
                   n_shapes=2, pc_feat=32, aff_feat=16, sa_npoints=(32, 16, 8, 4),
                   out_tag="tag", device="cpu", evidence_dir=str(tmp_path))
    assert set(res) == {"ckpt", "num_points", "max_parts", "regimes", "val", "train"}
    jax_src = open(os.path.join(REPO, "scripts", "matcher_diagnosis.py")).read()
    assert all(f'"{k}": "{v}"' in jax_src for k, v in res["regimes"].items())
    for split in ("val", "train"):
        assert set(res[split]) == {"A", "B", "C", "D", "cls", "n_shapes"}
        assert all(0 <= res[split][k][m] <= 1 for k in "ABCD"
                   for m in ("precision", "recall", "f1"))
    path = tmp_path / "tag" / "matcher" / "bottleneck_decomposition.summary.json"
    assert json.load(open(path))["val"] == json.loads(json.dumps(res["val"]))
    # regimes C and D need no weight: the weight-free path gives the same table
    oracle = diag.split_stats(s["root"] + "/pc_data/val",
                              lambda b: ({k: tuple(a.numpy() for a in v) for k, v in
                                          diag.oracle_regimes(to_device(b, "cpu")).items()},
                                         None), N_PTS, MAX_PARTS, 2, 2)
    assert oracle == {k: res["val"][k] for k in ("C", "D", "n_shapes")}


# ------------------------------------------------------------------ the sensitivity probe


def _jax_probe_block():
    """The JAX probe's statements from the per-shape table to the verdict (the script runs
    the engine at import, so they are run alone, on given records)."""
    src = open(os.path.join(REPO, "scripts", "matching_sensitivity_probe.py")).read()
    body = ast.parse(src).body
    names = [next((t.id for t in getattr(n, "targets", []) if isinstance(t, ast.Name)), None)
             for n in body]
    block = ast.Module(body=body[names.index("ids"):names.index("verdict") + 1],
                       type_ignores=[])
    return compile(block, "scripts/matching_sensitivity_probe.py", "exec")


def _check_probe_against_jax(by_model: dict, by_gt: dict) -> dict:
    ns = {"runs": {"model": {"by_shape": by_model}, "gt": {"by_shape": by_gt}}}
    exec(_jax_probe_block(), ns)
    table = probe.per_shape_table(by_model, by_gt)
    v = probe.verdict(table)
    assert table == ns["per_shape"]
    assert v["verdict"] == ns["verdict"] and v["shapes_differing"] == ns["n_diff"]
    assert [v["total_merged_pairs"]["model"], v["total_merged_pairs"]["gt"]] == \
        ns["total_merges"]
    assert v["n_shapes"] == len(table)
    return v


def _records(merges, accs):
    return {i: {"data_id": i, "n_merged_pairs": m, "n_iters": 1 + m, "part_acc": a}
            for i, (m, a) in enumerate(zip(merges, accs))}


@pytest.mark.parametrize("case", ["no_merges", "coincide", "sensitive"])
def test_probe_verdict_branches_match_jax(case):
    gt = _records([0, 0, 0], [0.5, 0.25, 1.0])
    model = {"no_merges": _records([0, 0, 0], [0.5, 0.25, 1.0]),
             "coincide": _records([1, 0, 2], [0.5, 0.25, 1.0]),
             "sensitive": _records([1, 0, 2], [0.5, 0.5, 1.0])}[case]
    if case == "coincide":
        gt = model
    v = _check_probe_against_jax(model, gt)
    assert v["verdict"].startswith({"no_merges": "no merges", "coincide": "merges executed",
                                    "sensitive": "merges executed"}[case])
    assert v["verdict"].endswith({"no_merges": "never opens",
                                  "coincide": "differing features",
                                  "sensitive": "matching-sensitive"}[case])


def test_probe_on_the_run_root(matcher_run, tmp_path):
    r = matcher_run
    s = probe.run(r["cfg"], r["root"], n_train=N_TRAIN, batch=8, device="cpu",
                  evidence_dir=str(tmp_path))
    assert s["n_shapes"] == N_VAL == len(s["per_shape"])
    assert set(s["aggregate"]) == {"model", "gt"}
    bd = {}
    for tag in ("model", "gt"):
        path = f"{r['root']}/out_msens/{tag}/inference/results/breakdown.jsonl"
        bd[tag] = {b["data_id"]: b for b in map(json.loads, open(path))}
    v = _check_probe_against_jax(bd["model"], bd["gt"])
    assert {k: s[k] for k in v} == v
    assert os.path.exists(tmp_path / f"gen{N_TRAIN}" / "engine" /
                          "matching_sensitivity.summary.json")


# ------------------------------------------------------------------ F at npoint > N


def test_fps_with_more_selections_than_points_matches_jax():
    """Once every valid point is taken, every distance is 0 and the first valid index
    repeats (``ops/fps.py::farthest_point_sample_xla``)."""
    rng = np.random.default_rng(21)
    xyz = rng.normal(size=(3, 24, 3)).astype(np.float32)
    mask = np.ones((3, 24), bool)
    mask[1, :5] = False
    mask[2, 7::2] = False
    for m in (mask, None):
        ref = np.asarray(farthest_point_sample_xla(jnp.asarray(xyz), 32,
                                                   None if m is None else jnp.asarray(m)))
        out = farthest_point_sample(torch.from_numpy(xyz), 32,
                                    None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref[:, 24:] == ref[:, :1]).all()


def test_matcher_encoder_with_more_centres_than_points_matches_jax():
    """SA1 selects 32 centres of 24 points (the stage-B point: 1024 of 1000)."""
    rng = np.random.default_rng(22)
    xyz = (rng.normal(size=(2, 24, 3)) * 0.3).astype(np.float32)
    pid = np.array([[0] * 12 + [1] * 12, [0] * 10 + [1] * 8 + [2] * 6], np.int32)
    valid = pid < np.array([2, 2])[:, None]  # the second sample's third piece is padding
    with torch.random.fork_rng():
        torch.manual_seed(3)
        port = PointNet2MSGPointwise(32, SMALL["sa_npoints"]).eval()
    v = flax_variables(port)
    ref = np.asarray(jit_apply(JPN2(32, SMALL["sa_npoints"]), v, jnp.asarray(xyz),
                               jnp.asarray(pid), jnp.asarray(valid), train=False))
    with torch.no_grad():
        out = port(torch.from_numpy(xyz), torch.from_numpy(pid), torch.from_numpy(valid))
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


# ------------------------------------------------------------------ the shell scripts


LAUNCHERS = {"train_vqvae.sh": "training.vqvae", "train_denoiser.sh": "training.denoiser",
             "train_verifier.sh": "training.verifier", "train_matching.sh": "matching.train",
             "inference.sh": "inference.run"}


def _keys(path: str) -> dict:
    """The key=value words of a launcher's command line."""
    words = shlex.split(open(path).read().replace("\\\n", " "), comments=True)
    return dict(w.split("=", 1) for w in words if re.match(r"^[a-z_][\w.]*=", w))


@pytest.mark.parametrize("name", list(LAUNCHERS))
def test_launcher_carries_the_jax_keys(name):
    port = os.path.join(PORT_SCRIPTS, name)
    keys = _keys(port)
    assert keys == _keys(os.path.join(REPO, "scripts", name)) and keys
    text = open(port).read()
    assert f"python -m puzzlefusion_plusplus_tpu_torch.{LAUNCHERS[name]} " in text
    assert text.rstrip().endswith('"$@"')
    if name == "train_matching.sh":  # its entry reads these keys and ignores any other
        read = set(re.findall(r'args(?:\.get\(|\[)"(\w+)"', inspect.getsource(mtrain.main)))
        assert set(keys) <= read, set(keys) - read
    else:  # unknown keys raise
        apply_overrides(Config(), [f"{k}={v}" for k, v in keys.items()])


def test_port_shell_scripts_parse_and_call_no_root_script():
    names = sorted(f for f in os.listdir(PORT_SCRIPTS) if f.endswith(".sh"))
    assert set(names) == {*LAUNCHERS, "supervise_train.sh", "stall_watchdog.sh",
                          "evidence_queue.sh", "warm_cache.sh", "evidence_snapshot.sh"}
    for name in names:
        path = os.path.join(PORT_SCRIPTS, name)
        subprocess.run(["bash", "-n", path], check=True, timeout=30)
        assert os.access(path, os.X_OK), name
        code = "".join(line for line in open(path) if not line.lstrip().startswith("#"))
        assert not re.search(r"(?<![\w/.])(?:scripts/\w+\.(?:py|sh)|bench\.py|test\.py|"
                             r"train_\w+\.py)|\bgit\s+(?:add|commit)", code), name


def _supervise(tmp_path, child, **env):
    pid, log = tmp_path / "run.pid", tmp_path / "run.log"
    subprocess.run(["bash", os.path.join(PORT_SCRIPTS, "supervise_train.sh"), str(pid),
                    str(log), "X=1", "--", "bash", "-c", child],
                   env={**os.environ, **env}, check=True, timeout=60)
    return pid, log.read_text()


def test_supervisor_stops_on_success(tmp_path):
    pid, log = _supervise(tmp_path, 'test "$X" = 1')
    assert "run complete" in log and not pid.exists()


def test_supervisor_breaks_a_crash_loop(tmp_path):
    pid, log = _supervise(tmp_path, "echo boom; exit 3", SUPERVISE_MAX_FAST="2")
    marker = (tmp_path / "run.crashloop").read_text()
    assert "CRASH LOOP" in marker and "boom" in marker
    assert log.count("exited rc=3") == 2 and not pid.exists()


def test_supervisor_stops_when_the_pid_file_goes(tmp_path):
    pid, log = _supervise(tmp_path, f"sleep 1; rm -f {tmp_path}/run.pid; exit 1")
    assert "pid file removed, stopping" in log and log.count("exited rc=1") == 1


WRITER = """
import sys, time
end = time.time() + float(sys.argv[2])
while True:
    if time.time() < end:
        with open(sys.argv[1], "a") as fh:
            fh.write('{"step": 1}\\n')
    elif sys.argv[3] == "exit":
        break
    time.sleep(0.3)
"""


def test_stall_watchdog_kills_a_silent_trainer_and_spares_a_live_one(tmp_path):
    """Two trainers under one 2 s window: one stops writing its metrics after 1 s and hangs,
    the other writes for 7 s and exits 0."""
    procs = {}
    for name, write_s, then in (("silent", 1, "hang"), ("live", 7, "exit")):
        root = tmp_path / name / "out" / "stage"
        root.mkdir(parents=True)
        child = subprocess.Popen([sys.executable, "-c", WRITER, str(root / "metrics.jsonl"),
                                  str(write_s), then])
        pidfile = tmp_path / f"{name}.pid"
        pidfile.write_text(str(child.pid))
        dog = subprocess.Popen(
            ["bash", os.path.join(PORT_SCRIPTS, "stall_watchdog.sh"), str(pidfile),
             str(tmp_path / name)],
            env={**os.environ, "STALL_WINDOW": "2", "STALL_LOG": str(tmp_path / f"{name}.log")})
        procs[name] = (child, dog, pidfile)
    try:
        assert procs["silent"][0].wait(timeout=30) != 0  # killed
        assert procs["live"][0].wait(timeout=30) == 0
    finally:
        for child, dog, pidfile in procs.values():
            pidfile.unlink()
            child.kill()
            dog.wait(timeout=30)
    assert "STALL" in (tmp_path / "silent.log").read_text()
    assert "STALL" not in (tmp_path / "live.log").read_text()


def test_evidence_queue_runs_port_drivers_with_keys_they_read():
    text = open(os.path.join(PORT_SCRIPTS, "evidence_queue.sh")).read().replace("\\\n", " ")
    jax_text = open(os.path.join(REPO, "scripts", "tpu_evidence_queue.sh")).read()
    stages, jax_stages = (re.findall(r'echo "=== stage (\w+)', t) for t in (text, jax_text))
    assert stages == jax_stages and len(stages) == 12
    assert "pfpp_torch_" in text and "/tmp/" not in text
    calls = re.findall(r"((?:[A-Z_0-9]+=\S+\s+)*)(?:timeout \d+\s+)?((?:[A-Z_0-9]+=\S+\s+)*)"
                       r"python -m \$PY\.([\w.]+)", text)
    assert len(calls) == 11  # bench_ok's, two in B, one in each other non-bench stage
    # every bench goes through bench_ok and stops the queue when it fails: C's three call
    # sites, D's and F's two each
    benches = re.findall(r"((?:[A-Z_0-9]+=\S+\s+)*)bench_ok [^\n|]*\|\| exit 1", text)
    assert len(benches) == len(re.findall(r'bench_ok "', text)) == 7
    calls += [(env, "", "bench") for env in benches]
    pkg = os.path.join(REPO, "puzzlefusion_plusplus_tpu_torch")
    package_src = "".join(open(os.path.join(d, f)).read() for d, _, fs in os.walk(pkg)
                          for f in fs if f.endswith(".py"))
    for before, after, mod in calls:
        spec = importlib.util.find_spec(f"puzzlefusion_plusplus_tpu_torch.{mod}")
        assert spec is not None, mod
        src = open(spec.origin).read()
        for key in re.findall(r"([A-Z_0-9]+)=", before + after):
            assert f'"{key}"' in (package_src if key.startswith("PFPP_") else src), (mod, key)
