"""The port as a package: import isolation from JAX, the device rule of its entry points,
its copies of the numpy-only data modules, and the inference entry end to end on the CPU.

Tolerances: synthetic files and batch structure exact; augmented float arrays 1e-5 (the
JAX package may run its augmentation in the native host library, the port in numpy)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from puzzlefusion_plusplus_tpu.data import generate_dataset as jgen
from puzzlefusion_plusplus_tpu.data.bucketing import part_bucket as jbucket
from puzzlefusion_plusplus_tpu.data.bucketing import slice_batch_parts as jslice
from puzzlefusion_plusplus_tpu.data.datasets import DenoiserDataset as JDS
from puzzlefusion_plusplus_tpu.data.loader import Loader as JLoader
from puzzlefusion_plusplus_tpu_torch.data import DenoiserDataset, Loader, generate_dataset
from puzzlefusion_plusplus_tpu_torch.data.bucketing import part_bucket, slice_batch_parts
from puzzlefusion_plusplus_tpu_torch.inference import run as R
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import puzzlefusion_plusplus_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'networkx', "
        "'puzzlefusion_plusplus_tpu')]\n"
        "assert len(mods) > 20, mods\n"
        "matching = {'alignment', 'dataset', 'encoder', 'eval', 'generate', 'layers', "
        "'model', 'ops', 'oracle', 'sinkhorn', 'train'}\n"
        "assert {'puzzlefusion_plusplus_tpu_torch.matching.' + m for m in matching} "
        "<= set(mods), mods\n"
        "tools = {'bench', 'render_results', 'utils.native', 'utils.profiling', "
        "'utils.sanitize', 'data.meshio', 'data.preprocess', 'data.generate_pc_data', "
        "'renderer', 'renderer.artifacts', 'renderer.blender', 'renderer.matching_vis', "
        "'renderer.pc_renderer', 'renderer.rasterizer', 'inference', 'inference.engine', "
        "'inference.sampler', 'ops.sa_fused', 'ops.dense', 'training.loop'}\n"
        "assert {'puzzlefusion_plusplus_tpu_torch.' + m for m in tools} <= set(mods), mods\n"
        "scripts = {'evidence', 'engine_breakdown', 'part_acc_floor', 'overfit_proof', "
        "'synthetic_train_eval', 'eval_train_split', 'rescore_checkpoints', "
        "'denoiser_extend', 'verifier_regen_eval', 'matcher_train_eval', "
        "'matcher_diagnosis', 'matching_sensitivity_probe'}\n"
        "assert {'puzzlefusion_plusplus_tpu_torch.scripts', *('puzzlefusion_plusplus_tpu_torch"
        ".scripts.' + m for m in scripts)} <= set(mods), mods\n"
        "assert not [m for m in sys.modules if m == 'scripts' or m.startswith('scripts.') "
        "or m in ('evidence', 'engine_breakdown')], 'the root scripts/ were imported'\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                   timeout=120)


def test_entry_needs_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        R.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        R.build_engine_fn(R.Config(), "cuda")
    assert R.resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.fixture(scope="module")
def data_roots(tmp_path_factory):
    roots = []
    for gen in (jgen, generate_dataset):
        root = str(tmp_path_factory.mktemp("gen"))
        gen(root, num_shapes=3, seed=4, split="val", min_parts=3, max_parts=5, n_points=96)
        roots.append(root)
    return roots


def test_synthetic_copy_writes_the_same_files(data_roots):
    jroot, troot = data_roots
    for sub in ("pc_data/val", "matching_data", "verifier_data"):
        names = sorted(os.listdir(os.path.join(jroot, sub)))
        assert names == sorted(os.listdir(os.path.join(troot, sub)))
        for name in names:
            a = np.load(os.path.join(jroot, sub, name), allow_pickle=True)
            b = np.load(os.path.join(troot, sub, name), allow_pickle=True)
            assert a.files == b.files
            for k in a.files:
                if a[k].dtype == object:
                    for x, y in zip(a[k], b[k]):
                        np.testing.assert_array_equal(x, y)
                else:
                    np.testing.assert_array_equal(a[k], b[k])


def test_dataset_loader_bucketing_match_jax(data_roots):
    root = data_roots[0]
    kw = dict(mode="test", matching_data_path=root + "/matching_data", max_num_part=8,
              max_corr=32, max_edges_dense=40)
    jds, tds = JDS(root + "/pc_data/val", **kw), DenoiserDataset(root + "/pc_data/val", **kw)
    np.testing.assert_array_equal(tds.num_parts_list(), jds.num_parts_list())
    order = np.argsort(jds.num_parts_list(), kind="stable")
    jb = next(iter(JLoader(jds, 3, shuffle=False, drop_last=False, seed=2, order=order)))
    tb = next(iter(Loader(tds, 3, shuffle=False, drop_last=False, seed=2, order=order)))
    P_b = part_bucket(int(tb["num_parts"].max()))
    assert P_b == jbucket(int(jb["num_parts"].max()))
    jb, tb = jslice(jb, P_b), slice_batch_parts(tb, P_b)
    assert sorted(jb) == sorted(tb)
    for k in jb:
        if isinstance(jb[k], list):
            assert jb[k] == tb[k], k
        elif jb[k].dtype.kind == "f":
            np.testing.assert_allclose(tb[k], jb[k], atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def _small_cfg(root):
    cfg = R.Config()
    cfg.data.max_num_part = 5
    cfg.data.data_val_dir = root + "/pc_data/val"
    cfg.data.matching_data_path = root + "/matching_data"
    cfg.denoiser.embed_dim = 32
    cfg.denoiser.num_layers = 1
    cfg.denoiser.num_heads = 2
    cfg.verifier.embed_dim = 32
    cfg.verifier.num_layers = 1
    cfg.verifier.num_heads = 2
    cfg.verifier.max_iters = 2
    cfg.inference.batch_size = 2
    return cfg


def _small_models(cfg):
    _, den, ver = R.make_models(cfg)
    vq = VQVAE(32, 16, 25, 64, sa_npoints=(24, 12), sa_nsamples=(8, 8, 8))
    return vq, den, ver


def test_run_inference_cpu_end_to_end(data_roots, tmp_path):
    cfg = _small_cfg(data_roots[1])
    cfg.trainer.output_dir = str(tmp_path)
    engine = R.build_engine_fn(cfg, "cpu", models=_small_models(cfg))
    agg = R.run_inference(cfg, engine=engine)
    assert agg["num_samples"] == 3
    for k in R.METRIC_KEYS:
        assert np.isfinite(agg[f"eval/{k}"]), k
    assert 0.0 <= agg["eval/part_acc"] <= 1.0
    out_dir = os.path.join(str(tmp_path), cfg.trainer.experiment_name, "inference",
                           cfg.inference.inference_dir)
    ids = sorted(os.listdir(out_dir))
    assert len(ids) == 3
    names = os.listdir(os.path.join(out_dir, ids[0]))
    assert {"gt.npy", "init_pose.npy", "mesh_file_path.txt"} <= set(names)
    traj = np.load(os.path.join(out_dir, ids[0],
                                next(n for n in names if n.startswith("predict_"))))
    assert traj.shape[0] == cfg.verifier.max_iters * cfg.denoiser.num_inference_steps
    assert np.isfinite(traj).all()
    # the same seed serves the same results
    assert R.run_inference(cfg, engine=engine) == agg
