"""The port's native host core (``utils/native.py`` over its own ``csrc/pfpp_native.cpp``).

Mirrors ``tests/test_native.py`` on the port's module, then holds the port against the JAX
package: each function equal to the JAX package's native call (exact: the same C++ source,
compiled with the same flags on the same host), and the port's datasets bit-equal to the JAX
package's when both run their native libraries. The library is built into the port's
``csrc/build/``, never into ``native/build/``."""

import os

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as R

from puzzlefusion_plusplus_tpu.data import datasets as jds
from puzzlefusion_plusplus_tpu.utils import native as jnative
from puzzlefusion_plusplus_tpu_torch.data import datasets as tds
from puzzlefusion_plusplus_tpu_torch.data import generate_dataset
from puzzlefusion_plusplus_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_native_builds_in_the_port_tree():
    assert native.available(), f"native core failed to build: {native.build_error}"
    assert native.route() == "native"
    assert native.LIB_PATH == os.path.join(REPO, "puzzlefusion_plusplus_tpu_torch", "csrc",
                                           "build", "libpfpp_native.so")
    assert os.path.exists(native.LIB_PATH)


def test_nn_distance_parity():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 257, 3)).astype(np.float32)
    y = rng.normal(size=(3, 119, 3)).astype(np.float32)
    d, i = native.nn_distance_cpu(x, y)
    dref = np.sum((x[:, :, None, :] - y[:, None, :, :]) ** 2, axis=-1)
    np.testing.assert_allclose(d, dref.min(-1), atol=1e-4)
    np.testing.assert_array_equal(i, dref.argmin(-1))
    jd, ji = jnative.nn_distance_cpu(x, y)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(i, ji)


def test_fps_parity_with_the_port_and_jax():
    from puzzlefusion_plusplus_tpu_torch.ops.fps import farthest_point_sample_plain
    import torch

    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 300, 3)).astype(np.float32)
    mask = rng.random((2, 300)) > 0.25
    f = native.fps_cpu(x, 48, mask)
    ref = farthest_point_sample_plain(torch.from_numpy(x), 48, torch.from_numpy(mask))
    np.testing.assert_array_equal(f, ref.numpy())
    np.testing.assert_array_equal(f, jnative.fps_cpu(x, 48, mask))


def test_augment_parity():
    rng = np.random.default_rng(2)
    pcs = rng.normal(size=(5, 200, 3)).astype(np.float32)
    rots = R.random(5, random_state=rng).as_matrix().astype(np.float32)
    out, c, s = native.augment_parts_cpu(pcs, rots, normalize=True)
    ref_c = pcs.mean(1)
    ref = np.einsum("pij,pnj->pni", rots, pcs - ref_c[:, None])
    ref_s = np.abs(ref).reshape(5, -1).max(-1)
    np.testing.assert_allclose(c, ref_c, atol=1e-5)
    np.testing.assert_allclose(s, ref_s, atol=1e-5)
    np.testing.assert_allclose(out, ref / ref_s[:, None, None], atol=1e-5)
    for a, b in zip((out, c, s), jnative.augment_parts_cpu(pcs, rots, normalize=True)):
        np.testing.assert_array_equal(a, b)


def test_numpy_fallback_has_the_same_semantics(monkeypatch):
    """Without a library every function falls back to numpy, within float error."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 120, 3)).astype(np.float32)
    y = rng.normal(size=(2, 80, 3)).astype(np.float32)
    rots = R.random(2, random_state=rng).as_matrix().astype(np.float32)
    nat = (native.nn_distance_cpu(x, y), native.fps_cpu(x, 16),
           native.augment_parts_cpu(x, rots))
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.route() == "numpy"
    (d, i), f, aug = (native.nn_distance_cpu(x, y), native.fps_cpu(x, 16),
                      native.augment_parts_cpu(x, rots))
    np.testing.assert_allclose(d, nat[0][0], atol=1e-5)
    np.testing.assert_array_equal(i, nat[0][1])
    np.testing.assert_array_equal(f, nat[1])
    for a, b in zip(aug, nat[2]):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_dataset_uses_native_with_same_semantics(tmp_path):
    """The denoiser dataset's augmentation keeps the pose round trip: the emitted GT pose
    applied to the reference part's local cloud puts it back at the origin."""
    root = str(tmp_path)
    generate_dataset(root, num_shapes=1, seed=3, split="train", min_parts=3, max_parts=3,
                     with_matching=False, with_verifier=False)
    ds = tds.DenoiserDataset(root + "/pc_data/train", mode="train", multiple_ref_parts=False)
    it = ds.get(0, np.random.default_rng(0))
    P = int(it["num_parts"])
    ref = int(np.where(it["ref_part"][:P])[0][0])
    pc_ref = it["part_pcs"][ref] * it["part_scale"][ref]
    q = it["part_rots"][ref]
    posed = R.from_quat(q[[1, 2, 3, 0]]).apply(pc_ref) + it["part_trans"][ref]
    assert np.abs(posed.mean(0)).max() < 1e-4


@pytest.mark.parametrize("kind", ["vqvae", "denoiser_train", "denoiser_val"])
def test_datasets_bit_equal_to_jax_with_both_native(tmp_path, kind):
    assert native.available() and jnative.available()
    root = str(tmp_path)
    generate_dataset(root, num_shapes=3, seed=5, split="train", min_parts=3, max_parts=6,
                     with_matching=False, with_verifier=False)
    d = root + "/pc_data/train"
    if kind == "vqvae":
        t, j = tds.VQVAEDataset(d), jds.VQVAEDataset(d)
    else:
        mode = kind.split("_")[1]
        t, j = tds.DenoiserDataset(d, mode=mode), jds.DenoiserDataset(d, mode=mode)
    for i in range(len(t)):
        a, b = t.get(i, np.random.default_rng(i)), j.get(i, np.random.default_rng(i))
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == np.asarray(b[k]).dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
