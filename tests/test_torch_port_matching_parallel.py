"""The matcher on the port's mesh (``parallel/``), on the CPU: gloo, world size 2.

One matcher step at world size 2 on a global batch of 2 shapes is held to the one-process
step on the same batch (``training/parity.py::dp_steps``), and the training entry runs at
``num_devices=2``.

Tolerances: ``training/parity.py::MATCHING_SMALL`` (the one-device parity tolerances of the
small matcher's step, see ``tests/test_torch_port_matching_training.py``: its losses 2e-3
relative, where the two sides read up to 3e-5 apart; ``chip_smoke.py``'s dp phase holds the
full-width step to ``MATCHING``); BatchNorm's running statistics bit-equal on the two
ranks. Each spawned group is bounded by ``join_timeout_s``.
"""

import functools
import json
import os

import numpy as np
import torch

from puzzlefusion_plusplus_tpu_torch.data import Loader, generate_dataset
from puzzlefusion_plusplus_tpu_torch.matching import train as ttrain
from puzzlefusion_plusplus_tpu_torch.matching.dataset import AllPieceMatchingDataset
from puzzlefusion_plusplus_tpu_torch.training import parity

torch.set_num_threads(2)
JOIN_S = 120
SMALL = dict(pc_feat_dim=32, aff_feat_dim=16, sa_npoints=(32, 16, 8, 4), max_num_part=5)


def test_matching_step_at_world_2_equals_one_process_step(tmp_path):
    generate_dataset(str(tmp_path), num_shapes=2, seed=4, split="val", min_parts=3,
                     max_parts=5, n_points=96, with_matching=False, with_verifier=False)
    ds = AllPieceMatchingDataset(str(tmp_path / "pc_data" / "val"), num_points=160,
                                 max_num_part=5)
    batch = next(iter(Loader(ds, 2, shuffle=False)))
    make = functools.partial(ttrain.make_model, **SMALL)
    with torch.random.fork_rng():
        torch.manual_seed(0)
        sd = make().state_dict()
    cases = {"matching": dict(kind="matching", make_model=make, state_dict=sd, batch=batch)}
    one = parity.dp_steps(cases, 1, "cpu")["matching"]
    two = parity.dp_steps(cases, 2, "cpu", join_timeout_s=JOIN_S)["matching"]
    errs = parity.compare(one, two, ttrain.METRIC_KEYS, parity.MATCHING_SMALL)
    print(errs)
    # the ranks hold shapes of other part and critical counts: the step is the global one
    assert batch["num_parts"][0] != batch["num_parts"][1]
    halves = [parity.dp_steps({"m": {**cases["matching"],
                                     "batch": {k: v[i:i + 1] for k, v in batch.items()}}},
                              1, "cpu")["m"]["metrics"]["mat_loss"] for i in (0, 1)]
    assert abs(np.mean(halves) - two["metrics"]["mat_loss"]) > 1e-3 * two["metrics"]["mat_loss"]
    ranks = two["rank_buffers"]
    assert len(ranks) == 2
    for n in ranks[0]:
        assert torch.equal(ranks[0][n], ranks[1][n]), n


def test_train_matching_entry_on_two_processes(tmp_path):
    generate_dataset(str(tmp_path), num_shapes=2, seed=5, split="val", min_parts=3,
                     max_parts=4, n_points=96, with_matching=False, with_verifier=False)
    out = str(tmp_path / "out")
    state = ttrain.train_matching(
        str(tmp_path / "pc_data" / "val"), out_dir=out, epochs=1, batch_size=2,
        num_points=160, mat_epoch=0, rig_epoch=0, model=ttrain.make_model(**SMALL),
        max_num_part=5, max_steps=1, num_devices=2, log_every=1, device="cpu",
        join_timeout_s=JOIN_S)
    assert state.step == 1
    assert os.path.isdir(os.path.join(out, "ckpt", "step_1"))
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    assert len(recs) == 1 and all(np.isfinite(recs[0][k]) for k in ttrain.METRIC_KEYS)
