"""The traffic: the same seed gives the same requests, another seed other ones of the same
sizes."""

from __future__ import annotations

import numpy as np

from pfpp_bench import manifest
from pfpp_bench.traffic import shapes

TRAFFIC = {"part_counts": [2, 3, 5, 2], "batch": 2, "sort_by_parts": True,
           "bucket_multiple": 4, "area_pad": 5120}


def batches(seed):
    recs = shapes.make_shapes(TRAFFIC, seed, 128, 1).get()
    return shapes.engine_batches(TRAFFIC, recs, seed, 20)


def test_same_seed_same_requests():
    a, b = batches(2**31 + 5), batches(2**31 + 5)
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_other_seed_other_requests_same_sizes():
    a, b = batches(11), batches(12)
    assert [x["part_valids"].shape for x in a] == [x["part_valids"].shape for x in b]
    assert sorted(np.concatenate([x["num_parts"] for x in a]).tolist()) == sorted(
        np.concatenate([x["num_parts"] for x in b]).tolist())
    assert not np.array_equal(a[0]["part_pcs"], b[0]["part_pcs"])


def test_every_seed_asks_for_the_same_part_counts():
    w = manifest.workload("engine_b8")["traffic"]
    for seed in (1, 2, 3):
        assert sorted(shapes.part_counts(w, seed)) == sorted(shapes.multiset(w))
    assert list(shapes.part_counts(w, 1)) != list(shapes.part_counts(w, 2))


def test_part_draw_takes_the_generators_uniform_draw_at_its_quantiles():
    for low, high, n in ((2, 20, 32), (2, 20, 256), (2, 20, 1024), (2, 4, 4), (3, 3, 5)):
        counts = shapes.multiset({"part_draw": {"low": low, "high": high, "shapes": n}})
        freq = np.bincount(counts - low, minlength=high - low + 1)
        assert len(counts) == n and counts.min() >= low and counts.max() <= high
        assert freq.max() - freq.min() <= 1  # each value as often as the draw gives it
        assert abs(counts.mean() - (low + high) / 2) <= (high - low) / (2 * n) + 1e-9
    assert sorted(shapes.multiset({"part_counts": [5, 2], "repeats": 2})) == [2, 2, 5, 5]


def test_train_set_files(tmp_path):
    paths = shapes.write_train_set({"part_counts": [2, 4], "repeats": 2}, 9, 128,
                                   str(tmp_path), 1).get()
    assert len(paths) == 4
    counts = sorted(int(np.load(p)["num_parts"]) for p in paths)
    assert counts == [2, 2, 4, 4]
