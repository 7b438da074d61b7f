"""The port's shared training loop (``training/loop.py``) on the CPU, with a toy state and a
fake step: ``max_steps`` inside an epoch, resume at ``state.step // steps_per_epoch``, the
validation cadence and the last epoch, ``validate`` returning None, and the order of the log
records. Each trainer's own tests run the loop through that trainer."""

import json
import os

import pytest
import torch

from puzzlefusion_plusplus_tpu_torch.training import loop
from puzzlefusion_plusplus_tpu_torch.training.state import adamw_reference

TOPK = dict(monitor="val_m", mode="max", top_k=10)


def _state():
    torch.manual_seed(0)
    return adamw_reference(torch.nn.Linear(2, 1), 1e-2)


def _loader(n: int) -> list[dict]:
    return [{"x": torch.full((3, 2), float(i))} for i in range(n)]


def _step_fn(state, seen: list):
    """A fake step: one update of ``state`` on the batch; records (epoch, step before)."""
    def step_fn(epoch, batch):
        seen.append((epoch, state.step))
        state.optimizer.zero_grad(set_to_none=True)
        loss = state.model(batch["x"]).pow(2).mean()
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return {"loss": loss.detach()}
    return step_fn


def _validate(state, calls: list, value=True):
    def validate():
        calls.append(state.step)
        return ({"val_m": float(state.step)}, float(state.step)) if value else None
    return validate


def _records(out_dir) -> list[dict]:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _steps_on_disk(out_dir) -> list[str]:
    return sorted(d for d in os.listdir(os.path.join(out_dir, "ckpt")) if d.startswith("step_"))


def test_max_steps_inside_an_epoch_checkpoints_once_and_returns(tmp_path):
    out, state, seen, calls = str(tmp_path), _state(), [], []
    got = loop.fit(state, out, _loader(4), 3, _step_fn(state, seen), _validate(state, calls),
                   TOPK, every=1, log_every=1, max_steps=2)
    assert got is state and state.step == 2
    assert seen == [(0, 0), (0, 1)] and calls == []
    assert _steps_on_disk(out) == ["step_2"]
    assert not os.path.exists(os.path.join(out, "ckpt", "topk.json"))
    assert [r["step"] for r in _records(out)] == [0, 1]


@pytest.mark.parametrize("stop", [3, 4])  # inside an epoch, at an epoch's end
def test_resume_starts_at_step_over_steps_per_epoch(tmp_path, stop):
    out, first = str(tmp_path), _state()
    loop.fit(first, out, _loader(2), 4, _step_fn(first, []), _validate(first, []), TOPK,
             every=10, log_every=1, max_steps=stop)
    state, seen = _state(), []
    loop.fit(state, out, _loader(2), 4, _step_fn(state, seen), _validate(state, []), TOPK,
             every=10, log_every=1)
    start = stop // 2  # an interrupted epoch runs again whole
    assert seen == [(e, stop + i) for i, e in enumerate(e for e in range(start, 4)
                                                       for _ in range(2))]
    assert state.step == stop + 2 * (4 - start)


def test_validation_cadence_and_the_last_epoch(tmp_path):
    out, state, calls = str(tmp_path), _state(), []
    loop.fit(state, out, _loader(2), 5, _step_fn(state, []), _validate(state, calls), TOPK,
             every=2, log_every=100)
    assert calls == [4, 8, 10]  # after epochs 1 and 3, and after the last (4)
    vals = [(r["step"], r["epoch"], r["val_m"]) for r in _records(out) if "val_m" in r]
    assert vals == [(4, 1, 4.0), (8, 3, 8.0), (10, 4, 10.0)]
    with open(os.path.join(out, "ckpt", "topk.json")) as f:
        index = json.load(f)
    assert index["monitor"] == "val_m"
    assert sorted(index["entries"]) == ["step_10", "step_4", "step_8"]


def test_validate_none_writes_a_plain_checkpoint(tmp_path):
    out, state, calls = str(tmp_path), _state(), []
    loop.fit(state, out, _loader(2), 2, _step_fn(state, []),
             _validate(state, calls, value=False), TOPK, every=1, log_every=1)
    assert calls == [2, 4]
    assert _steps_on_disk(out) == ["step_2", "step_4"]
    assert not os.path.exists(os.path.join(out, "ckpt", "topk.json"))
    assert all("val_m" not in r for r in _records(out))


def test_log_records_in_order(tmp_path):
    out, state = str(tmp_path), _state()
    loop.fit(state, out, _loader(3), 2, _step_fn(state, []), _validate(state, []), TOPK,
             every=1, log_every=2)
    got = [(r["step"], r["epoch"], "val" if "val_m" in r else "train") for r in _records(out)]
    assert got == [(0, 0, "train"), (2, 0, "train"), (3, 0, "val"),
                   (4, 1, "train"), (6, 1, "val")]


def test_spawned_is_none_where_this_process_trains(tmp_path):
    def fresh():
        raise AssertionError("no ranks were spawned: nothing to restore")

    assert loop.spawned(str(tmp_path), fresh, print, (), 1, "cpu", 2, None) is None
