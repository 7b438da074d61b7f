"""Matching-data generation entry, the port's counterpart of ``eval_matching.py``.

    python -m puzzlefusion_plusplus_tpu_torch.matching.eval data_dir=pc_data/everyday/val \
        ckpt=output/matching/ckpt/best out_dir=matching_data/everyday [--cpu]

``ckpt`` names a port checkpoint (``training/state.py::load_model_state``: a ``step_N`` dir,
a ckpt dir for its best, ``.../best``, ``.../latest``); a JAX orbax checkpoint is converted
first (``scripts/jax_ckpt_to_torch.py --kind matching``). ``oracle=1`` runs no model and
prints the matching-F1 ceiling of the data (``matching/oracle.py``). Keys: ``num_points``,
``max_num_part``, ``max_samples``, ``pc_feat_dim``, ``aff_feat_dim`` as in the JAX entry.
"""

from __future__ import annotations

import json
import sys


def main(argv=None) -> list | dict:
    argv = sys.argv[1:] if argv is None else argv
    args = dict(a.split("=", 1) for a in argv if "=" in a)
    max_samples = int(args["max_samples"]) if "max_samples" in args else None
    if int(args.get("oracle", 0)):
        from puzzlefusion_plusplus_tpu_torch.matching.oracle import oracle_matching_stats

        stats = oracle_matching_stats(args["data_dir"],
                                      num_points=int(args.get("num_points", 1000)),
                                      max_num_part=int(args.get("max_num_part", 20)),
                                      num_shapes=max_samples)
        print(json.dumps(stats))
        return stats
    from puzzlefusion_plusplus_tpu_torch.inference.run import resolve_device
    from puzzlefusion_plusplus_tpu_torch.matching.generate import generate_matching_data
    from puzzlefusion_plusplus_tpu_torch.matching.train import make_model
    from puzzlefusion_plusplus_tpu_torch.training.state import load_model_state

    device = resolve_device("cpu" if "--cpu" in argv else None)
    model = make_model(
        pc_feat_dim=int(args.get("pc_feat_dim", 128)),
        aff_feat_dim=int(args.get("aff_feat_dim", 512)),
    )
    model.load_state_dict(load_model_state(args["ckpt"]))
    results = generate_matching_data(
        model.to(device), args["data_dir"], args.get("out_dir", "matching_data/everyday"),
        num_points=int(args.get("num_points", 5000)),
        max_num_part=int(args.get("max_num_part", 20)), max_samples=max_samples,
        device=device)
    n_edges = sum(r["num_edges"] for r in results)
    print(f"{len(results)} shapes, {n_edges} total matching edges written")
    return results


if __name__ == "__main__":
    main()
