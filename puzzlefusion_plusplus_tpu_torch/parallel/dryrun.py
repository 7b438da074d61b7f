"""One full training step on a ("data", "model") mesh of CPU processes (counterpart of the
JAX package's ``__graft_entry__.py::dryrun_multichip``).

``python -m puzzlefusion_plusplus_tpu_torch.parallel.dryrun N`` starts N gloo processes. For
an even N they form a ``(N/2, 2)`` mesh with axes ("data", "model")
(``torch.distributed.device_mesh.init_device_mesh``); for an odd N the mesh has only the data
axis. A tiny frozen encoder and denoiser take one step (encode, denoiser, MSE, backward,
AdamW) on a global batch of N shapes split over "data". The feed-forward projections of the
denoiser are sharded over "model" on their out-features (``ColwiseParallel`` with replicated
outputs), as the JAX dry run shards its FF kernel; the ranks of a "model" group hold the same
rows and draw the same dropout masks. It checks that the loss is finite and prints the mesh
and the FF weight's placement.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from puzzlefusion_plusplus_tpu_torch.parallel import launch, mesh

B_PARTS, N_POINTS, TOKENS, DIM = 4, 64, 5, 16


def _step() -> dict:
    """One rank of the dry run -> the loss of the global batch, the mesh and the FF weight's
    placement."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import ColwiseParallel, parallelize_module

    from puzzlefusion_plusplus_tpu_torch.inference.sampler import make_frozen_encoder
    from puzzlefusion_plusplus_tpu_torch.models.denoiser import DenoiserTransformer
    from puzzlefusion_plusplus_tpu_torch.models.scheduler import DDPMParams
    from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE
    from puzzlefusion_plusplus_tpu_torch.training.denoiser import draw_step_noise, loss_fn
    from puzzlefusion_plusplus_tpu_torch.training.state import adamw_reference

    n = dist.get_world_size()
    model_par = 2 if n % 2 == 0 else 1
    if model_par > 1:
        dm = init_device_mesh("cpu", (n // model_par, model_par),
                              mesh_dim_names=("data", "model"))
    else:
        dm = init_device_mesh("cpu", (n,), mesh_dim_names=("data",))
    data = dm["data"]
    data_group, data_rank, data_size = data.get_group(), data.get_local_rank(), data.size()

    torch.manual_seed(0)
    ae = VQVAE(n_embeddings=32, embedding_dim=4, num_point=TOKENS, num_dim=DIM,
               local_decode_pts=8, sa_npoints=(16, 8), sa_nsamples=(4, 8, 8))
    encoder = make_frozen_encoder(ae.eval())
    torch.manual_seed(1)
    model = DenoiserTransformer(embed_dim=32, num_layers=2, num_heads=2, num_dim=DIM,
                                max_parts=B_PARTS)
    if model_par > 1:
        plan = {}
        for i in range(len(model.transformer_layers)):
            for proj in ("ff.net.0.proj", "ff.net.2"):
                plan[f"transformer_layers.{i}.{proj}"] = ColwiseParallel(
                    output_layouts=Replicate())
        parallelize_module(model, dm["model"], plan)
    state = adamw_reference(model, 1e-4)
    ddpm = DDPMParams.piecewise(100)

    P = B_PARTS
    rng = np.random.default_rng(0)
    batch = {
        "part_trans": rng.normal(size=(n, P, 3)).astype(np.float32),
        "part_rots": rng.normal(size=(n, P, 4)).astype(np.float32),
        "part_pcs": rng.normal(size=(n, P, N_POINTS, 3)).astype(np.float32),
        "part_scale": np.ones((n, P, 1), np.float32),
        "part_valids": np.ones((n, P), np.float32),
        "ref_part": np.zeros((n, P), bool),
    }
    local = {k: torch.from_numpy(v)
             for k, v in mesh.shard_batch(batch, data_rank, data_size).items()}
    b = n // data_size
    t, noise = draw_step_noise(ddpm, (n, P, 7), torch.Generator().manual_seed(2))
    own = slice(data_rank * b, (data_rank + 1) * b)
    torch.manual_seed(3 + data_rank)  # a "model" group draws one dropout mask
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(state.model, encoder, ddpm, local, timesteps=t[own],
                            noise=noise[own], group=data_group)
    loss.backward()
    mesh.all_reduce_gradients(state.model, data_group)
    state.optimizer.step()
    state.step += 1
    loss = float(metrics["mse_loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    weight = model.transformer_layers[0].ff.net[0].proj.weight
    return {"loss": loss, "step": state.step,
            "mesh": dict(zip(dm.mesh_dim_names, dm.shape)),
            "batch_sharding": f"rows split over 'data' ({b} a rank)",
            "ff_weight_placement": str(getattr(weight, "placements", "replicated")),
            "ff_weight_local_shape": list(getattr(weight, "to_local", lambda: weight)().shape)}


def dryrun_multiprocess(n: int, join_timeout_s: float | None = None) -> dict:
    """Run the dry run on ``n`` CPU processes -> rank 0's summary (raises if a rank fails)."""
    return launch.run(_step, (), n, "cpu", join_timeout_s=join_timeout_s)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 8
    out = dryrun_multiprocess(n)
    print(f"dryrun({n}): OK, loss={out['loss']:.4f}, mesh={out['mesh']}, "
          f"batch sharding={out['batch_sharding']}, "
          f"ff weight placement={out['ff_weight_placement']} "
          f"(local {out['ff_weight_local_shape']})")


if __name__ == "__main__":
    main()
