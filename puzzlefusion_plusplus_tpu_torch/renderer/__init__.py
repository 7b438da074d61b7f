from puzzlefusion_plusplus_tpu_torch.renderer.artifacts import (
    compose_render_transform,
    load_inference_dir,
    trajectory_world_points,
)
from puzzlefusion_plusplus_tpu_torch.renderer.pc_renderer import render_results, render_trajectory
from puzzlefusion_plusplus_tpu_torch.renderer.rasterizer import (
    render_mesh_trajectory,
    render_scene,
)

__all__ = [
    "compose_render_transform",
    "load_inference_dir",
    "trajectory_world_points",
    "render_results",
    "render_trajectory",
    "render_mesh_trajectory",
    "render_scene",
]
