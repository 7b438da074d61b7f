"""A copy of ``puzzlefusion_plusplus_tpu/renderer/blender.py`` (numpy only), kept in the
port so that it imports nothing of the JAX package.

Blender mesh renderer (gated on ``bpy``; the reference renderer/myrenderer.py capability).

Scene parity with the reference (myrenderer.py:30-64): smooth shading, an invisible
shadow-catcher ground plane at z=-1, a sun light plus ambient world light, a camera with the
reference's default placement, and per-part plastic (Principled BSDF) materials colored from
the config palette (:144-150 setMat_plastic). Parts are keyframed along the saved pose
trajectory (:173-176) and frames are compiled into an .mp4 (:264-284 save_video) via the
shared encoder chain (artifacts.assemble_video — ffmpeg, OpenCV, or GIF fallback).

Requires a Blender-as-module python (``bpy``) on the host — not part of the TPU image, so
this module only defines the pipeline and raises a clear error otherwise. The pose math
(compose_render_transform) is shared with the headless renderer and covered by
tests/test_renderer.py; everything bpy-specific is exercised only where Blender exists.
"""

from __future__ import annotations

import os

import numpy as np

from puzzlefusion_plusplus_tpu_torch.renderer.artifacts import (
    assemble_video,
    compose_render_transform,
    load_inference_dir,
)

# reference part palette (config/auto_aggl.yaml renderer.colors), RGB 0-255
PART_COLORS = [
    (166, 86, 40), (80, 123, 167), (105, 170, 110), (190, 80, 77), (147, 120, 180),
    (120, 92, 71), (216, 138, 195), (128, 128, 128), (188, 188, 34), (23, 190, 207),
    (230, 153, 51), (77, 77, 179), (51, 153, 128), (204, 102, 102), (140, 166, 77),
    (89, 64, 140), (166, 128, 51), (64, 140, 166), (179, 77, 140), (115, 115, 64),
]

DEFAULT_CAMERA = dict(location=(2.0, -2.0, 1.5), look_at=(0.0, 0.0, 0.0), focal=45.0)
LOCATION_OFFSET = (-0.57, 0.0, 0.242)  # reference mesh placement (myrenderer.py:55,142)


def _require_bpy():
    try:
        import bpy  # noqa: F401

        return bpy
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "Blender rendering needs the bpy module (Blender-as-python). Use "
            "renderer.pc_renderer for the dependency-free point-cloud renderer."
        ) from e


def _setup_scene(bpy, resolution, samples=64, exposure=1.5):  # pragma: no cover - bpy
    """Reference scene init (myrenderer.py:30-64 via blendertoolbox): cycles renderer,
    shadow-catcher ground at z=-1, camera, sun + ambient light."""
    bpy.ops.wm.read_factory_settings(use_empty=True)
    scene = bpy.context.scene
    scene.render.engine = "CYCLES"
    scene.cycles.samples = samples
    scene.render.resolution_x, scene.render.resolution_y = resolution
    scene.render.film_transparent = True
    scene.view_settings.exposure = exposure

    # invisible ground / shadow catcher (bt.invisibleGround(location=(0,0,-1), 0.9))
    bpy.ops.mesh.primitive_plane_add(size=20.0, location=(0.0, 0.0, -1.0))
    ground = bpy.context.active_object
    ground.is_shadow_catcher = True

    # camera (bt.setCamera)
    cam_data = bpy.data.cameras.new("cam")
    cam_data.lens = DEFAULT_CAMERA["focal"]
    cam = bpy.data.objects.new("cam", cam_data)
    bpy.context.collection.objects.link(cam)
    cam.location = DEFAULT_CAMERA["location"]
    direction = np.asarray(DEFAULT_CAMERA["look_at"]) - np.asarray(cam.location)
    import mathutils

    cam.rotation_euler = (
        mathutils.Vector(direction).to_track_quat("-Z", "Y").to_euler()
    )
    scene.camera = cam

    # sun light (bt.setLight_sun(rotation, strength=2, shadow_soft_size=0.3))
    sun_data = bpy.data.lights.new("sun", type="SUN")
    sun_data.energy = 2.0
    sun_data.angle = 0.3
    sun = bpy.data.objects.new("sun", sun_data)
    bpy.context.collection.objects.link(sun)
    sun.rotation_euler = (np.radians(45.0), 0.0, np.radians(90.0))

    # ambient light (bt.setLight_ambient(color=(0.2, 0.2, 0.2, 1)))
    world = bpy.data.worlds.new("world")
    scene.world = world
    world.use_nodes = True
    bg = world.node_tree.nodes["Background"]
    bg.inputs["Color"].default_value = (0.2, 0.2, 0.2, 1.0)
    return scene, cam


def _set_plastic_material(bpy, obj, rgb):  # pragma: no cover - bpy
    """bt.setMat_plastic semantics: Principled BSDF, low roughness + specular highlight."""
    mat = bpy.data.materials.new(f"plastic_{obj.name}")
    mat.use_nodes = True
    bsdf = mat.node_tree.nodes["Principled BSDF"]
    bsdf.inputs["Base Color"].default_value = (*(c / 255.0 for c in rgb), 1.0)
    bsdf.inputs["Roughness"].default_value = 0.3
    if "Specular IOR Level" in bsdf.inputs:  # blender >= 4.0 naming
        bsdf.inputs["Specular IOR Level"].default_value = 0.5
    obj.data.materials.clear()
    obj.data.materials.append(mat)


def render_mesh_trajectory(
    sample_dir: str,
    mesh_root: str,
    out_dir: str,
    resolution: tuple[int, int] = (720, 720),
    every: int = 5,
    make_video: bool = True,
) -> list[str]:  # pragma: no cover - requires bpy
    """Load the part meshes named by mesh_file_path.txt, build the reference scene, animate
    the parts along the saved trajectory with keyframes, render PNG frames, assemble video."""
    bpy = _require_bpy()
    art = load_inference_dir(sample_dir)
    mesh_dir = os.path.join(mesh_root, art["mesh_file_path"])
    objs = sorted(f for f in os.listdir(mesh_dir) if f.endswith(".obj"))

    scene, _cam = _setup_scene(bpy, resolution)
    parts = []
    for i, f in enumerate(objs):
        bpy.ops.wm.obj_import(filepath=os.path.join(mesh_dir, f))
        obj = bpy.context.selected_objects[0]
        obj.location = LOCATION_OFFSET
        with bpy.context.temp_override(active_object=obj, selected_objects=[obj]):
            bpy.ops.object.shade_smooth()
        _set_plastic_material(bpy, obj, PART_COLORS[i % len(PART_COLORS)])
        obj.rotation_mode = "QUATERNION"
        parts.append(obj)

    os.makedirs(out_dir, exist_ok=True)
    written = []
    T = art["trajectory"].shape[0]
    steps = list(range(0, T, every)) + ([T - 1] if (T - 1) % every else [])
    offset = np.asarray(LOCATION_OFFSET)
    for fi, step in enumerate(steps):
        for p, obj in enumerate(parts):
            m = compose_render_transform(
                art["init_pose"], art["gt"][p], art["trajectory"][step, p]
            )
            import mathutils

            mat = mathutils.Matrix(np.asarray(m).tolist())
            obj.rotation_quaternion = mat.to_quaternion()
            obj.location = tuple(offset + np.asarray(mat.to_translation()))
            # keyframed animation (myrenderer.py:173-176)
            obj.keyframe_insert(data_path="location", frame=fi)
            obj.keyframe_insert(data_path="rotation_quaternion", frame=fi)
        scene.render.filepath = os.path.join(out_dir, f"{fi:04d}.png")
        bpy.ops.render.render(write_still=True)
        written.append(scene.render.filepath)

    if make_video:
        video = assemble_video(written, os.path.join(out_dir, "assembly.mp4"))
        if video is not None:
            written.append(video)
    return written
