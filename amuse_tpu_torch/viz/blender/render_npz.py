"""Blender-side render script: SMPL-X animation npz -> mp4.

Runs INSIDE Blender's bundled Python, replacing the reference's whole
render-script family with ONE parameterized studio scene. Upstream ships
five near-duplicate 206-233-line scripts that differ only in camera,
material, and set placement (models/diffusion/viz/render_smpl.py,
render_smpl_half.py, render_smpl_show.py, render_smpl_1.py,
render_smpl_blversion.py); here each variant is a PRESETS row:

  full  - full-body studio framing, skin material
          (render_smpl.py:38,111-115: camera (0,-4.7,-0.35), Burley
          subsurface skin, wall at y=1.5)
  half  - upper-body framing, metallic-blue material
          (render_smpl_half.py:39,120: camera (0,-2.5,0), wall at y=0.5)
  show  - half framing with the armature rotated -90deg about X and
          dropped to z=-0.71 to keep the pelvis in frame
          (render_smpl_show.py:105-106: rotation_euler=(-1.5708,0,0),
          location[2]=-0.71; the floor stays at the per-gender height)
  plain - the minimal sun-lit scene this script shipped before the studio
          set existed (no floor/wall/rig; fastest; not an upstream scene)

Usage (matching amuse_tpu_torch.viz.export.render_with_blender):

    blender -b -P render_npz.py -- <npz> <out.mp4> <fps> \
        [EEVEE|CYCLES] [full|half|show|plain] [res] [samples]

Requires the SMPL-X Blender add-on (smplx_blender_addon) which provides
``object.smplx_add_animation`` importing our npz (keys: poses (T,55,3),
trans, gender, betas, mocap_frame_rate; written by
amuse_tpu_torch.viz.export.write_smplx_npz). Gender-dependent floor heights come
from the npz's own ``gender`` key instead of upstream's hard-coded actor
name lists (render_smpl.py:13-18) - the npz already knows.

Host-side post-processing; nothing here runs on the GPU.
"""

import sys

# Scene constants per preset. Values cite the upstream script they pin.
# armature_z is an absolute z ASSIGNMENT (or None to leave the import
# untouched) and arm_rot_x_deg the armature X rotation - upstream's show
# variant uses -90deg where the others use +90 (render_smpl_show.py:105 vs
# render_smpl.py:104), and sets location[2]=-0.71 while the floor stays at
# the per-gender height.
PRESETS = {
    # camera xyz, camera euler-x deg, wall y, body material, armature pose
    "full": {
        "cam": (0.0, -4.7, -0.35),  # render_smpl.py:38 (npz branch)
        "cam_rot_x_deg": 89.0,  # render_smpl.py:72
        "wall_y": 1.5,  # render_smpl.py:130
        "material": "skin",
        "arm_rot_x_deg": 90.0,  # render_smpl.py:104
        "armature_z": None,
    },
    "half": {
        "cam": (0.0, -2.5, 0.0),  # render_smpl_half.py:39
        "cam_rot_x_deg": 89.0,
        "wall_y": 0.5,  # render_smpl_half.py:135
        "material": "blue",  # render_smpl_half.py:120
        "arm_rot_x_deg": 90.0,
        "armature_z": None,
    },
    "show": {
        "cam": (0.0, -2.5, 0.0),
        "cam_rot_x_deg": 89.0,
        "wall_y": 0.5,
        "material": "blue",
        "arm_rot_x_deg": -90.0,  # render_smpl_show.py:105
        "armature_z": -0.71,  # render_smpl_show.py:106 (assignment)
    },
}

# Per-gender floor heights for the npz-animation path (render_smpl.py:40-44).
FLOOR_Z = {"male": -1.42961, "female": -1.13961, "neutral": -1.29}

# Principled-BSDF base color + Burley subsurface radius (render_smpl.py:111-115
# skin; render_smpl_half.py:120 metallic blue; floor/wall colors :126,:137).
MATERIALS = {
    "skin": {"base_color": (0.436, 0.227, 0.131, 1.0), "subsurface": 0.01,
             "radius": (3.67, 1.37, 0.68)},
    "blue": {"base_color": (0.238397, 0.55834, 0.701102, 1.0)},
    "floor": {"base_color": (0.730461, 0.47932, 0.242281, 1.0)},
    "wall": {"base_color": (1.0, 1.0, 0.887923, 1.0)},
}


def parse_argv(argv):
    """CLI args after ``--`` -> settings dict (importable + testable
    outside Blender; everything downstream of this needs bpy)."""
    out = {
        "npz": argv[0],
        "video": argv[1],
        "fps": float(argv[2]) if len(argv) > 2 else 30.0,
        "engine": (argv[3] if len(argv) > 3 else "BLENDER_EEVEE").upper(),
        "preset": (argv[4] if len(argv) > 4 else "full").lower(),
        "resolution": int(argv[5]) if len(argv) > 5 else 1024,  # render_smpl.py:63
        "samples": int(argv[6]) if len(argv) > 6 else 0,  # 0 -> engine default
    }
    if out["engine"] in ("EEVEE", "BLENDER_EEVEE"):
        out["engine"] = "BLENDER_EEVEE"
    elif out["engine"] != "CYCLES":
        raise ValueError(f"unknown engine {out['engine']!r}")
    if out["preset"] not in (*PRESETS, "plain"):
        raise ValueError(
            f"unknown preset {out['preset']!r}; valid: {[*PRESETS, 'plain']}"
        )
    return out


def _principled(mat_key):
    import bpy

    mat = bpy.data.materials.new(name=f"amuse_{mat_key}")
    mat.use_nodes = True
    node = mat.node_tree.nodes["Principled BSDF"]
    spec = MATERIALS[mat_key]
    node.inputs["Base Color"].default_value = spec["base_color"]
    if "subsurface" in spec:
        # Burley subsurface skin (render_smpl.py:110-115). Blender 4 renamed
        # the socket; address by name so both 3.x and 4.x work.
        node.subsurface_method = "BURLEY"
        for sock in ("Subsurface Weight", "Subsurface"):
            if sock in node.inputs:
                node.inputs[sock].default_value = spec["subsurface"]
                break
        if "Subsurface Radius" in node.inputs:
            node.inputs["Subsurface Radius"].default_value = spec["radius"]
    return mat


def _set_material(obj, mat):
    obj.data.materials.clear()
    obj.data.materials.append(mat)


def _add_plane(name, size, location, rotation=(0.0, 0.0, 0.0), mat_key="floor"):
    import bpy

    bpy.ops.mesh.primitive_plane_add(
        size=size, align="WORLD", location=location, rotation=rotation
    )
    plane = bpy.context.active_object
    plane.name = name
    _set_material(plane, _principled(mat_key))
    return plane


def _studio_lights():
    """The reference's three-point rig (render_smpl.py:77-95): spot key
    1200 W, area fill 40 W, disk headlight 20 W."""
    import bpy
    from math import radians

    bpy.ops.object.light_add(
        type="SPOT", radius=1, align="WORLD", location=(2.8, -3, 4.11),
        rotation=(radians(40), radians(30), radians(9)),
    )
    bpy.context.active_object.data.energy = 1200

    bpy.ops.object.light_add(
        type="AREA", align="WORLD", location=(-2, -3, 1.37),
        rotation=(radians(60), 0, radians(-33)),
    )
    bpy.context.active_object.data.energy = 40

    bpy.ops.object.light_add(type="AREA", align="WORLD", location=(0, 0, 1))
    head = bpy.context.active_object
    head.data.shape = "DISK"
    head.data.size = 0.5
    head.data.energy = 20


def build_scene(cfg):
    import bpy
    import numpy as np
    from math import radians

    bpy.ops.wm.read_factory_settings(use_empty=True)
    scene = bpy.context.scene
    scene.render.fps = int(cfg["fps"])
    scene.render.resolution_x = cfg["resolution"]
    scene.render.resolution_y = cfg["resolution"]
    scene.render.resolution_percentage = 100
    scene.render.image_settings.file_format = "FFMPEG"
    scene.render.ffmpeg.format = "MPEG4"
    scene.render.ffmpeg.codec = "H264"

    data = np.load(cfg["npz"], allow_pickle=True)
    n_frames = int(data["poses"].shape[0])
    gender = str(data["gender"]) if "gender" in data else "neutral"

    # engine (render_smpl.py:141-152; CYCLES GPU is CUDA-only upstream - here
    # it stays on whatever compute device Blender has, never a hard CUDA dep).
    # Blender 4.2 removed the BLENDER_EEVEE enum value (renamed
    # BLENDER_EEVEE_NEXT), so fall back on assignment failure.
    try:
        scene.render.engine = cfg["engine"]
    except TypeError:
        if cfg["engine"] != "BLENDER_EEVEE":
            raise
        scene.render.engine = "BLENDER_EEVEE_NEXT"
    if cfg["engine"] == "CYCLES":
        scene.cycles.samples = cfg["samples"] or 256
        scene.cycles.subsurface_samples = cfg["samples"] or 256
    elif cfg["samples"]:
        scene.eevee.taa_render_samples = cfg["samples"]

    # camera
    preset = PRESETS.get(cfg["preset"])
    bpy.ops.object.camera_add(
        location=preset["cam"] if preset else (0.0, -3.2, 1.1)
    )
    cam = bpy.context.active_object
    cam.rotation_euler = (
        radians(preset["cam_rot_x_deg"]) if preset else 1.45, 0.0, 0.0
    )
    cam.data.type = "PERSP"
    cam.data.lens = 75  # render_smpl.py:74
    scene.camera = cam

    if preset:
        _studio_lights()
    else:  # plain: single sun
        bpy.ops.object.light_add(type="SUN", location=(1.5, -2.0, 3.0))
        bpy.context.active_object.data.energy = 3.0

    # animation import via the SMPL-X addon; the armature comes in Y-up and
    # needs the per-preset X rotation (+90 render_smpl.py:104; -90 for show,
    # render_smpl_show.py:105)
    before = set(bpy.data.objects)
    bpy.ops.object.smplx_add_animation(
        filepath=cfg["npz"], target_framerate=int(cfg["fps"])
    )
    new = [o for o in bpy.data.objects if o not in before]
    armature = next((o for o in new if o.type == "ARMATURE"), None)
    body = next((o for o in new if o.type == "MESH"), None)
    if armature is not None:
        rot_x = preset["arm_rot_x_deg"] if preset else 90.0
        armature.rotation_euler = (radians(rot_x), 0.0, 0.0)
        if preset and preset["armature_z"] is not None:
            armature.location[2] = preset["armature_z"]
    if preset and body is not None:
        _set_material(body, _principled(preset["material"]))

    if preset:
        # the floor stays at the per-gender height in every upstream
        # variant, including show (render_smpl_show.py:124 uses
        # floor_location untouched by the armature shift)
        floor_z = FLOOR_Z.get(gender, FLOOR_Z["neutral"])
        _add_plane("Floor", 5, (0, 0, floor_z), mat_key="floor")
        _add_plane(
            "Wall", 5, (0, preset["wall_y"], 0),
            rotation=(radians(90), 0, 0), mat_key="wall",
        )

    scene.frame_start, scene.frame_end = 1, n_frames
    scene.render.filepath = cfg["video"]
    return scene


def main():
    import bpy

    argv = sys.argv[sys.argv.index("--") + 1 :]
    cfg = parse_argv(argv)
    build_scene(cfg)
    bpy.ops.render.render(animation=True)


if __name__ == "__main__":
    main()
