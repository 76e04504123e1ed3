"""Facial shape-key baking inside Blender (blender -b <blend> -P bake_face.py -- ...).

The reference ships a custom "FaceBaker" addon
(models/diffusion/viz/addons/facebaker.py) with two operations it uses from
the render pipeline: keyframing per-frame blendshape weights onto a face
mesh's shape keys, and dumping each shape key as an OBJ for external
retargeting. This is an original, headless re-implementation of those two
operations (no UI panel - the rebuild drives Blender in batch mode only).

Actions (args after ``--``):
  bake <mesh_name> <weights.(json|npz)> [fps]
      weights.json: {"names": [...], "frames": [[w, ...], ...]}  - or -
      weights.npz:  ``expressions`` (T, E) keyed onto the mesh's first E
      shape keys (the SMPL-X addon names them Exp000..; an npz written by
      amuse_tpu_torch.viz.export with an ``expressions`` field works directly).
      Existing shape-key animation is cleared first, as the reference does.
  dump <mesh_name> <out_dir>
      export each shape key (exclusive value=1.0) as <idx>_<name>.obj
"""

import json
import sys
from pathlib import Path

import bpy


def _mesh(name: str):
    obj = bpy.data.objects.get(name)
    if obj is None or obj.type != "MESH":
        raise SystemExit(f"bake_face: no mesh object named {name!r}")
    if obj.data.shape_keys is None or len(obj.data.shape_keys.key_blocks) < 2:
        raise SystemExit(f"bake_face: mesh {name!r} has no shape keys")
    return obj


def _clear_animation(shape_keys) -> None:
    ad = shape_keys.animation_data
    if ad is not None and ad.action is not None:
        shape_keys.animation_data_clear()


def bake(mesh_name: str, weights_path: str, fps: float = 30.0) -> None:
    obj = _mesh(mesh_name)
    blocks = obj.data.shape_keys.key_blocks[1:]  # [0] is Basis
    p = Path(weights_path)
    if p.suffix == ".json":
        d = json.loads(p.read_text())
        names, frames = d["names"], d["frames"]
        index = {b.name: b for b in blocks}
        # Pair each shape key with its OWN column index so a missing name
        # skips only that column (a filtered zip would shift every later
        # weight onto the wrong key).
        pairs = [(index[n], col) for col, n in enumerate(names) if n in index]
        missing = [n for n in names if n not in index]
        if missing:
            print(f"bake_face: {len(missing)} weight names not on mesh: {missing[:5]}")
    else:
        import numpy as np

        frames = np.load(p)["expressions"]
        pairs = list(zip(blocks[: frames.shape[1]], range(frames.shape[1])))
    _clear_animation(obj.data.shape_keys)
    for f_idx, row in enumerate(frames):
        frame = f_idx + 1
        for block, col in pairs:
            block.value = float(row[col])
            block.keyframe_insert("value", frame=frame)
    bpy.context.scene.render.fps = int(round(fps))
    bpy.context.scene.frame_end = max(bpy.context.scene.frame_end, len(frames))
    print(f"bake_face: keyed {len(pairs)} shape keys over {len(frames)} frames")


def dump(mesh_name: str, out_dir: str) -> None:
    obj = _mesh(mesh_name)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    blocks = obj.data.shape_keys.key_blocks[1:]
    bpy.ops.object.select_all(action="DESELECT")
    obj.select_set(True)
    bpy.context.view_layer.objects.active = obj
    for i, block in enumerate(blocks):
        for b in blocks:
            b.value = 0.0
        block.value = 1.0
        path = out / f"{i:04d}_{block.name}.obj"
        bpy.ops.wm.obj_export(filepath=str(path), export_selected_objects=True)
    print(f"bake_face: dumped {len(blocks)} shape keys -> {out}")


def main() -> None:
    argv = sys.argv[sys.argv.index("--") + 1 :] if "--" in sys.argv else []
    if not argv:
        raise SystemExit(__doc__)
    if argv[0] == "bake":
        bake(argv[1], argv[2], float(argv[3]) if len(argv) > 3 else 30.0)
    elif argv[0] == "dump":
        dump(argv[1], argv[2])
    else:
        raise SystemExit(f"unknown action {argv[0]}")


main()
