"""Blender-side retarget script: BEAT BVH -> SMPL-X npz.

Runs INSIDE Blender (the reference's bvh2smplx_ workhorse role,
retarget_smpl2bvh2beatnpzWbetas.py):

    blender -b -P retarget_bvh.py -- <beat.bvh> <tpose_smplx.bvh> <out.npz> [preset.json] [subject]

Requires the Auto-Rig-Pro add-on (``bpy.ops.arp.retarget``) with a bone-map
preset for BEAT -> SMPL-X (supplied as a JSON path). This shim does ONLY the
bpy work - import, ARP retarget, BVH re-export to ``<out>.retargeted.bvh``.
The numpy Euler->axis-angle conversion runs back in the CALLING process
(cli/main.py): Blender's bundled Python has neither the repo on sys.path
nor torch installed, so importing amuse_tpu_torch here would always fail.
"""

import sys


def main():
    import bpy

    argv = sys.argv[sys.argv.index("--") + 1 :]
    beat_bvh, tpose_bvh, out_npz = argv[0], argv[1], argv[2]
    preset = argv[3] if len(argv) > 3 else ""
    subject = argv[4] if len(argv) > 4 else ""

    bpy.ops.wm.read_factory_settings(use_empty=True)
    # source: BEAT capture
    bpy.ops.import_anim.bvh(filepath=beat_bvh, rotate_mode="NATIVE")
    source = bpy.context.selected_objects[0]
    # target: SMPL-X T-pose rig
    bpy.ops.import_anim.bvh(filepath=tpose_bvh, rotate_mode="NATIVE")
    target = bpy.context.selected_objects[0]

    # Auto-Rig-Pro retarget with the BEAT->SMPL-X preset
    scn = bpy.context.scene
    scn.source_rig = source.name
    scn.target_rig = target.name
    if preset:
        bpy.ops.arp.import_config(filepath=preset)
    bpy.ops.arp.auto_scale()
    bpy.ops.arp.retarget()

    # export the retargeted rig back to BVH next to the npz; the calling
    # process converts it to the SMPL-X npz (numpy leg, no bpy required)
    retargeted_bvh = out_npz + ".retargeted.bvh"
    bpy.ops.object.select_all(action="DESELECT")
    target.select_set(True)
    bpy.context.view_layer.objects.active = target
    bpy.ops.export_anim.bvh(filepath=retargeted_bvh, root_transform_only=False)
    print(f"[retarget_bvh] exported {retargeted_bvh} (subject={subject})")


if __name__ == "__main__":
    main()
