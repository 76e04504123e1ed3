"""Runs INSIDE Blender's Python (blender -b -P setup_addons.py -- <action> ...).

Actions (args after ``--``):
  install <zip> [<zip> ...]   install addon zips into the user addons dir
  enable <module> [...]       enable addon modules + save user preferences
  probe                       print a BLPROBE: JSON line with version,
                              available addon modules, and enabled addons

The host-side orchestration (archive discovery, tar.xz->zip conversion,
verification, error text) lives in amuse_tpu_torch/viz/blender_setup.py - this
file stays bpy-only so it needs nothing from the repo.
Reference analog: enableaddon.py + visualizer.py:398-583 (load_in_blender).
"""

import json
import sys

import addon_utils
import bpy


def main() -> None:
    argv = sys.argv[sys.argv.index("--") + 1 :] if "--" in sys.argv else []
    if not argv:
        raise SystemExit("usage: ... -- {install|enable|probe} [args]")
    action, args = argv[0], argv[1:]

    if action == "install":
        for z in args:
            bpy.ops.preferences.addon_install(filepath=z, overwrite=True)
            print(f"BLSETUP: installed {z}")
        bpy.ops.wm.save_userpref()
    elif action == "enable":
        failed = []
        for mod in args:
            try:
                bpy.ops.preferences.addon_enable(module=mod)
                print(f"BLSETUP: enabled {mod}")
            except Exception as e:  # noqa: BLE001 - report, do not abort batch
                failed.append(mod)
                print(f"BLSETUP: enable FAILED {mod}: {e}")
        bpy.ops.wm.save_userpref()
        if failed:
            raise SystemExit(1)
    elif action == "probe":
        info = {
            "version": bpy.app.version_string,
            "modules": sorted(m.__name__ for m in addon_utils.modules()),
            "enabled": sorted(a.module for a in bpy.context.preferences.addons),
        }
        print("BLPROBE:" + json.dumps(info))
    else:
        raise SystemExit(f"unknown action {action}")


main()
