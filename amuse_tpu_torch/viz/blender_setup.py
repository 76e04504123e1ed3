"""Blender addon bootstrap: bare Blender -> render/retarget-ready, one call.

The port's copy of ``amuse_tpu/viz/blender_setup.py``. The user drops the
addon archives (Stop-motion-OBJ, mhx2, retarget-bvh, Auto-Rig-Pro, SMPL-X;
several are licensed, and nothing is downloaded) into one directory,
``data.blender_addons_dir``; ``--fn blender_setup`` does the rest: tar.xz ->
installable zip, installation into the running Blender's user addons path,
enabling, preference save, and a verification probe, and prints what is
still missing and where to obtain it.

Every step reports instead of aborting: no Blender -> one actionable line;
missing archives -> per-addon guidance; an addon that fails to enable -> its
name and Blender's error. Host-side only: nothing here touches the GPU.
"""

from __future__ import annotations

import json
import subprocess
import tarfile
import tempfile
import zipfile
from dataclasses import dataclass, field
from pathlib import Path

from amuse_tpu_torch.viz.export import have_binary

SETUP_SCRIPT = Path(__file__).parent / "blender" / "setup_addons.py"

# archive-stem glob -> (addon module name blender sees, how to obtain)
KNOWN_ADDONS: dict[str, tuple[str, str]] = {
    "smplx_blender_addon*": (
        "smplx_blender_addon",
        "registered download at https://smpl-x.is.tue.mpg.de (SMPL-X for Blender)",
    ),
    "auto_rig_pro*": (
        "auto_rig_pro-master",
        "purchase at https://blendermarket.com/products/auto-rig-pro (paid; "
        "needed only for bvh2smplx_ retargeting)",
    ),
    "retarget_bvh*": (
        "retarget_bvh",
        "http://diffeomorphic.blogspot.com/p/bvh-retargeter.html (BVH Retargeter)",
    ),
    "import_runtime_mhx2*": (
        "import_runtime_mhx2",
        "MakeHuman eXchange (mhx2) importer - makehumancommunity.org",
    ),
    "Stop-motion-OBJ*": (
        "Stop-motion-OBJ",
        "https://github.com/neverhood311/Stop-motion-OBJ/releases (v2.1.1)",
    ),
}


@dataclass
class SetupReport:
    ok: bool
    blender: str = ""
    version: str = ""
    installed: list = field(default_factory=list)
    enabled: list = field(default_factory=list)
    missing: dict = field(default_factory=dict)  # module -> guidance
    errors: list = field(default_factory=list)

    def print(self) -> None:
        tag = "[blender_setup]"
        if not self.ok and not self.version:
            print(f"{tag} {self.errors[0] if self.errors else 'failed'}")
            return
        print(f"{tag} Blender {self.version}")
        for m in self.installed:
            print(f"{tag} installed: {m}")
        for m in self.enabled:
            print(f"{tag} enabled:   {m}")
        for mod, how in self.missing.items():
            print(f"{tag} MISSING:   {mod} -> {how}")
        for e in self.errors:
            print(f"{tag} ERROR:     {e}")
        state = "ready" if self.ok else ("usable for rendering" if
                                         "smplx_blender_addon" in self.enabled
                                         else "NOT ready")
        print(f"{tag} setup {state}")


def _run_blender(blender_exe: str, args: list[str]) -> subprocess.CompletedProcess:
    cmd = [blender_exe, "-b", "-P", str(SETUP_SCRIPT), "--", *args]
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired as e:  # a wedged Blender must become a
        # report line, not a traceback (module contract: report, don't abort)
        out = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
        return subprocess.CompletedProcess(
            cmd, returncode=124, stdout=out,
            stderr=f"blender timed out after {e.timeout:.0f}s running {args[0]}",
        )


def probe(blender_exe: str = "blender") -> dict | None:
    """-> {version, modules, enabled} or None when Blender is unusable."""
    if not have_binary(blender_exe):
        return None
    rc = _run_blender(blender_exe, ["probe"])
    for line in rc.stdout.splitlines():
        if line.startswith("BLPROBE:"):
            return json.loads(line[len("BLPROBE:"):])
    return None


def _as_installable_zip(archive: Path, tmp: Path) -> Path | None:
    """Blender's addon_install wants a .zip whose top level is the addon
    package; the reference ships several addons as .tar.xz - convert."""
    if archive.suffix == ".zip":
        return archive
    if archive.name.endswith((".tar.xz", ".tar.gz", ".tar")):
        out_dir = tmp / archive.name.split(".")[0]
        with tarfile.open(archive) as tf:
            try:
                tf.extractall(out_dir, filter="data")
            except TypeError:  # filter= needs >=3.10.12/3.11.4/3.12
                tf.extractall(out_dir)  # noqa: S202 - bundled addon archives
        roots = [p for p in out_dir.iterdir() if p.is_dir()]
        root = roots[0] if len(roots) == 1 else out_dir
        zpath = tmp / (root.name + ".zip")
        with zipfile.ZipFile(zpath, "w", zipfile.ZIP_DEFLATED) as zf:
            for f in sorted(root.rglob("*")):
                if f.is_file():
                    zf.write(f, root.name + "/" + str(f.relative_to(root)))
        return zpath
    return None


def setup(addons_dir, blender_exe: str = "blender") -> SetupReport:
    """Install + enable every known addon archive found under ``addons_dir``,
    then verify; report what remains missing and how to get it."""
    rep = SetupReport(ok=False, blender=blender_exe)
    if not have_binary(blender_exe):
        rep.errors.append(
            f"blender executable '{blender_exe}' not found on PATH - install "
            "Blender 3.4+ (apt/snap/blender.org) and re-run --fn blender_setup"
        )
        return rep
    info = probe(blender_exe)
    if info is None:
        rep.errors.append("blender probe failed (blender -b -P ... produced no BLPROBE line)")
        return rep
    rep.version = info["version"]

    addons_dir = Path(addons_dir) if addons_dir else None
    to_install: list[tuple[str, Path]] = []
    found_modules: set[str] = set()
    for pattern, (module, how) in KNOWN_ADDONS.items():
        if module in info["modules"]:
            found_modules.add(module)  # already installed
            continue
        hits = sorted(addons_dir.glob(pattern)) if addons_dir and addons_dir.is_dir() else []
        if hits:
            to_install.append((module, hits[-1]))
        else:
            rep.missing[module] = how

    with tempfile.TemporaryDirectory() as tmp:
        zips = []
        for module, archive in to_install:
            z = _as_installable_zip(archive, Path(tmp))
            if z is None:
                rep.errors.append(f"{archive.name}: not a zip/tar archive")
                rep.missing[module] = KNOWN_ADDONS_GUIDE(module)
                continue
            zips.append((module, z))
        if zips:
            rc = _run_blender(blender_exe, ["install", *(str(z) for _, z in zips)])
            if rc.returncode != 0:
                rep.errors.append(f"addon_install failed: {rc.stderr[-300:]}")
            else:
                rep.installed = [m for m, _ in zips]
                found_modules |= set(rep.installed)

        if found_modules:
            rc = _run_blender(blender_exe, ["enable", *sorted(found_modules)])
            if rc.returncode != 0:
                rep.errors.append(
                    "some addons failed to enable: "
                    + "; ".join(
                        ln for ln in rc.stdout.splitlines() if "FAILED" in ln
                    )[-400:]
                )

    after = probe(blender_exe) or {"enabled": []}
    wanted = {m for _, (m, _) in KNOWN_ADDONS.items()}
    rep.enabled = sorted(set(after["enabled"]) & wanted)
    rep.ok = not rep.missing and not rep.errors
    return rep


def KNOWN_ADDONS_GUIDE(module: str) -> str:
    for _, (m, how) in KNOWN_ADDONS.items():
        if m == module:
            return how
    return "unknown addon"
