"""SMPL-X animation export and the optional Blender/ffmpeg subprocess bridge.

The port's copy of ``amuse_tpu/viz/export.py``. The product of the render
path is the SMPL-X npz written per 10 s window: keys ``poses`` (T, 55, 3),
``trans`` (T, 3), ``gender``, ``betas`` and ``mocap_frame_rate``, under
``<out_dir>/seq_<i>/<subject>_<stem>_seq<i>_smplx.npz``. Blender and ffmpeg
then turn each npz into an mp4 on the host, as subprocesses that run only
when their binaries are on PATH; nothing here touches the GPU.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np

from amuse_tpu_torch.data.actors import subject_to_gender_beta


def write_smplx_npz(
    path,
    poses: np.ndarray,  # (T, 55, 3) axis-angle
    trans: np.ndarray,  # (T, 3)
    subject: str = "",
    gender: str | None = None,
    betas: np.ndarray | None = None,
    fps: float = 30.0,
) -> Path:
    """Write the SMPL-X npz of one window."""
    if gender is None or betas is None:
        g, b = subject_to_gender_beta(subject)
        gender = gender or g
        betas = betas if betas is not None else b
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        path,
        poses=np.asarray(poses, np.float64),
        trans=np.asarray(trans, np.float64),
        gender=gender,
        betas=np.asarray(betas, np.float64),
        mocap_frame_rate=np.array(fps, dtype="float64"),
    )
    return path


def export_windows(out_dir, result: dict, subject: str = "", stem: str = "motion") -> list[Path]:
    """Export each generated 10 s window as seq_{i}/<subject>_<stem>_seq{i}_smplx.npz."""
    out_dir = Path(out_dir)
    return [
        write_smplx_npz(out_dir / f"seq_{i}" / f"{subject}_{stem}_seq{i}_smplx.npz",
                        poses, trans, subject=subject, fps=result.get("fps", 30.0))
        for i, (poses, trans) in enumerate(zip(result["poses"], result["trans"]))
    ]


def have_binary(name: str) -> bool:
    return shutil.which(name) is not None


def blender_argv(
    npz_path, out_video, render_script, fps: float = 30.0,
    engine: str = "BLENDER_EEVEE", preset: str = "full",
    resolution: int = 1024, samples: int = 0, blender_exe: str = "blender",
) -> list[str]:
    """The headless-Blender command line for one npz render, in the argument
    order of ``viz/blender/render_npz.py::parse_argv``; ``preset`` selects the
    studio scene variant."""
    return [
        blender_exe, "-b", "-P", str(render_script), "--",
        str(npz_path), str(out_video), str(fps), engine, preset,
        str(resolution), str(samples),
    ]


def render_with_blender(
    npz_path, out_video, blender_exe: str = "blender", render_script=None,
    fps: float = 30.0, engine: str = "BLENDER_EEVEE", preset: str = "full",
    resolution: int = 1024, samples: int = 0,
) -> bool:
    """Render an npz to mp4 in a Blender subprocess; False (nothing done)
    without Blender or a render script, or when the render fails."""
    if not have_binary(blender_exe) or render_script is None:
        return False
    rc = subprocess.run(
        blender_argv(npz_path, out_video, render_script, fps=fps,
                     engine=engine, preset=preset, resolution=resolution,
                     samples=samples, blender_exe=blender_exe),
        capture_output=True, text=True,
    )
    if rc.returncode != 0:
        # best effort: a missing addon must not abort the whole infer/edit
        # run (the npz files are the product)
        print(f"[viz] blender render failed on {npz_path}: {rc.stderr[-300:]}")
        return False
    return True


def mux_audio(video_in, audio_in, video_out, offset: float | None = None,
              duration: float | None = None) -> bool:
    """Mux an audio track into a video with ffmpeg; False without ffmpeg.

    ``offset``/``duration`` cut the audio slice of one 10 s window.
    """
    if not have_binary("ffmpeg"):
        return False
    cut = []
    if offset is not None:
        cut += ["-ss", str(offset)]
    if duration is not None:
        cut += ["-t", str(duration)]
    rc = subprocess.run(
        ["ffmpeg", "-y", "-i", str(video_in), *cut, "-i", str(audio_in),
         "-c:v", "copy", "-c:a", "aac", "-shortest", str(video_out)],
        capture_output=True, text=True,
    )
    if rc.returncode != 0:
        print(f"[viz] ffmpeg mux failed on {video_in}: {rc.stderr[-300:]}")
        return False
    return True


def xstack_layout(n: int, cols: int) -> str:
    """ffmpeg xstack layout string for n equal-size tiles in a cols-wide grid
    (e.g. n=4, cols=2 -> "0_0|w0_0|0_h0|w0_h0")."""
    return "|".join(
        f"{'+'.join(['w0'] * (i % cols)) or '0'}_{'+'.join(['h0'] * (i // cols)) or '0'}"
        for i in range(n)
    )


def concat_grid(videos, out_video, cols: int = 2) -> bool:
    """Composite result videos into one grid (one ffmpeg xstack call); False
    without ffmpeg or videos."""
    if not have_binary("ffmpeg") or not videos:
        return False
    n = len(videos)
    inputs = []
    for v in videos:
        inputs += ["-i", str(v)]
    filtergraph = f"xstack=inputs={n}:layout={xstack_layout(n, cols)}"
    rc = subprocess.run(
        ["ffmpeg", "-y", *inputs, "-filter_complex", filtergraph, str(out_video)],
        capture_output=True, text=True,
    )
    if rc.returncode != 0:
        print(f"[viz] ffmpeg grid failed: {rc.stderr[-300:]}")
        return False
    return True


DEFAULT_RENDER_SCRIPT = Path(__file__).parent / "blender" / "render_npz.py"


def render_windows(
    npz_paths,
    wav_path=None,
    window_seconds: float = 10.0,
    render_script=DEFAULT_RENDER_SCRIPT,
    fps: float = 30.0,
    engine: str = "BLENDER_EEVEE",
    preset: str = "full",
    resolution: int = 1024,
    samples: int = 0,
) -> list[Path]:
    """Render each seq_{i} npz to an mp4 beside it and, when a wav is given,
    mux in the matching ``window_seconds`` audio slice; -> the videos made.

    Returns [] without Blender. Best effort per window: a failed render skips
    that window only.
    """
    if not have_binary("blender"):
        return []

    def window_index(p: Path) -> int:
        """seq index from .../seq_{i}/...: a lexicographic sort would put
        seq_10 before seq_2 and mux the wrong 10 s of audio."""
        for part in reversed(p.parts):
            if part.startswith("seq_") and part[4:].isdigit():
                return int(part[4:])
        return 0

    videos = []
    paths = sorted((Path(p) for p in npz_paths), key=lambda p: (window_index(p), p))
    for npz in paths:
        i = window_index(npz)
        raw = npz.with_suffix(".mp4")
        if not render_with_blender(
            npz, raw, render_script=render_script, fps=fps, engine=engine,
            preset=preset, resolution=resolution, samples=samples,
        ):
            continue
        if wav_path is not None and mux_audio(
            raw, wav_path, npz.with_name(npz.stem + "_audio.mp4"),
            offset=i * window_seconds, duration=window_seconds,
        ):
            videos.append(npz.with_name(npz.stem + "_audio.mp4"))
        else:
            videos.append(raw)
    return videos
