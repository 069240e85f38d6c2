"""CLI application mode (reference main.rs:14-32 flags + render loop)."""

import csv
import glob
import os

import numpy as np
import pytest

from bhr_tpu.app import build_parser, main


def test_parser_reference_flags():
    p = build_parser()
    args = p.parse_args(
        ["--perf-log", "mytag", "--duration", "2.5", "--debug-steps"]
    )
    assert args.perf_log == "mytag"
    assert args.duration == 2.5
    assert args.debug_steps is True
    assert args.integrator == "euler"  # default shader analog


def test_parser_rejects_unknown_integrator():
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--integrator", "rk6"])


def test_parser_accepts_leapfrog():
    assert build_parser().parse_args(["--integrator", "leapfrog"]).integrator == "leapfrog"


@pytest.mark.parametrize("flags, fast", [([], True), (["--no-fast-math"], False)])
def test_app_fast_math_reaches_the_kernel(flags, fast):
    """The app defaults to the kernel's approximate tier; --no-fast-math
    selects the exact one, like the library default."""
    from bhr_tpu import BlackHoleRenderer

    assert build_parser().parse_args(flags).fast_math is fast
    assert BlackHoleRenderer(16, 8, fast_math=fast).config.fast_math is fast
    assert BlackHoleRenderer(16, 8).config.fast_math is False


def test_app_renders_frames_and_logs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "frames")
    rc = main(
        [
            "--frames", "3",
            "--width", "32",
            "--height", "16",
            "--max-steps", "20",
            "--perf-log", "clitest",
            "--out", out,
            "--oracle",
        ]
    )
    assert rc == 0
    assert len(os.listdir(out)) == 3
    csvs = glob.glob(str(tmp_path / "measurements" / "perf_log_clitest_*.csv"))
    assert len(csvs) == 1
    with open(csvs[0]) as f:
        rows = list(csv.reader(f))
    assert len(rows) == 4  # header + 3 frames
    assert rows[0][0] == "elapsed_sec"


def test_app_debug_steps_mode(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "dbg")
    rc = main(
        [
            "--frames", "1",
            "--width", "32",
            "--height", "16",
            "--max-steps", "20",
            "--debug-steps",
            "--out", out,
            "--oracle",
        ]
    )
    assert rc == 0
    from PIL import Image

    frame = np.asarray(Image.open(os.path.join(out, "frame_00000.png")).convert("RGB"))
    assert (frame.max(axis=-1).astype(int) > 200).all()  # saturated heatmap


def test_app_duration_auto_exit(tmp_path, monkeypatch):
    """--duration N exits after ~N seconds (main.rs:836-848 analog)."""
    import time

    monkeypatch.chdir(tmp_path)
    t0 = time.perf_counter()
    rc = main(
        ["--duration", "1.0", "--width", "16", "--height", "8",
         "--max-steps", "5", "--oracle"]
    )
    assert rc == 0
    assert time.perf_counter() - t0 < 30.0  # exits promptly, not hangs


def test_app_chunked_loop_matches_frame_count(tmp_path, monkeypatch):
    """Default (fused-scan) mode writes exactly --frames PNGs and one CSV
    row per frame even when frames is not a chunk multiple."""
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "chunked")
    rc = main(
        [
            "--frames", "5",
            "--chunk", "4",
            "--width", "32",
            "--height", "16",
            "--max-steps", "10",
            "--perf-log", "chunktest",
            "--out", out,
            "--oracle",
        ]
    )
    assert rc == 0
    assert sorted(os.listdir(out)) == [f"frame_0000{i}.png" for i in range(5)]
    csvs = glob.glob(str(tmp_path / "measurements" / "perf_log_chunktest_*.csv"))
    with open(csvs[0]) as f:
        rows = list(csv.reader(f))
    assert len(rows) == 6  # header + 5 frames
    # every chunk bracket is attributed: frame_time > 0 past warmup... the
    # 10-frame warmup swallows these 5 frames, so just check schema
    assert rows[0] == [
        "elapsed_sec", "version", "fps", "frame_time_ms", "cpu_time_ms",
        "gpu_time_ms", "avg_fps", "min_fps", "max_fps", "std_dev_fps",
        "avg_cpu_time_ms", "avg_gpu_time_ms",
    ]


def test_app_per_frame_loop_still_works(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "legacy")
    rc = main(
        ["--frames", "2", "--chunk", "1", "--width", "32", "--height", "16",
         "--max-steps", "10", "--out", out, "--oracle"]
    )
    assert rc == 0
    assert len(os.listdir(out)) == 2


def test_app_skybox_flag(tmp_path, monkeypatch):
    """--skybox renders against a user texture through the app loop."""
    import numpy as np
    from PIL import Image

    monkeypatch.chdir(tmp_path)
    sky = (np.random.RandomState(5).rand(16, 32, 3) * 255).astype("uint8")
    sky_path = str(tmp_path / "sky.png")
    Image.fromarray(sky, "RGB").save(sky_path)
    out = str(tmp_path / "tex")
    rc = main(
        ["--frames", "1", "--width", "24", "--height", "16", "--max-steps", "10",
         "--skybox", sky_path, "--texture-filter", "bilinear", "--out", out,
         "--oracle"]
    )
    assert rc == 0
    assert os.path.exists(os.path.join(out, "frame_00000.png"))


def test_app_kerr_lt_gets_spin(tmp_path, monkeypatch):
    """Regression: --model kerr_lt must pass --spin through (it used to be
    zeroed, silently rendering Schwarzschild)."""
    import bhr_tpu.app as app_mod

    captured = {}
    orig = app_mod._chunked_loop

    def spy(args, renderer, scene, stats, logger, chunk):
        captured["spin"] = float(scene.spin)
        return 0

    monkeypatch.setattr(app_mod, "_chunked_loop", spy)
    monkeypatch.chdir(tmp_path)
    rc = main(["--frames", "1", "--width", "16", "--height", "8",
               "--max-steps", "4", "--model", "kerr_lt", "--spin", "0.7",
               "--oracle"])
    assert rc == 0
    assert captured["spin"] == pytest.approx(0.7)


def test_app_multires_flag(tmp_path, monkeypatch):
    """--multires N renders through the 1/N-res geodesic path in both loop
    modes and still writes frames."""
    monkeypatch.chdir(tmp_path)
    for chunk in ("2", "1"):
        out = str(tmp_path / f"mr{chunk}")
        rc = main(
            [
                "--frames", "2",
                "--width", "36",
                "--height", "24",
                "--max-steps", "20",
                "--multires", "2",
                "--chunk", chunk,
                "--out", out,
            ]
        )
        assert rc == 0
        assert len(os.listdir(out)) == 2
    with pytest.raises(SystemExit, match="multires"):
        main(["--frames", "1", "--multires", "2", "--debug-steps"])


def test_viewer_streams_mjpeg():
    """FrameStreamer serves an index page and MJPEG frames (the headless
    display-pass analog — reference main.rs:936-962)."""
    import urllib.request

    import numpy as np

    from bhr_tpu.io.viewer import FrameStreamer, read_one_frame

    s = FrameStreamer(0)  # ephemeral port
    try:
        frame = np.zeros((16, 32, 4), np.uint8)
        frame[4:12, 8:24] = [255, 128, 0, 255]
        s.submit(frame)
        idx = urllib.request.urlopen(
            f"http://127.0.0.1:{s.port}/", timeout=5
        ).read()
        assert b"/stream" in idx
        jpeg = read_one_frame("127.0.0.1", s.port)
        assert jpeg.startswith(b"\xff\xd8") and jpeg.endswith(b"\xff\xd9")
        # a second submit wakes waiting clients with a fresh frame
        s.submit(frame // 2)
    finally:
        s.close()


def test_app_serve_flag(monkeypatch, tmp_path):
    """--serve publishes every chunk's newest frame to the streamer
    (port 0 = ephemeral; the HTTP framing itself is covered by
    test_viewer_streams_mjpeg)."""
    from bhr_tpu.io import viewer as viewer_mod

    submitted = []
    orig_submit = viewer_mod.FrameStreamer.submit

    def spy_submit(self, frame):
        submitted.append(frame.shape)
        return orig_submit(self, frame)

    monkeypatch.setattr(viewer_mod.FrameStreamer, "submit", spy_submit)
    monkeypatch.chdir(tmp_path)
    rc = main(["--frames", "4", "--width", "32", "--height", "16",
               "--max-steps", "10", "--chunk", "2", "--serve", "0",
               "--oracle"])
    assert rc == 0
    assert len(submitted) == 2  # one publish per 2-frame chunk
    assert all(s == (16, 32, 4) for s in submitted)


def test_app_texture_subsample_and_tonemap(tmp_path, monkeypatch):
    """--texture-subsample and --tonemap flow into the renderer (checker
    halves the texture index count; reinhard engages the display slot)."""
    import numpy as np
    from PIL import Image

    monkeypatch.chdir(tmp_path)
    sky = np.zeros((8, 16, 4), np.float32)
    sky[..., :3] = 0.8
    sky[..., 3] = 1.0
    Image.fromarray((sky * 255).astype(np.uint8)).save("sky.png")
    out = str(tmp_path / "frames")
    rc = main(["--frames", "1", "--width", "32", "--height", "16",
               "--max-steps", "10", "--skybox", "sky.png",
               "--texture-filter", "nearest", "--texture-subsample",
               "checker", "--tonemap", "reinhard", "--out", out,
               "--oracle"])
    assert rc == 0
    frame = np.asarray(Image.open(os.path.join(out, "frame_00000.png")))
    # reinhard maps the 0.8 sky to ~0.8/1.8: escaped pixels must sit well
    # below the passthrough value
    escaped = frame[..., 0][frame[..., 0] > 0]
    assert escaped.size and escaped.max() <= 140  # 0.8/1.8*255 ~ 113 + lerp slack
