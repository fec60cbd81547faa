"""CLI smoke tests on tiny on-disk fixtures (no datasets required)."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from cusift_tpu import cli


@pytest.fixture(autouse=True)
def _no_persistent_cache(monkeypatch):
    """The CLI turns on JAX's persistent compile cache for its process;
    inside the test worker that would outlive the test."""
    monkeypatch.setattr("cusift_tpu.utils.device.enable_compile_cache",
                        lambda: "")


@pytest.fixture()
def kitti_dir(tmp_path, rng):
    d = tmp_path / "sequences" / "00"
    (d / "image_0").mkdir(parents=True)
    for i in range(4):
        img = (rng.random((64, 96)) * 255).astype(np.uint8)
        cv2.imwrite(str(d / "image_0" / f"{i:06d}.png"), img)
    (d / "calib.txt").write_text(
        "P0: 80.0 0.0 48.0 0.0 0.0 80.0 32.0 0.0 0.0 0.0 1.0 0.0\n")
    poses = tmp_path / "poses"
    poses.mkdir()
    lines = []
    for i in range(4):
        lines.append(f"1 0 0 {0.1 * i} 0 1 0 0 0 0 1 0")
    (poses / "00.txt").write_text("\n".join(lines) + "\n")
    return str(d), str(poses / "00.txt")


def test_cli_odo_kitti_smoke(kitti_dir, tmp_path, capsys):
    """The KITTI odometry path runs end-to-end: loader -> MonoVO ->
    drift metrics -> trajectory file.  Featureless noise frames exercise
    the constant-velocity fallback rather than crashing."""
    seq_dir, pose_file = kitti_dir
    traj = str(tmp_path / "traj.txt")
    cli.main(["odo", "--kitti", seq_dir, "--poses", pose_file,
              "--max-kpts", "128", "--save-trajectory", traj])
    out = capsys.readouterr().out
    assert "pairs tracked" in out
    assert "ATE RMSE" in out
    rows = [l for l in open(traj) if l.strip()]
    assert len(rows) == 4 and len(rows[0].split()) == 8
