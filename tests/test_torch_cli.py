"""The port's command line against the reference's: `eval` gives the
reference's ATE on the same two TUM trajectory files, and the entries that
are not ported yet (`run --ba`, `synth --sessions`) raise with a pointer to
their ROADMAP item instead of being refused by the parser."""

import argparse
import json

import numpy as np
import pytest
import torch

from parakeet_slam_tpu import cli as j_cli
from parakeet_slam_tpu_torch import cli


def _write_tum(path, xyz, rng):
    q = rng.normal(size=(len(xyz), 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.savetxt(path, np.concatenate([np.arange(len(xyz))[:, None] * 0.03, xyz, q], axis=1))


def test_eval_matches_the_reference(tmp_path, capsys):
    rng = np.random.default_rng(5)
    gt = np.cumsum(rng.normal(size=(60, 3)), axis=0)
    est = gt @ np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]]) + 2.0 + 0.1 * rng.normal(size=gt.shape)
    _write_tum(tmp_path / "est.txt", est[:55], rng)
    _write_tum(tmp_path / "gt.txt", gt, rng)
    args = ["--est", str(tmp_path / "est.txt"), "--gt", str(tmp_path / "gt.txt")]
    cli.main(["eval", *args, "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    j_cli.cmd_eval(argparse.Namespace(est=args[1], gt=args[3]))
    ref = json.loads(capsys.readouterr().out)
    assert got["frames"] == ref["frames"] == 55
    assert abs(got["ate_rmse_m"] - ref["ate_rmse_m"]) <= 2e-5, (got, ref)


def test_eval_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    """Without `--device cpu`, eval asks for the card and stops where there
    is none, as the other entries do."""
    rng = np.random.default_rng(6)
    xyz = np.cumsum(rng.normal(size=(8, 3)), axis=0)
    _write_tum(tmp_path / "t.txt", xyz, rng)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["eval", "--est", str(tmp_path / "t.txt"), "--gt", str(tmp_path / "t.txt")])


def test_run_ba_raises_with_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="run --ba.*Queue 1 item 2"):
        cli.main(["run", "--config", "configs/euroc_mh.yaml", "--ba", "5", "--device", "cpu"])


def test_synth_sessions_raises_with_its_roadmap_item(tmp_path):
    with pytest.raises(NotImplementedError, match="synth --sessions.*Queue 1 item 2"):
        cli.main(["synth", "--kind", "euroc", "--sessions", "2", "--out", str(tmp_path)])
