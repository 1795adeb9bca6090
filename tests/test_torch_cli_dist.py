"""`cli run` under a process group that it starts itself (from
COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID): 2 gloo ranks of
tests/torch_dist_worker.py's `cli_run` suite run the panoramic config, cut
to a CPU's size and sharded 2 x 1. Both ranks exit 0, rank 0 prints the
run's line, no rank warns that `destroy_process_group()` was not called,
and no group is left once `cmd_run` returns: the systems, which own the
captured programs, are collected before it destroys the group it made."""

import json
import subprocess

from tests import torch_dist_worker as W


def test_cli_run_leaves_no_process_group(tmp_path):
    procs = W.start("cli_run", tmp_path)
    try:
        outs = [p.communicate(timeout=W.TIMEOUT) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err[-3000:]}"
        assert "destroy_process_group" not in err, f"rank {r}:\n{err[-3000:]}"
        assert json.loads((tmp_path / f"cli_run_r{r}.json").read_text()) == {
            "group_left": False, "systems_alive": 0}
    assert outs[0][0].startswith("frames=6 keyframes=") and "end_drift=" in outs[0][0]
    assert outs[1][0] == ""
