"""A cell on several cards: one process per card, started by this one.

The launcher builds the port's kernel library once (so that the ranks do
not all compile it), starts `chips` ranks of the same command with
`--rank r` and the process-group variables (`COORDINATOR_ADDRESS` on a
free local TCP port, `NUM_PROCESSES`, `PROCESS_ID`), waits for every one
of them, and prints rank 0's standard error and then its result line when
every rank exited with 0. Otherwise it prints what the ranks wrote and no
result."""

from __future__ import annotations

import os
import subprocess
import sys

from slambench.harness import env, guard

# a rank that has not ended by then is stopped (a run's whole limit is 360 s)
RANK_TIMEOUT_S = 345


def launch(argv, cell, root: str, t0: float) -> int:
    why = env.card_check(cell.chips)
    if why is not None:
        print(f"slambench: {why}; no result", file=sys.stderr)
        return 2
    from parakeet_slam_tpu_torch.dist.multihost import free_local_port
    from parakeet_slam_tpu_torch.kernels import _build

    _build.library()
    port = free_local_port()
    procs = []
    for r in range(cell.chips):
        e = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                 NUM_PROCESSES=str(cell.chips), PROCESS_ID=str(r), SLAMBENCH_T0=repr(t0))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(root, "slambench", "run.py"), *argv, "--rank", str(r)],
            cwd=root, env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs, codes = [], []
    for pr in procs:
        try:
            out, err = pr.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = pr.communicate()
        outs.append((out, err))
        codes.append(pr.returncode)
    for q in procs:  # every rank has ended before the launcher goes on
        q.wait()
    if any(c != 0 for c in codes):
        for r, ((out, err), c) in enumerate(zip(outs, codes)):
            print(f"slambench: rank {r} exited with {c}\n{err[-3000:]}{out[-1000:]}",
                  file=sys.stderr)
        return 1
    bad = guard.forbidden_loaded()
    if bad:
        print(f"slambench: the launcher holds {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    out, err = outs[0]
    sys.stderr.write(err)
    sys.stderr.flush()
    sys.stdout.write(out)
    sys.stdout.flush()
    return 0
