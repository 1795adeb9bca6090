"""Joint bundle adjustment solved back to back (traffic kind `ba_solve`).

Set-up draws the problem from the seed on the card and solves it once (the
captured LM iteration's first solve: its first iteration eager, its second
captured). The window then solves the same problem from the same initial
poses and points until `--seconds` have passed, ending on a solve's
boundary; one solve packs the problem (`graph.make_ba_problem`, packed
into buckets inside `ba.optimize_ba`), runs `ba.optimize_ba` with the
configuration's backend settings, captured, and brings the poses, points
and costs back to the host. `ba_solve_s` is the window's time over the
solves it completed.

`--trace 1` profiles one whole solve in the middle of the window, and
turns the program's tracer and the card's clock sampler on over the window
(`harness/spans.py`).

Correct: every solve's final cost, and the poses and points of one solve
drawn from the seed, against the frozen reference's eager solve of the
same problem in float32 (`reference/ba.py`). A control run also solves the
reference in float32 with the problem's observations in a seed-drawn order
and prints that reordering's numbers beside the TF32 control's: same
precision, another order of summation, so it is printed and never held in
the program's place."""

from __future__ import annotations

import random
import statistics
import time

from slambench.harness import spans, spec
from slambench.harness.trace import Stretch
from slambench.reference import ba as ba_ref
from slambench.worlds import ba_problem


# how the reordering's note begins; its permutation is drawn from the run's
# seed XOR REORDER_SEED, so that it is not the problem's own draw
REORDERING = "reordering (the reference in float32, its observations in a seed-drawn order)"
REORDER_SEED = 0x0BDE


def solver_settings(cfg) -> dict:
    be = cfg.backend
    return dict(iters=be.gn_iters, lam=be.lm_damping_init, pcg_iters=be.pcg_iters,
                pcg_tol=be.pcg_tol, huber_delta=be.huber_delta, solver=be.solver,
                step_clamp=(be.ba_step_clamp_cam, be.ba_step_clamp_pt))


def run(run):
    import torch

    import parakeet_slam_tpu_torch  # noqa: F401  (float32 with TF32 off, as the port sets it)
    from parakeet_slam_tpu_torch.backend import ba, graph
    from parakeet_slam_tpu_torch.frontend.camera import Pinhole

    dev = torch.device(run.device, 0) if run.device == "cuda" else torch.device(run.device)
    p = run.cell.traffic["params"]
    cfg = spec.port_config(run.cell.config)
    kw = solver_settings(cfg)
    raw = ba_problem.make(p, run.seed, dev)
    cam = Pinhole(*p["camera"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def solve():
        prob = graph.make_ba_problem(**raw, device=dev)
        res = ba.optimize_ba(cam, prob, **kw)
        return (res.problem.cam_pose.cpu(), res.problem.points.cpu(), res.costs.cpu())

    solve()  # the first solve: eager first iteration, then the capture
    sync()
    run.setup_done()

    outs, n, ends = [], 0, []
    w = spans.window_begin(run)
    t0 = time.perf_counter()
    trace_at = run.seconds / 2
    while True:
        if run.trace and run.stretch is None and time.perf_counter() - t0 >= trace_at:
            with Stretch() as st:
                outs.append(solve())
            run.stretch = st.summary
            run.counters["lm_iters_traced"] = kw["iters"]
        else:
            outs.append(solve())
        n += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= run.seconds:
            break
    window = time.perf_counter() - t0
    spans.window_end(run, w)
    run.e2e["ba_solve_s"] = window / n
    run.attempted = n
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    if run.trace and run.stretch is not None:
        # the launches of apply_cinv in the traced solve: its buckets' sizes
        bk = graph.pack_buckets(graph.make_ba_problem(**raw, device=dev))
        run.counters["cinv_sizes"] = [int(pc.shape[0]) for pc in bk.p_cam]
        run.counters["cinv_launches_per_bucket"] = kw["iters"] * (kw["pcg_iters"] + 3)
    # the program's graphs go before the reference runs
    if dev.type == "cuda":
        ba.captured_solver(dev).steps.clear()
        torch.cuda.empty_cache()

    pick = random.Random(run.seed).randrange(n)
    poses, points, _ = outs[pick]
    finals = [float(o[2][-1]) for o in outs]
    took = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    med = statistics.median(took)
    run.note(f"ba_solve: a solve's seconds: min {min(took):.4f}, median {med:.4f}, max "
             f"{max(took):.4f}; solves over 1.02 x the median "
             f"{sum(1 for t in took if t > 1.02 * med)}")
    run.note(f"ba_solve: {n} solves in {window:.3f} s; final costs "
             f"{min(finals)!r}..{max(finals)!r}; checked solve {pick}")
    t_ref = time.perf_counter()
    ref = ba_ref.solve(p["camera"], raw, kw, dev)
    run.note(f"ba_solve: the reference took {time.perf_counter() - t_ref:.2f} s")
    nums = ba_ref.compare(finals, poses, points, ref)
    cn = None
    if run.with_control:
        ctl = ba_ref.solve(p["camera"], raw, kw, dev, tf32=True)
        cn = ba_ref.compare([float(ctl[2][-1])], ctl[0], ctl[1], ref)
        run.note("control (the reference in TF32) against the reference: "
                 + " ".join(f"{k}={v!r}" for k, v in cn.items()))
        reo = ba_ref.solve(p["camera"], ba_ref.reorder(raw, run.seed ^ REORDER_SEED), kw, dev)
        run.counters["reordering"] = ba_ref.compare([float(reo[2][-1])], reo[0], reo[1], ref)
        run.note(f"{REORDERING} against the reference: "
                 + " ".join(f"{k}={v!r}" for k, v in run.counters["reordering"].items()))
        run.note("the relative cost gap by LM iteration (printed, not compared): control "
                 + " ".join(f"{g:.3g}" for g in ba_ref.cost_gaps(ctl[2], ref)) + "; reordering "
                 + " ".join(f"{g:.3g}" for g in ba_ref.cost_gaps(reo[2], ref)))
    run.note("program against the reference: " + " ".join(f"{k}={v!r}" for k, v in nums.items()))
    run.hold([nums], [cn])
