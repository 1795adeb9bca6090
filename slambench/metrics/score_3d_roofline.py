"""score_3d's share of its roofline over the traced frames, in %: each
frame's bound summed, over the launches' summed device time. A frame's
bound is the larger of its bytes over the bandwidth and its operations
over the float32 peak. Bytes: what these inputs need, read once: every
lane's flag, and the mean, covariance and descriptor of the valid lanes
alone (a free lane is skipped), the camera rows, the observations and
their descriptors; the outputs written once. Operations: every
observation against every valid lane plus each valid lane's geometry
(`roofline.score_ops`). The valid lanes are the mean count the frame
before reported (`StepMetrics.num_landmarks`) times the particles."""

from slambench.harness import roofline


def read(run):
    if run.stretch is None:
        return None
    launches = run.stretch.kernels("score_3d_kernel")
    if not launches or len(launches) != run.counters["frames_traced"]:
        return None
    f = run.cell.config["run"]["filter"]
    P, L, Z, W = f["num_particles"], f["max_landmarks"], f["max_observations"], f["desc_words"]
    D = f["lm_dim"]
    per_lane = D * 4 + D * D * 4 + W * 4
    fixed = P * L + P * 12 * 4 + Z * (f["obs_dim"] + W) * 4 + P * Z * 8
    bound = 0.0
    for m in run.counters["lanes_mean"]:
        lanes = int(round(m * P))
        bound += roofline.bound(fixed + lanes * per_lane,
                                roofline.score_ops(f["measurement_model"], W, lanes, Z))[0]
    measured = sum(e - s for _, s, e in launches) / 1e6
    return roofline.share_pct(bound, measured)
