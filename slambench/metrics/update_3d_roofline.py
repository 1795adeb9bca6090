"""measurement_update_3d's share of its roofline on rank 0 over the traced
frames, in %: the update scoring the frame itself (FastSLAM 1.0) on the
rank's rows. Each launch's bound is the larger of its bytes over the
bandwidth and its operations over the float32 peak; the bounds are summed
over the launches' summed device time.

What the frame's inputs need: every lane's flag read; the mean,
covariance, descriptor and count of every valid lane read (a free lane is
skipped); an updated lane's mean and covariance written, a new lane's
mean, covariance, descriptor, count and flag written; the observations,
camera rows, log_w (read and written), n_match and target once.
Operations: `roofline.update_ops` (the valid observations against every
valid lane, each lane's geometry, association, apply, initialisation and
cull). The valid lanes are the mean count the frame before reported
(`StepMetrics.num_landmarks`) times the rank's particles; the updated
lanes the frame's own matched share (`StepMetrics.match_frac`) of its Z
observations on each particle, the rest new lanes (the world's frames
have all Z observations valid)."""

from slambench.harness import roofline


def read(run):
    if run.stretch is None:
        return None
    launches = run.stretch.kernels("ekf_update_3d_kernel")
    if not launches or len(launches) != run.counters["frames_traced"]:
        return None
    f = run.cell.config["run"]["filter"]
    L, Z, W, D = f["max_landmarks"], f["max_observations"], f["desc_words"], f["lm_dim"]
    P = run.counters["local_particles"]
    geo = D * 4 + D * D * 4
    fixed = P * L + Z * (f["obs_dim"] * 4 + W * 4 + 1) + P * 12 * 4 + 2 * P * 4 + P * 4 + P * Z * 4
    bound = 0.0
    for m, share in zip(run.counters["lanes_mean"], run.counters["match_frac"]):
        lanes = int(round(m * P))
        upd = int(round(share * Z * P))
        new = Z * P - upd
        n_bytes = fixed + lanes * (geo + W * 4 + 4) + upd * geo + new * (geo + W * 4 + 4 + 1)
        ops = roofline.update_ops(f["measurement_model"], W, lanes, Z, P, upd, new)
        bound += roofline.bound(n_bytes, ops)[0]
    measured = sum(e - s for _, s, e in launches) / 1e6
    return roofline.share_pct(bound, measured)
