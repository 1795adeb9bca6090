"""Seeded inputs for holding the update kernel against its twin (and, in the
tests, against the JAX package): a pre-filled particle state and one frame
of observations, as numpy arrays.

The particles sit near one pose and share one landmark world, each with its
own jitter, so that observations made from the first particle's pose
associate in every particle. Half the observations re-observe mapped
landmarks, the rest are new; with `collide`, pairs of observations repeat a
landmark so that two updates land on one lane in one frame. `fill` chooses
the map: "holes" (about half the lanes valid, scattered), "full" (no free
lane) or "empty".
"""

from __future__ import annotations

import numpy as np


def prefilled_frame(P, L, Z, S, seed, fill="holes", collide=True, n_invalid=1):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    base = np.array([0.5, -0.3, 0.2])
    pose = base + rng.normal(scale=[0.05, 0.05, 0.02], size=(P, 3))

    # the landmark world: ranges 1..8 m (some beyond max_range), all bearings
    r = rng.uniform(1.0, 8.0, L)
    phi = rng.uniform(-np.pi, np.pi, L)
    world = base[:2] + r[:, None] * np.stack([np.cos(base[2] + phi), np.sin(base[2] + phi)], 1)
    world_sig = rng.uniform(0.0, 1.0, (L, S))
    lm_mean = world[None] + rng.normal(scale=0.03, size=(P, L, 2))
    A = rng.normal(scale=0.1, size=(P, L, 2, 2))
    lm_cov = A @ np.swapaxes(A, -1, -2) + 0.005 * np.eye(2)
    lm_sig = world_sig[None] + rng.normal(scale=0.05, size=(P, L, S))
    if fill == "full":
        lm_valid = np.ones((P, L), bool)
    elif fill == "empty":
        lm_valid = np.zeros((P, L), bool)
    else:
        lm_valid = rng.random((P, L)) < 0.5
    lm_count = np.where(lm_valid, rng.integers(0, 4, (P, L)), 0)

    # observations from particle 0's pose: re-observations of mapped
    # landmarks in view, then new landmarks between them
    seen = np.flatnonzero(lm_valid[0] & (r < 6.0))
    n_old = min(len(seen), Z // 2)
    picks = rng.choice(seen, n_old, replace=False) if n_old else np.zeros(0, int)
    pts = list(world[picks])
    sigs = list(world_sig[picks])
    while len(pts) < Z:
        rr, pp = rng.uniform(1.0, 5.0), rng.uniform(-2.3, 2.3)
        pts.append(base[:2] + rr * np.array([np.cos(base[2] + pp), np.sin(base[2] + pp)]))
        sigs.append(rng.uniform(0.0, 1.0, S))
    pts, sigs = np.array(pts[:Z]), np.array(sigs[:Z]).reshape(Z, S)
    if collide and Z >= 4:
        pts[1], sigs[1] = pts[0], sigs[0]             # two re-observations of one lane
        pts[Z - 1], sigs[Z - 1] = pts[Z - 2], sigs[Z - 2]
    d = pts - pose[0, :2]
    z = np.stack(
        [np.hypot(d[:, 0], d[:, 1]), np.arctan2(d[:, 1], d[:, 0]) - pose[0, 2]], 1
    )
    z[:, 1] = np.arctan2(np.sin(z[:, 1]), np.cos(z[:, 1]))
    z = z + rng.normal(scale=[0.02, 0.005], size=(Z, 2))
    sig = sigs + rng.normal(scale=0.05, size=(Z, S))
    valid = np.arange(Z) < Z - n_invalid
    return dict(
        pose=pose.astype(f32), log_w=rng.normal(size=P).astype(f32),
        lm_mean=lm_mean.astype(f32), lm_cov=lm_cov.astype(f32),
        lm_sig=lm_sig.astype(f32), lm_valid=lm_valid,
        lm_count=lm_count.astype(np.int32), z=z.astype(f32), sig=sig.astype(f32),
        valid=valid,
    )
