"""Reference-class pure-Python/numpy FastSLAM baseline.

BASELINE.md directs: the reference (`buckbaskin/parakeet_slam`) publishes no
numbers and its mount was empty at survey time, so the >=10x frames/s
target's denominator is MEASURED from this implementation — written the way
the reference works per SURVEY.md §4.1 entry 2: an interpreted Python loop
over particles, each holding a dict of per-landmark EKFs, with numpy only
for the small 2x2 matrix algebra. Do not optimize this file; it is the
honest stand-in for reference-era performance and a semantics cross-check
for the batched JAX engine (same math, same association rule).

A copy of `parakeet_slam_tpu/baseline/numpy_fastslam.py` (numpy only): the
port imports nothing of the JAX package, and `cli bench --measure-baseline`
measures the corridor benchmark's denominator with it.
"""

from __future__ import annotations

import math

import numpy as np


def _wrap(a):
    return math.atan2(math.sin(a), math.cos(a))


class Landmark:
    __slots__ = ("mean", "cov", "sig", "count")

    def __init__(self, mean, cov, sig, count=1):
        self.mean = mean
        self.cov = cov
        self.sig = sig
        self.count = count


class Particle:
    __slots__ = ("pose", "log_w", "landmarks")

    def __init__(self, pose):
        self.pose = np.array(pose, dtype=np.float64)
        self.log_w = 0.0
        self.landmarks: list[Landmark] = []

    def copy(self):
        p = Particle(self.pose.copy())
        p.log_w = 0.0
        p.landmarks = [
            Landmark(l.mean.copy(), l.cov.copy(), l.sig.copy(), l.count)
            for l in self.landmarks
        ]
        return p


class NumpyFastSLAM:
    """Sequential FastSLAM with range-bearing + signature observations."""

    def __init__(
        self,
        num_particles=64,
        motion_noise=(0.05, 0.05, 0.05, 0.05),
        meas_noise=(0.1, 0.03),
        sig_noise=0.5,
        new_landmark_loglik=-8.0,
        resample_frac=0.5,
        max_range=10.0,
        fov_half_angle=3.15,
        cull_enabled=True,
        seed=0,
    ):
        self.P = num_particles
        self.alphas = motion_noise
        self.R = np.diag(np.array(meas_noise) ** 2)
        self.sig_var = sig_noise**2
        self.log_p0 = new_landmark_loglik
        self.resample_frac = resample_frac
        self.max_range = max_range
        self.fov = fov_half_angle
        self.cull = cull_enabled
        self.rng = np.random.default_rng(seed)
        self.particles = [Particle([0.0, 0.0, 0.0]) for _ in range(self.P)]

    # -- motion -----------------------------------------------------------

    def motion_update(self, u):
        trans = math.hypot(u[0], u[1])
        rot = abs(u[2])
        a1, a2, a3, a4 = self.alphas
        st = a1 * trans + a2 * rot + 1e-6
        sr = a3 * rot + a4 * trans + 1e-6
        for p in self.particles:
            dx = u[0] + self.rng.normal(0, st)
            dy = u[1] + self.rng.normal(0, st)
            dth = u[2] + self.rng.normal(0, sr)
            c, s = math.cos(p.pose[2]), math.sin(p.pose[2])
            p.pose[0] += c * dx - s * dy
            p.pose[1] += s * dx + c * dy
            p.pose[2] = _wrap(p.pose[2] + dth)

    # -- measurement ------------------------------------------------------

    def _h(self, pose, mean):
        d = mean - pose[:2]
        r = math.hypot(d[0], d[1]) + 1e-12
        phi = _wrap(math.atan2(d[1], d[0]) - pose[2])
        return np.array([r, phi]), d, r

    def _jac(self, d, r):
        q = r * r
        return np.array([[d[0] / r, d[1] / r], [-d[1] / q, d[0] / q]])

    def measurement_update(self, zs, sigs, valids):
        for z, sig, valid in zip(zs, sigs, valids):
            if not valid:
                continue
            for p in self.particles:
                best_ll, best_j, best_data = -1e30, -1, None
                for j, lm in enumerate(p.landmarks):
                    zhat, d, r = self._h(p.pose, lm.mean)
                    H = self._jac(d, r)
                    Q = H @ lm.cov @ H.T + self.R
                    nu = np.array([z[0] - zhat[0], _wrap(z[1] - zhat[1])])
                    det = Q[0, 0] * Q[1, 1] - Q[0, 1] * Q[1, 0]
                    Qinv = np.array([[Q[1, 1], -Q[0, 1]], [-Q[1, 0], Q[0, 0]]]) / det
                    maha = nu @ Qinv @ nu
                    ll = -0.5 * (maha + math.log(max(det, 1e-12)) + 2 * math.log(2 * math.pi))
                    ll -= 0.5 * float(np.sum((sig - lm.sig) ** 2)) / self.sig_var
                    if ll > best_ll:
                        best_ll, best_j, best_data = ll, j, (H, Qinv, nu)
                if best_j < 0 or best_ll < self.log_p0:
                    # new landmark
                    ang = p.pose[2] + z[1]
                    mean = p.pose[:2] + z[0] * np.array([math.cos(ang), math.sin(ang)])
                    zhat, d, r = self._h(p.pose, mean)
                    H = self._jac(d, r)
                    Hinv = np.linalg.inv(H)
                    cov = Hinv @ self.R @ Hinv.T
                    p.landmarks.append(Landmark(mean, cov, sig.copy()))
                    p.log_w += self.log_p0
                else:
                    lm = p.landmarks[best_j]
                    H, Qinv, nu = best_data
                    K = lm.cov @ H.T @ Qinv
                    lm.mean = lm.mean + K @ nu
                    lm.cov = (np.eye(2) - K @ H) @ lm.cov
                    lm.count += 2
                    lm.sig = lm.sig + (sig - lm.sig) / max(lm.count, 1)
                    p.log_w += best_ll

        if self.cull:
            for p in self.particles:
                keep = []
                for lm in p.landmarks:
                    zhat, _, _ = self._h(p.pose, lm.mean)
                    in_fov = zhat[0] < self.max_range and abs(zhat[1]) < self.fov
                    # matched landmarks were incremented above; unmatched
                    # in-FOV ones pay one count
                    if in_fov and lm.count <= 0:
                        continue
                    keep.append(lm)
                p.landmarks = keep

        self._maybe_resample()

    def _maybe_resample(self):
        lw = np.array([p.log_w for p in self.particles])
        lw -= lw.max()
        w = np.exp(lw)
        w /= w.sum()
        ess = 1.0 / np.sum(w * w)
        if ess < self.resample_frac * self.P:
            cdf = np.cumsum(w)
            u0 = self.rng.uniform(0, 1.0 / self.P)
            pos = u0 + np.arange(self.P) / self.P
            idx = np.searchsorted(cdf, pos)
            idx = np.clip(idx, 0, self.P - 1)
            self.particles = [self.particles[i].copy() for i in idx]

    # -- estimate ---------------------------------------------------------

    def estimate_pose(self):
        lw = np.array([p.log_w for p in self.particles])
        lw -= lw.max()
        w = np.exp(lw)
        w /= w.sum()
        xy = sum(wi * p.pose[:2] for wi, p in zip(w, self.particles))
        s = sum(wi * math.sin(p.pose[2]) for wi, p in zip(w, self.particles))
        c = sum(wi * math.cos(p.pose[2]) for wi, p in zip(w, self.particles))
        return np.array([xy[0], xy[1], math.atan2(s, c)])
