"""Deterministic BA problem shared by the multi-process test workers.

Both the 2-process fake-cluster workers (tests/test_multihost.py) and
the parent's single-process reference build THE SAME problem from this
module, so cross-process results are directly comparable. Landmark
count is a multiple of 8 (the global device count) — multi-host callers
pad landmarks themselves (parallel/distributed.py).
"""

from __future__ import annotations

import numpy as np


def make_problem(n_cams: int = 6, n_pts: int = 64, seed: int = 0):
    import jax.numpy as jnp

    from sift_slam.sfm import geometry as geo

    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -2, 6], [2, 2, 12], size=(n_pts, 3))
    k = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1.0]])
    rots, ts, cams, lms, uvs = [], [], [], [], []
    for c in range(n_cams):
        r = np.asarray(geo.so3_exp(jnp.asarray([0.0, 0.06 * c, 0.01 * c])))
        center = np.array([0.5 * c, 0.05 * c, -0.1 * c])
        t = -r @ center
        xc = pts @ r.T + t
        uv = xc[:, :2] / xc[:, 2:3] * 500.0 + [320, 240]
        uv += 0.3 * rng.normal(size=uv.shape)
        rots.append(r)
        ts.append(t)
        cams.append(np.full(n_pts, c))
        lms.append(np.arange(n_pts))
        uvs.append(uv)
    state = {
        "rotations": np.stack(rots),
        "translations": np.stack(ts),
        "points": pts + 0.08 * rng.normal(size=pts.shape),
        "k_mat": k,
    }
    obs = {
        "camera": np.concatenate(cams).astype(np.int32),
        "landmark": np.concatenate(lms).astype(np.int32),
        "uv": np.concatenate(uvs),
        "valid": np.ones(n_cams * n_pts, bool),
    }
    return state, obs
