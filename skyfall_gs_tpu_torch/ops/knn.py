"""Mean squared distance to the 3 nearest neighbors (scale initialization).

Port of the host path of ``skyfall_gs_tpu/ops/knn.py``: an exact scipy
KD-tree query, run once per scene at load time.
"""

from __future__ import annotations

import numpy as np


def mean_sq_dist_3nn_host(points: np.ndarray) -> np.ndarray:
    """Exact 3-NN mean squared distance of each point, (N,) float32."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float32)
    # k=4: the first neighbor is the point itself at distance 0.
    dist, _ = cKDTree(pts).query(pts, k=4)
    return np.mean(dist[:, 1:] ** 2, axis=1).astype(np.float32)
