"""Structure-from-motion / SLAM backend (green-field extension).

The reference stops at keypoint detection (reference/readme.md:11);
BASELINE.json configs[2-4] require pose estimation, incremental SfM with
Schur-complement bundle adjustment, and multi-host distributed SLAM.
Everything here is batched dense linear algebra over fixed-shape buffers.
"""
