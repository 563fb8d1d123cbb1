"""Merger-orbit kinematics (reference setup.c:355-424).

JAX counterpart: ``toycluster_tpu/models/kinematics.py``.  COMET: the
infalling cluster's velocity is stamped on a ball+tail region around
halo 1; PARABOLA: on a cone behind the R200 touch point; "direct" and
single clusters leave the velocities as they are.
"""

from __future__ import annotations

import torch

from ..particles import Particles
from ..scene import Scene


def apply_kinematics(scene: Scene, parts: Particles) -> Particles:
    if scene.config.mass_ratio == 0 or scene.config.orbit == "direct":
        return parts
    vx_host = float(scene.vel_merger[0])
    vx_infa = float(scene.vel_merger[1])
    h1 = scene.halos[1]
    boxhalf = scene.boxhalf
    pos = parts.pos
    if scene.config.orbit == "parabola":
        # origin at the R200 touch point (setup.c:360-376)
        x = pos[:, 0] - h1.d_com[0] + boxhalf + h1.r200
        y = pos[:, 1] - h1.d_com[1] + boxhalf
        z = pos[:, 2] - h1.d_com[2] + boxhalf
        infalling = (y * y + z * z < x * x) & (x > 0)
    else:  # comet (setup.c:379-421)
        dx = pos[:, 0] - (h1.d_com[0] + boxhalf)
        dy = pos[:, 1] - (h1.d_com[1] + boxhalf)
        dz = pos[:, 2] - (h1.d_com[2] + boxhalf)
        r2_cyl = dy * dy + dz * dz
        rvir2 = float(h1.r200 ** 2)
        # the reference's front-side WC2 slow-down is disabled (wk = 1,
        # setup.c:404-410): the comet region gets vx_infa uniformly
        infalling = ((dx > 0) & (r2_cyl < rvir2)) | (dx * dx + r2_cyl < rvir2)
    dvx = torch.where(infalling, torch.full_like(pos[:, 0], vx_infa),
                      torch.full_like(pos[:, 0], vx_host))
    vel = parts.vel.clone()
    vel[:, 0] += dvx
    return parts.replace(vel=vel)
