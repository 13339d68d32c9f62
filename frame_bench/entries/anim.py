"""``"anim"``: ``scene/affine.make_affine_render_fn`` with the harness's
``mats_fn`` (the pose formula in torch, evaluated inside the frame's
graph); a frame is ``render_t(t)`` for the next of ``poses`` values of
``t`` in one period."""

import math

import torch

from piet_tpu_torch.renderer.capacity import fit_capacities
from piet_tpu_torch.scene import affine

from ..reference.affine import transform_scene
from ..workload import Workload, envelope, failed, port_scene, stats_of


class Entry(Workload):
    """The scene staged once; a frame is ``render_t(t)`` of
    ``make_affine_render_fn`` for the next of ``poses`` values of ``t`` in
    one period, the pose's affine computed by :meth:`mats` inside the
    frame's graph."""

    def __init__(self, *args):
        super().__init__(*args)
        scene = port_scene(self.base)
        self.mats_host = [self.pose_matrix(k) for k in range(self.n_poses)]
        self.cfg = envelope(self.base_cfg, [
            fit_capacities(affine.host_transform_scene(scene, m),
                           self.base_cfg, bucket=self.bucket)
            for m in self.mats_host])
        self.render_t = affine.make_affine_render_fn(
            self.cfg, scene, self.mats, device=self.device,
            fine_impl=self.fine_impl)
        self._stats = None

    def mats(self, t):
        """The pose formula in torch: ``t`` (0-d f32 on the card) in
        [0, 1) is one period."""
        a = t * (2.0 * math.pi)
        s = 1.0 + self.zoom * torch.sin(a)
        ca = torch.cos(a) * s
        sa = torch.sin(a) * s
        cx, cy = self.width / 2.0, self.height / 2.0
        return torch.stack([ca, -sa, sa, ca, cx - ca * cx + sa * cy,
                            cy - sa * cx - ca * cy])

    def pose_matrix(self, k):
        """Pose ``k``'s matrix as the frame's graph computes it: the same
        torch ops, eagerly on the card, copied to the host."""
        t = torch.full((), k / self.n_poses, dtype=torch.float32,
                       device=self.device)
        return self.mats(t).cpu().numpy()

    def frame(self, i):
        img, self._stats = self.render_t(self.pose(i) / self.n_poses)
        return img

    def finish(self, img):
        keys = list(self._stats)
        return failed(stats_of(self._stats[keys[0]], keys))

    def reference_scene(self, p):
        return transform_scene(self.base, self.mats_host[p])

    def close(self):
        del self.render_t, self._stats
