"""``"rebuild"``: ``poses`` host scenes (the seed's scene under the pose
affines, made at set-up); a frame hands the next one, as a new host
``Scene``, to ``Renderer.render_u32``, which stages it, replays the step
and reads the stats."""

from piet_tpu_torch.renderer.capacity import fit_capacities
from piet_tpu_torch.renderer.renderer import Renderer, SceneCapacityError
from piet_tpu_torch.scene.scene import Scene as PortScene

from .. import scenes
from ..reference.affine import transform_scene
from ..workload import FIELDS, Workload, envelope, failed


class Entry(Workload):
    """A new host scene every frame, the next of ``poses`` made at set-up,
    through ``Renderer.render_u32`` (stage, upload, replay, read the
    stats)."""

    def __init__(self, *args):
        super().__init__(*args)
        self.host_scenes = [
            transform_scene(self.base, scenes.pose_matrix(
                k, self.n_poses, self.zoom, self.width, self.height))
            for k in range(self.n_poses)]
        self._arrays = [{f: getattr(s, f) for f in FIELDS}
                        for s in self.host_scenes]
        self.cfg = envelope(self.base_cfg, [
            fit_capacities(s, self.base_cfg, bucket=self.bucket)
            for s in self.host_scenes])
        self.renderer = Renderer(self.cfg, self.device, self.fine_impl)
        self._raised = False

    def frame(self, i):
        self._raised = False
        try:
            return self.renderer.render_u32(
                PortScene(**self._arrays[self.pose(i)]))
        except SceneCapacityError:
            self._raised = True
            return None

    def finish(self, img):
        # render_u32 read the stats and raised on an overflow.
        return self._raised or failed(self.renderer.last_stats or {})

    def reference_scene(self, p):
        return self.host_scenes[p]

    def close(self):
        del self.renderer
