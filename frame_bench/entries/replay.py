"""``"replay"``: the scene is staged once into the static inputs of a
frame step (``make_render_fn``); a frame is ``step.flat(staged)``, one
replay of the step's CUDA graph."""

from piet_tpu_torch.renderer.capacity import fit_capacities
from piet_tpu_torch.renderer.renderer import make_render_fn, prepare_scene

from ..workload import Workload, failed, port_scene, stats_of


class Entry(Workload):
    """The scene staged once; a frame is one replay of the frame step on
    its static inputs (``RenderFn.flat``)."""

    def __init__(self, *args):
        super().__init__(*args)
        scene = port_scene(self.base)
        self.cfg = fit_capacities(scene, self.base_cfg, bucket=self.bucket)
        self.step = make_render_fn(self.cfg, self.device, self.fine_impl)
        self.staged = self.step.stage(prepare_scene(scene, self.cfg,
                                                    self.device))
        self._hw = self.width * self.height

    def frame(self, i):
        return self.step.flat(self.staged)

    def finish(self, flat):
        return failed(stats_of(flat[self._hw:], self.step.keys))

    def image(self, flat):
        return flat[:self._hw].reshape(self.height, self.width)

    def close(self):
        del self.step, self.staged
