"""Entry "render_stereo_fast_batch": every camera of a call in one batch
over the first two projectors, the left and right views of a stereo LIF,
render_stereo_fast_batch(left, right, cams, config=..., **kwargs):
(B, H, W, 4), one frame a camera."""


def make(lt, projs, render_config: dict, kwargs: dict):
    cfg = lt.RenderConfig(**render_config)

    def call(cams):
        return lt.render_stereo_fast_batch(projs[0], projs[1], cams,
                                           config=cfg, **kwargs)
    return call
