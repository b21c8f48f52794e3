"""Entry "render_fast_batch": every camera of a call in one batch over
the first projector, render_fast_batch(proj, cams, config=..., **kwargs):
(B, H, W, 4)."""


def make(lt, projs, render_config: dict, kwargs: dict):
    cfg = lt.RenderConfig(**render_config)

    def call(cams):
        return lt.render_fast_batch(projs[0], cams, config=cfg, **kwargs)
    return call
