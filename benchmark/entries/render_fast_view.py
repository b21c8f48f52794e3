"""Entry "render_fast_view": one camera a call over the first projector,
render_fast_view(proj, cam, config=..., **kwargs): (1, H, W, 4)."""


def make(lt, projs, render_config: dict, kwargs: dict):
    cfg = lt.RenderConfig(**render_config)

    def call(cams):
        (cam,) = cams
        return lt.render_fast_view(projs[0], cam, config=cfg, **kwargs)[None]
    return call
