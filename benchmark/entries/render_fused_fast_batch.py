"""Entry "render_fused_fast_batch": every camera of a call fused from all
projectors, render_fused_fast_batch(projs, cams, config=..., **kwargs):
(B, H, W, 4)."""


def make(lt, projs, render_config: dict, kwargs: dict):
    cfg = lt.RenderConfig(**render_config)

    def call(cams):
        return lt.render_fused_fast_batch(projs, cams, config=cfg, **kwargs)
    return call
