"""Entry "render_camera_path": a clip rendered segment by segment, as a
camera-path exporter renders one: render_fast_batch(proj, segment,
config=..., **kwargs) over the first projector once for each run of
"segments" cameras (their sizes, in the clip's order), each segment's
frames copied into the call's (n, H, W, 4) clip, which it returns. A call
given fewer cameras renders the runs that fit.

One render_fast_batch call plans one tier for its whole batch, so a clip
of a lateral slide, an orbit and a zoom renders on the lateral, target
and scaled tiers only when each motion is a call of its own.

The clip is a new tensor each call (the caching allocator hands back the
previous clip's block once the caller has let it go), so a caller that
keeps a clip keeps its frames. The copies, one device-to-device copy a
segment, are part of the call's time."""

import torch


def make(lt, projs, render_config: dict, kwargs: dict):
    cfg = lt.RenderConfig(**render_config)
    kwargs = dict(kwargs)
    sizes = kwargs.pop("segments")

    def call(cams):
        n = len(cams)
        if n > sum(sizes):
            raise ValueError(f"{n} cameras, segments of {sizes}")
        clip, a = None, 0
        for size in sizes:
            b = min(a + size, n)
            if b == a:
                break
            frames = lt.render_fast_batch(projs[0], cams[a:b], config=cfg,
                                          **kwargs)
            if clip is None:
                clip = torch.empty((n, *frames.shape[1:]),
                                   dtype=frames.dtype, device=frames.device)
            clip[a:b].copy_(frames)
            del frames
            a = b
        return clip
    return call
