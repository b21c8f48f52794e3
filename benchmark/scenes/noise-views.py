"""Scene "noise-views": a seeded scene made on the device, seen by each
projector of the configuration from its own x position.

The scene stands in for SFMoMA, whose assets are not on the card host:
band-limited noise disparity in [0.2, 0.8] with a hard near box at 0.95
and band-limited noise colour (the generator of the program's bench
scenes, rewritten in torch with a torch.Generator on the device). A
configuration's file gives its sizes and constants; every projector of a
configuration shows one scene, each from its own x position.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.lateral import Source


def generator(seed: int, device) -> torch.Generator:
    """A torch.Generator on `device` seeded from any whole number."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63))
    return gen


def smooth_noise(gen, h, w, octaves, lo=0.0, hi=1.0):
    """Band-limited noise in [lo, hi]: random grids, coarse to fine,
    bilinearly upsampled to (h, w) and summed at halving amplitudes."""
    dev = gen.device
    acc = torch.zeros((h, w), device=dev)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        gh = max(2, h // (2 ** (octaves - o + 1)))
        gw = max(2, w // (2 ** (octaves - o + 1)))
        grid = torch.rand((gh, gw), generator=gen, device=dev)
        ys = torch.linspace(0, gh - 1, h, device=dev)
        xs = torch.linspace(0, gw - 1, w, device=dev)
        y0, x0 = ys.floor().long(), xs.floor().long()
        y1, x1 = (y0 + 1).clamp(max=gh - 1), (x0 + 1).clamp(max=gw - 1)
        fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
        top = grid[y0][:, x0] * (1 - fx) + grid[y0][:, x1] * fx
        bot = grid[y1][:, x0] * (1 - fx) + grid[y1][:, x1] * fx
        acc += amp * (top * (1 - fy) + bot * fy)
        total += amp
        amp *= 0.5
    return lo + (hi - lo) * acc / total


def make_scene(gen, w, h):
    """(rgb (h, w, 3), disp (h, w)) float32 on the generator's device."""
    disp = smooth_noise(gen, h, w, 3, 0.2, 0.8)
    disp[h // 3:h // 2, w // 3:w // 2] = 0.95
    rgb = torch.stack([smooth_noise(gen, h, w, 4) for _ in range(3)], -1)
    return rgb.contiguous(), disp.contiguous()


def _lerp_x(tex, gx):
    """Linear read of tex (h, w[, c]) along x at columns gx (h, w), with
    the edges clamped."""
    w = tex.shape[1]
    gx = gx.clamp(0.0, w - 1.0)
    x0 = gx.floor().long().clamp(max=w - 2)
    f = gx - x0
    rows = torch.arange(tex.shape[0], device=tex.device)[:, None]
    if tex.ndim == 3:
        f = f[..., None]
    return tex[rows, x0] * (1 - f) + tex[rows, x0 + 1] * f


def view_from(rgb, disp, focal, dx, izmin, izmax, iters=3):
    """The scene (rgb, disp), seen from dx m further along x: each output
    column j reads the source column gx with gx = j + focal*dx*invz(gx)
    (invz baseline-normalized), solved by fixed-point steps."""
    w = disp.shape[1]
    j = torch.arange(w, dtype=torch.float32, device=disp.device)[None, :]
    gx = j.expand_as(disp)
    for _ in range(iters):
        invz = izmax + _lerp_x(disp, gx) * (izmin - izmax)
        gx = j + focal * dx * invz
    return _lerp_x(rgb, gx).contiguous(), _lerp_x(disp, gx).contiguous()


def build(config: dict, seed: int, device):
    """The configuration's projectors from the seed: a list of
    reference.lateral.Source, one per projector, each at its x
    position."""
    if config.get("layers", 1) != 1:
        raise ValueError("noise-views makes one-layer projectors")
    w, h = config["width"], config["height"]
    focal = config["focal_ratio"] * w
    near, far = config["invz_near"], config["invz_far"]
    baseline = config["baseline_m"]
    gen = generator(seed, device)
    rgb, disp = make_scene(gen, w, h)
    xs = [config["projector_dx_m"] * i for i in range(config["projectors"])]
    izmin, izmax = near / baseline, far / baseline
    srcs = []
    for x in xs:
        view = (rgb, disp) if x == 0.0 else view_from(
            rgb, disp, np.float32(focal), x, izmin, izmax)
        srcs.append(Source(*view, focal=focal, x=x, invz_near=near,
                           invz_far=far, baseline=baseline))
    return srcs


def projectors(lt, srcs, config: dict):
    """The program's one-layer Projectors holding the sources' textures
    (the same device tensors), each at its x position."""
    return [_projector(lt, src, config) for src in srcs]


def _projector(lt, src: Source, config: dict):
    h, w = src.disp.shape
    f32 = np.float32
    return lt.Projector(
        rgb=src.rgb[None], disp=src.disp[None],
        mask=torch.ones_like(src.disp)[None],
        layer_res=np.array([[w, h]], f32),
        invz_min=np.array([config["invz_near"]], f32),
        invz_max=np.array([config["invz_far"]], f32),
        focal=np.array([src.focal], f32), skew=np.zeros(2, f32),
        position=np.array([src.x, 0.0, 0.0], f32),
        rotation=np.eye(3, dtype=f32),
        baseline=f32(config["baseline_m"]), num_layers=1, width=w, height=h)
