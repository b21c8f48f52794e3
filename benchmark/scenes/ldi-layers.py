"""Scene "ldi-layers": a seeded layered depth image made on the device,
the layers of one projector at the origin, top (front) layer first.

It stands in for an outpainted multi-layer LIF, whose assets are not on
the card host. Every layer covers the whole outpainted layer
(configuration keys layer_width x layer_height) with band-limited noise
colour and disparity, stored as a LIF's PNG payloads hold them: the
colour as 8-bit sRGB codes decoded to linear light (the loader's decode),
the disparity in [0.1, 0.9] and the mask quantised to 8 bits. The bottom
layer's mask is 1 everywhere; each layer in front of it is masked to
about its share mask_cover of the texels by a thresholded band-limited
noise field softened by a 5 x 5 box, so its edges are at least 2 texels
wide with values strictly between 0 and 1. A configuration's file gives
the sizes, the per-layer ranges (layer_invz, as the loader leaves them)
and the constants.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.lifbench import parts
from benchmark.reference.ldi import Layer

BOX = 5  # the mask's softening box, texels a side


def _noise():
    return parts.load("scenes", "noise-views")


def quantise(x):
    """x in [0, 1] as an 8-bit payload decodes it: round(255 x) / 255."""
    return torch.round(x.clamp(0.0, 1.0) * 255.0) / 255.0


def srgb_to_linear(x):
    """The sRGB decode of 8-bit colour, in the loader's float32 order."""
    return torch.where(x <= 0.04045, x / 12.92,
                       torch.pow((x + 0.055) / 1.055, 2.4))


def blobs(gen, h, w, cells=64):
    """Band-limited noise of features about `cells` texels across: a
    coarse random grid, bilinearly upsampled, plus a finer one at half
    the amplitude."""
    dev = gen.device
    acc = torch.zeros((h, w), device=dev)
    for step, amp in ((cells, 1.0), (cells // 4, 0.5)):
        gh, gw = max(2, h // step + 2), max(2, w // step + 2)
        grid = torch.rand((1, 1, gh, gw), generator=gen, device=dev)
        acc += amp * torch.nn.functional.interpolate(
            grid, size=(h, w), mode="bilinear", align_corners=True)[0, 0]
    return acc


def soft_mask(gen, h, w, cover):
    """An 8-bit mask over about `cover` of the texels: the noise above its
    (1 - cover) quantile, then a BOX x BOX box filter. cover 1: ones."""
    if cover >= 1.0:
        return torch.ones((h, w), device=gen.device)
    n = blobs(gen, h, w)
    hard = (n > torch.quantile(n.reshape(-1), 1.0 - cover)).float()
    soft = torch.nn.functional.avg_pool2d(
        hard[None, None], BOX, stride=1, padding=BOX // 2,
        count_include_pad=False)[0, 0]
    return quantise(soft)


class LayerStack(list):
    """The LDI's layers (reference.ldi.Layer, front first), and the
    stacked (L, H, W[, 3]) device textures they are views of."""

    def __init__(self, layers, rgb, disp, mask):
        super().__init__(layers)
        self.rgb, self.disp, self.mask = rgb, disp, mask


def build(config: dict, seed: int, device):
    """The configuration's layered projector from the seed: a LayerStack
    of its layers, top first, at x = 0."""
    if config.get("projectors", 1) != 1:
        raise ValueError("ldi-layers makes one layered projector")
    n = config["layers"]
    w, h = config["layer_width"], config["layer_height"]
    if (w - config["width"], h - config["height"]) != (
            config["outpaint_px"], config["outpaint_px"]):
        raise ValueError("each layer is the view plus outpaint_px")
    covers = config["mask_cover"]
    noise = _noise()
    gen = noise.generator(seed, device)
    rgb = torch.empty((n, h, w, 3), device=device)
    disp = torch.empty((n, h, w), device=device)
    mask = torch.empty((n, h, w), device=device)
    for i in range(n):
        disp[i] = quantise(noise.smooth_noise(gen, h, w, 3, 0.1, 0.9))
        for c in range(3):
            rgb[i, ..., c] = srgb_to_linear(
                quantise(noise.smooth_noise(gen, h, w, 4)))
        mask[i] = soft_mask(gen, h, w, covers[i])
    focal = config["focal_ratio"] * config["width"]
    layers = [Layer(rgb[i], disp[i], mask[i], focal=focal, x=0.0,
                    invz_near=near, invz_far=far,
                    baseline=config["baseline_m"])
              for i, (near, far) in enumerate(config["layer_invz"])]
    return LayerStack(layers, rgb, disp, mask)


def projectors(lt, srcs, config: dict):
    """The program's one layered Projector holding the stack's textures
    (the same device tensors), at the origin: the fields load_lif_file
    gives a legacy outpainted LDI (layer_res the layers' size, the view's
    focal on every layer, width and height the first layer's)."""
    n, h, w = srcs.disp.shape
    f32 = np.float32
    invz = np.array(config["layer_invz"], f32)
    return [lt.Projector(
        rgb=srcs.rgb, disp=srcs.disp, mask=srcs.mask,
        layer_res=np.array([[w, h]] * n, f32),
        invz_min=invz[:, 0], invz_max=invz[:, 1],
        focal=np.array([srcs[0].focal] * n, f32), skew=np.zeros(2, f32),
        position=np.zeros(3, f32), rotation=np.eye(3, dtype=f32),
        baseline=f32(config["baseline_m"]), num_layers=n, width=w, height=h)]
