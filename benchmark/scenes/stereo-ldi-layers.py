"""Scene "stereo-ldi-layers": a seeded two-view layered depth image made
on the device, the views of a stereo LIF, each of the configuration's
layers top (front) layer first.

The left view is ldi-layers' LDI (benchmark/scenes/ldi-layers.py) from
the seed, placed at the configuration's first view_x_m. The right view,
at the second, is coherent with it, as a stereo LIF's second view is:
each right layer is the left layer seen from the right view, marched
there by the plain reference's own lateral march (benchmark/reference/
ldi.py::march) over the whole outpainted layer (the layer's size out,
no crop), the colour lerped at the crossing and the disparity the
crossing's inverse depth in the layer's range. Where the march found
nothing, or its solved source position leaves the layer, the right
layer keeps the left layer's colour and disparity and its mask is 0;
elsewhere its mask is the lerped left mask. Colour (as 8-bit sRGB codes
decoded to linear), disparity and mask are quantised to 8 bits, as a
LIF's PNG payloads hold them. It uses no code of the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.lifbench import parts
from benchmark.reference.lateral import (F32, ladder_size, linear_to_srgb,
                                         snap_plane_table)
from benchmark.reference.ldi import Layer, Plan, march


def _mono():
    return parts.load("scenes", "ldi-layers")


class StereoScene(list):
    """The two views, left then right, each an ldi-layers LayerStack of
    reference.ldi.Layer (front first) at its view's x."""


def _stack(config, x, rgb, disp, mask):
    """An ldi-layers LayerStack of the (L, H, W[, 3]) textures at world x,
    with the configuration's focal and ranges."""
    focal = config["focal_ratio"] * config["width"]
    layers = [Layer(rgb[i], disp[i], mask[i], focal=focal, x=x,
                    invz_near=near, invz_far=far,
                    baseline=config["baseline_m"])
              for i, (near, far) in enumerate(config["layer_invz"])]
    return _mono().LayerStack(layers, rgb, disp, mask)


def remarch(layer, view_x):
    """The layer as seen from a view at world x view_x, at the layer's own
    size: (rgb, disp, mask), each quantised to 8 bits as above."""
    mono = _mono()
    h, w = layer.disp.shape
    cx = layer.offset(view_x)
    k = ladder_size(layer.focal, [cx], layer.izmin, layer.izmax)
    planes, _ = snap_plane_table(layer.focal, cx, layer.izmin, layer.izmax,
                                 num_planes=k)
    plan = Plan(w, w, min(layer.focal * abs(cx) * layer.izmin, float(2 * w)))
    found, izs, rgba = march(layer, cx, planes, plan, w, h)
    jx = torch.arange(w, dtype=torch.float32, device=found.device)[None, :]
    u = (jx - float(F32(layer.focal) * F32(cx)) * izs + 0.5) / w
    valid = (found > 0.5) & (u > 0.0) & (u < 1.0)
    rgb = torch.where(valid[..., None], rgba[..., :3], layer.rgb)
    rgb = mono.srgb_to_linear(mono.quantise(linear_to_srgb(rgb)))
    d = (izs - layer.izmax) / (layer.izmin - layer.izmax)
    disp = torch.where(valid, mono.quantise(d), layer.disp)
    mask = mono.quantise(valid.float() * rgba[..., 3].clamp(0.0, 1.0))
    return rgb, disp, mask


def build(config: dict, seed: int, device):
    """The configuration's two views from the seed: a StereoScene of the
    left and right LayerStacks."""
    if config.get("views", 2) != 2 or config.get("projectors", 2) != 2:
        raise ValueError("stereo-ldi-layers makes two layered views")
    x_l, x_r = config["view_x_m"]
    mono = _mono().build({**config, "projectors": 1}, seed, device)
    left = _stack(config, x_l, mono.rgb, mono.disp, mono.mask)
    rgb, disp, mask = (torch.empty_like(t) for t in (left.rgb, left.disp,
                                                     left.mask))
    for i, layer in enumerate(left):
        rgb[i], disp[i], mask[i] = remarch(layer, x_r)
    return StereoScene([left, _stack(config, x_r, rgb, disp, mask)])


def projectors(lt, srcs, config: dict):
    """The program's two layered Projectors, left then right, each holding
    its view's textures (the same device tensors) at its view's x: the
    fields load_lif_file gives each view of a stereo LIF of legacy
    outpainted LDIs."""
    return [dataclasses.replace(_mono().projectors(lt, stack, config)[0],
                                position=np.array([x, 0.0, 0.0], np.float32))
            for stack, x in zip(srcs, config["view_x_m"])]
