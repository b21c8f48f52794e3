"""The benchmark's LDI cell (ldi3-1280x800.trajectory) on the CPU at a
tiny size: a 64 x 40 view of a seeded 3-layer LDI (benchmark/scenes/
ldi-layers.py), each layer outpainted by 16 px, masked (mask mode
'multiply') and rendered by render_fast_batch(method="march") in two pose
chunks, held to the cell's plain reference (benchmark/reference/ldi.py)
within the cell's check limits; and the scene's arrays written as a
legacy layered_depth_image_data LIF and read back by load_lif_file, which
gives the scene's layer sizes, its ranges after the loader's division by
1 + outpaint / width, its focal and its textures."""

from pathlib import Path

import numpy as np
import pytest
import torch

import lif_tpu_torch as lt
from benchmark.lifbench import check, harness, parts, traffic
from lif_tpu_torch.io import container
from lif_tpu_torch.io.decode import encode_png

ROOT = Path(__file__).resolve().parents[1]
CELL = "ldi3-1280x800.trajectory"
SEED = 2**31 + 2207
W, H, OUTPAINT = 64, 40, 16
N, CHUNK = 8, 4  # poses a call, poses a chunk: two chunks


def tiny():
    """The cell's overrides at a 64 x 40 view with 16 px of outpainting:
    the layers' stored ranges under the loader's rule at this width."""
    cfg = parts.load_json(ROOT / "benchmark/configs/ldi3-1280x800.json")
    grow = 1.0 + OUTPAINT / W
    return {
        "config": {
            "width": W, "height": H, "outpaint_px": OUTPAINT,
            "layer_width": W + OUTPAINT, "layer_height": H + OUTPAINT,
            "layer_invz": [[near / grow, far / grow] for near, far
                           in cfg["assumed"]["layer_invz_stored"]],
            "render_config": dict(cfg["render_config"], pose_chunk=CHUNK),
        },
        "traffic": {"poses_per_call": N},
    }


@pytest.fixture(scope="module")
def scene():
    """(cell, the reference's layers, the program's projector)."""
    cell = harness.Cell(ROOT, CELL, tiny())
    part = parts.load("scenes", cell.config["scene"])
    srcs = part.build(cell.config, SEED, torch.device("cpu"))
    (proj,) = part.projectors(lt, srcs, cell.config)
    return cell, srcs, proj


@pytest.mark.parametrize("x0", [-0.011, 0.047],
                         ids=["straddles_zero", "one_side"])
def test_program_equals_the_reference(scene, x0):
    """Every layer marches, and each frame equals the reference within
    the cell's limits."""
    cell, srcs, proj = scene
    poses = {"position": np.array([[x0 + 0.02 * i / N, 0.0, 0.0]
                                   for i in range(N)])}
    assert (poses["position"][0, 0] < 0.0 < poses["position"][-1, 0]) == (
        x0 < 0.0)
    cams = traffic.cameras(lt, poses, cell.config)
    out, tiers = lt.render_fast_batch(
        proj, cams, config=lt.RenderConfig(**cell.config["render_config"]),
        method="march", return_tiers=True)
    assert tiers == ("march",) * 3
    ref = parts.load("reference", cell.check["reference"])
    pairs = []
    for j in range(N):
        frame, work = ref.render_slot(srcs, check.Slot(out[j], j, poses),
                                      cell.config, cell.check["options"])
        assert work["lateral_march"]["pixels"] == 3 * W * H
        pairs.append((out[j], frame))
    ok, rows = check.judge(check.gaps(pairs), cell.check["limits"])
    assert ok, rows
    # the layers behind the front one show through its mask
    assert 0.0 < float(srcs[0].mask.mean()) < 1.0


def _srgb_codes(linear):
    """The 8-bit sRGB codes a linear colour was decoded from, over 255."""
    x = linear.double().clamp(0.0, 1.0)
    srgb = torch.where(x <= 0.0031308, x * 12.92,
                       1.055 * x.pow(1.0 / 2.4) - 0.055)
    return (torch.round(srgb * 255.0) / 255.0).float().numpy()


def test_lif_round_trip(scene):
    """The tiny scene written as a legacy LDI LIF with PNG payloads (as
    chip_smoke.py::make_lif writes one) loads back as the scene's
    projector: layer sizes, ranges after the loader's rule, focal,
    baseline and textures."""
    cell, srcs, proj = scene
    cfg = cell.config
    ratio = cfg["focal_ratio"]
    stored = cfg["assumed"]["layer_invz_stored"]
    blobs, layers = {20: encode_png(srcs[-1].disp.numpy())}, []
    for i, (src, (near, far)) in enumerate(zip(srcs, stored)):
        ids = (30 + 3 * i, 31 + 3 * i, 32 + 3 * i)
        for blob_id, arr in zip(ids, (_srgb_codes(src.rgb), src.disp.numpy(),
                                      src.mask.numpy())):
            blobs[blob_id] = encode_png(arr)
        # legacy LDI ranges are stored scaled by -focal_ratio_to_width
        layers.append({"image": {"blob_id": ids[0]},
                       "inv_z_map": {"blob_id": ids[1], "min": -near * ratio,
                                     "max": -far * ratio},
                       "mask": {"blob_id": ids[2]}})
    top = (OUTPAINT // 2, OUTPAINT // 2 + H)
    left = (OUTPAINT // 2, OUTPAINT // 2 + W)
    view_rgb = _srgb_codes(srcs[-1].rgb)[top[0]:top[1], left[0]:left[1]]
    view = {
        "image": {"blob_id": -1},
        "inv_z_map": {"blob_id": 20, "min": stored[-1][0],
                      "max": stored[-1][1]},
        "width_px": W, "height_px": H, "focal_px": ratio * W,
        "position": [0.0, 0.0, 0.0], "rotation": [0.0, 0.0, 0.0],
        "camera_data": {"focal_ratio_to_width": ratio},
        "layered_depth_image_data": {
            "outpainting_added_width_px": OUTPAINT,
            "outpainting_added_height_px": OUTPAINT,
            "layers_top_to_bottom": layers,
        },
    }
    data = container.write(encode_png(view_rgb),
                           {"views": [view],
                            "baseline_mm": cfg["baseline_m"] * 1e3},
                           blobs)
    (got,) = lt.load_lif_file(data, device="cpu").projectors
    assert got.num_layers == proj.num_layers == 3
    assert (got.width, got.height) == (proj.width, proj.height)
    np.testing.assert_array_equal(got.layer_res, proj.layer_res)
    assert (got.layer_res == [W + OUTPAINT, H + OUTPAINT]).all()
    np.testing.assert_array_equal(got.focal, proj.focal)
    assert got.baseline == proj.baseline
    # the loader's rule: stored / (1 + outpaint / width), in float32
    np.testing.assert_allclose(got.invz_min, proj.invz_min, rtol=1e-7)
    np.testing.assert_allclose(got.invz_max, proj.invz_max, rtol=1e-7)
    grow = 1.0 + OUTPAINT / W
    np.testing.assert_allclose(
        proj.invz_min, np.array(stored)[:, 0] / grow, rtol=1e-7)
    assert torch.equal(got.disp, proj.disp)
    assert torch.equal(got.mask, proj.mask)
    torch.testing.assert_close(got.rgb, proj.rgb, rtol=0.0, atol=1e-6)
