"""Debug and observability tooling.

The counterpart of lif_tpu.utils.debug. The reference ships its test
strategy as debug tooling (SURVEY.md section 4): a full uniform dump on
the 'U' key (RaycastPlane.ts:862-901), a texture-debug overlay
(index.html:203-384), a depth-visualization shader mode and frustum
wireframes. The equivalents here are functions over Projector / Camera
returning host numpy: printable render-input dumps, texture montages and
depth visualizations.
"""

from __future__ import annotations

import numpy as np

from ..core.pose import relative_view_pose

__all__ = [
    "depth_visualization",
    "dump_render_inputs",
    "frustum_wireframe_points",
    "texture_montage",
]


def dump_render_inputs(projector, camera) -> dict:
    """Everything the kernels will see for (projector, camera): the analog
    of RaycastPlane.logUniforms() (reference :862-901)."""
    pos, rot = relative_view_pose(projector.position, projector.rotation,
                                  camera.position, camera.rotation)
    baseline = float(projector.baseline)
    return {
        "viewport": {"oRes": [camera.width, camera.height]},
        "camera": {
            "f2_px": float(camera.focal_px),
            "sk2": np.asarray(camera.skew).tolist(),
            "uFacePosition": [0.0, 0.0, 0.0],
            "uFaceRotation": "identity (camera-local frame)",
        },
        "projector": {
            "uViewPosition (camera-local, Z-negated)": pos.tolist(),
            "uViewRotation": rot.tolist(),
            "sk1": np.asarray(projector.skew).tolist(),
            "uNumLayers": projector.num_layers,
            "baseline_m": baseline,
        },
        "layers": [
            {
                "iRes": np.asarray(projector.layer_res[i]).tolist(),
                "f1_px": float(projector.focal[i]),
                "invZmin (shader units)": float(projector.invz_min[i])
                / baseline,
                "invZmax (shader units)": float(projector.invz_max[i])
                / baseline,
                "invZmin (LIF 1/m)": float(projector.invz_min[i]),
                "invZmax (LIF 1/m)": float(projector.invz_max[i]),
            }
            for i in range(projector.num_layers)
        ],
    }


def _layer(tex, i, h_i, w_i) -> np.ndarray:
    """Layer i of a texture tensor cut to its logical size, top-down, on
    the host."""
    return tex[i, :h_i, :w_i].detach().cpu().numpy()[::-1]


def texture_montage(projector, path: str | None = None) -> np.ndarray:
    """A grid image showing every layer's rgb / depth / mask side by side
    (the texture-debug overlay, reference index.html:203-384). Returns the
    montage (H*L, W*3, 3) top-down; with `path`, also writes it as an
    8-bit PNG (io.decode.encode_png)."""
    h_max, w_max = int(projector.rgb.shape[1]), int(projector.rgb.shape[2])
    rows = []
    for i in range(projector.num_layers):
        w_i = int(projector.layer_res[i, 0])
        h_i = int(projector.layer_res[i, 1])
        row = np.zeros((h_max, w_max * 3, 3), np.float32)
        row[:h_i, :w_i] = _layer(projector.rgb, i, h_i, w_i)
        row[:h_i, w_max:w_max + w_i] = _layer(projector.disp, i, h_i,
                                              w_i)[..., None]
        row[:h_i, 2 * w_max:2 * w_max + w_i] = _layer(projector.mask, i,
                                                      h_i, w_i)[..., None]
        rows.append(row)
    montage = np.concatenate(rows, axis=0)
    if path:
        from ..io.decode import encode_png

        with open(path, "wb") as f:  # encode_png flips GL rows to top-down
            f.write(encode_png(montage[::-1]))
    return montage


def depth_visualization(projector, layer: int = 0) -> np.ndarray:
    """The depth texture as grayscale (the 'V' toggle / showDepth shader
    mode, reference holoFragment.glsl:39-44), top-down."""
    w_i = int(projector.layer_res[layer, 0])
    h_i = int(projector.layer_res[layer, 1])
    d = _layer(projector.disp, layer, h_i, w_i)
    return np.repeat(d[..., None], 3, axis=-1)


def frustum_wireframe_points(projector) -> dict:
    """Frustum wireframe segments in world space (the frustum helper,
    reference HoloProjector.ts:388-484): 8 corners + the edge index list."""
    corners_local = projector.frustum_corners()  # (8, 3)
    rot = np.asarray(projector.rotation, np.float64)
    pos = np.asarray(projector.position, np.float64)
    corners_world = corners_local @ rot.T + pos
    edges = [
        (0, 1), (1, 2), (2, 3), (3, 0),  # near plane
        (4, 5), (5, 6), (6, 7), (7, 4),  # far plane
        (0, 4), (1, 5), (2, 6), (3, 7),  # connectors
    ]
    apex = [(None, i) for i in range(4)]  # origin -> near corners (dashed)
    return {"corners": corners_world, "edges": edges, "apex_rays": apex,
            "origin": pos}
