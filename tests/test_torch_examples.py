"""The port's examples (lif_tpu_torch/examples/) against lif_tpu's
(examples/, loaded by file path) on the CPU.

Both packages' sfmoma_assets are replaced by one seeded synthetic asset
pair: a JPEG written with PIL and an 8-bit depth PNG (both decoders read
a depth sample as value / 255). It is 480x352, not smaller, because
render_sfmoma's identity check crops 160 px off each side. Each example's
main runs on the CPU in both packages. render_sfmoma's report values
(unrounded) agree within 0.05 dB for the PSNRs (or both exceed 100 dB,
an exact passthrough up to float32 rounding) and 1e-4 for the coverage
and parallax fractions. multiview_demo's authored stereo LIFs agree
(the right eye the port synthesizes is lif_tpu's up to 8-bit and JPEG
quantization), and on one LIF every PNG its main writes agrees with
lif_tpu's. The port's examples need PIL for the JPEG; the tests skip
without it.
"""

import functools
import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lif_tpu
from lif_tpu_torch.examples import multiview_demo as tmv
from lif_tpu_torch.examples import render_sfmoma as trs
from lif_tpu_torch.io.decode import decode_image

from .scenes import smooth_noise

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
W, H = 480, 352
DB_TOL, FRACTION_TOL = 0.05, 1e-4
# above this PSNR (the identity passthrough: an MSE under 1e-10) the two
# values differ only by each package's float32 rounding of the sRGB round
# trip, and agree to no 0.05 dB
EXACT_DB = 100.0
RIGHT_EYE_DB = 45.0  # the right eye's colour after JPEG encoding


@functools.lru_cache(maxsize=None)
def _assets():
    """(jpeg, depth png, w, h): seeded texture with edges, a depth ramp
    behind two near boxes."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    rgb = np.stack([smooth_noise(rng, H, W, octaves=5) for _ in range(3)], -1)
    rgb = 0.6 * rgb + 0.4 * ((np.sin(xx / 3.0) * np.cos(yy / 5.0)) > 0)[
        ..., None]
    disp = 0.15 + 0.35 * smooth_noise(rng, H, W, octaves=3)
    disp[60:200, 80:220] = 0.95
    disp[220:320, 300:420] = 0.7
    buf = io.BytesIO()
    Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(
        buf, "JPEG", quality=95)
    jpeg = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray((np.clip(disp, 0, 1) * 255).astype(np.uint8),
                    mode="L").save(buf, "PNG")
    return jpeg, buf.getvalue(), W, H


def _fake_assets(small=False, scale=1, assets_dir=None):
    return _assets()


def _lif_tpu_example(name):
    """lif_tpu's examples/<name>.py, loaded by file path."""
    spec = importlib.util.spec_from_file_location(
        f"lif_tpu_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def examples(monkeypatch):
    """(lif_tpu's render_sfmoma, lif_tpu's multiview_demo), both
    packages' sfmoma_assets replaced by the synthetic pair, and each
    report unrounded (`round` shadowed in the example modules).
    lif_tpu's render_sfmoma also opens its asset JPEG by path for the
    identity check: that open reads the synthetic JPEG."""
    from PIL import Image

    jrs = _lif_tpu_example("render_sfmoma")
    monkeypatch.setitem(sys.modules, "render_sfmoma", jrs)
    jmv = _lif_tpu_example("multiview_demo")
    for mod in (jrs, trs):
        monkeypatch.setattr(mod, "sfmoma_assets", _fake_assets)
        monkeypatch.setattr(mod, "round", lambda x, n=None: x,
                            raising=False)
    real_open = Image.open

    def open_asset(fp, *args, **kw):
        if isinstance(fp, str) and fp.endswith("/public/assets/rgb.jpg"):
            fp = io.BytesIO(_assets()[0])
        return real_open(fp, *args, **kw)

    monkeypatch.setattr(Image, "open", open_asset)
    return jrs, jmv


def _report(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "PASS", lines[-3:]
    return json.loads(lines[-2])


@pytest.mark.parametrize("mode", ["raycast", "fast"])
def test_render_sfmoma_matches_lif_tpu(examples, tmp_path, capsys, mode):
    """render_sfmoma's main in both packages: the same report keys, the
    PSNRs within 0.05 dB, coverage and parallax within 1e-4, the same
    PNGs written."""
    jrs, _ = examples
    assert jrs.main(["--out", str(tmp_path / "j"), "--mode", mode]) == 0
    want = _report(capsys)
    assert trs.main(["--out", str(tmp_path / "t"), "--mode", mode,
                     "--device", "cpu"]) == 0
    got = _report(capsys)
    assert got.keys() == want.keys()
    for key, value in want.items():
        if key == "mode":
            assert got[key] == value
        elif key.endswith("_dB"):
            assert (abs(got[key] - value) <= DB_TOL
                    or min(got[key], value) > EXACT_DB), (key, got[key],
                                                          value)
        elif key != "novel_render_s":
            assert abs(got[key] - value) <= FRACTION_TOL, (key, got[key],
                                                           value)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    for name in names:
        a, b = (decode_image((tmp_path / d / name).read_bytes())
                .astype(np.int16) for d in ("j", "t"))
        assert a.shape == b.shape == (H, W, 3)
        assert (np.abs(a - b) > 1).mean() <= 1e-3, name


def test_build_stereo_lif_matches_lif_tpu(examples):
    """build_stereo_lif in both packages: each LIF loads in lif_tpu with
    the same left view and orbit center. The right eye each synthesizes (a
    fast view and its solved depth, 2e-6 apart before encoding) is
    quantized to 8 bits, where values on a level's edge round apart (2% of
    the colour values, 13% of the depth texels here): its depth within one
    level everywhere, its colour, which the JPEG encoder then spreads over
    8x8 blocks, at least 45 dB from lif_tpu's in linear light."""
    _, jmv = examples
    views = []
    for data in (jmv.build_stereo_lif(), tmv.build_stereo_lif(device="cpu")):
        res = lif_tpu.load_lif_file(data)
        assert len(res.projectors) == 2
        views.append(res)
    (jl, jr), (tl, tr) = (v.projectors for v in views)
    assert np.array_equal(np.asarray(jl.rgb), np.asarray(tl.rgb))
    assert np.array_equal(np.asarray(jl.disp), np.asarray(tl.disp))
    assert np.abs(np.asarray(jr.disp) - np.asarray(tr.disp)).max() <= (
        1.0 / 255 + 1e-6)
    mse = np.mean((np.asarray(jr.rgb) - np.asarray(tr.rgb)) ** 2)
    assert 10 * np.log10(1.0 / mse) >= RIGHT_EYE_DB
    np.testing.assert_allclose(views[1].orbit_center, views[0].orbit_center)


def test_multiview_demo_matches_lif_tpu(examples, tmp_path, capsys,
                                        monkeypatch):
    """multiview_demo's main in both packages on one stereo LIF (lif_tpu's
    build_stereo_lif, which the test above holds the port's to): the same
    steps print and the same PNGs are written, each within one 8-bit level
    of lif_tpu's at all but 0.1% of the pixels; the orbit frames, which
    take the two-phase rotated tier at this width, at all but 0.5% (its
    bracket march's sensitivity, ROADMAP section 3); the billboard mode at
    all but 15% (lif_tpu's jitted forward_splat flips 2-11% of its hits
    against the eager one the port is held to, tests/test_torch_splat.py)."""
    _, jmv = examples
    lif = jmv.build_stereo_lif()
    for mod in (jmv, tmv):
        monkeypatch.setattr(mod, "build_stereo_lif",
                            lambda small=False, scale=1, device=None: lif)
    assert jmv.main(["--out", str(tmp_path / "j")]) == 0
    want = capsys.readouterr().out.splitlines()
    assert tmv.main(["--out", str(tmp_path / "t"), "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[1:] == want[1:] and got[-1] == "PASS"
    names = sorted(str(p.relative_to(tmp_path / "j"))
                   for p in (tmp_path / "j").rglob("*.png"))
    assert names == sorted(str(p.relative_to(tmp_path / "t"))
                           for p in (tmp_path / "t").rglob("*.png"))
    assert len(names) == 2 + 1 + 4 + 8
    for name in names:
        a, b = (decode_image((tmp_path / d / name).read_bytes())
                .astype(np.int16) for d in ("j", "t"))
        off = (np.abs(a - b) > 1).any(-1).mean()
        gate = (0.15 if "billboard" in name else
                5e-3 if name.startswith("orbit") else 1e-3)
        assert off <= gate, (name, off)


def test_examples_run_as_modules_without_jax(tmp_path):
    """The port's examples import neither jax nor lif_tpu: each runs as a
    module in a fresh interpreter where both imports fail, on the CPU;
    without the SFMoMA assets render_sfmoma fails naming the file."""
    import subprocess

    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['lif_tpu'] = None\n"
        "import runpy\n"
        "sys.argv = ['render_sfmoma', '--out', sys.argv[1], '--device', "
        "'cpu', '--assets', sys.argv[1]]\n"
        "runpy.run_module('lif_tpu_torch.examples.render_sfmoma', "
        "run_name='__main__')\n"
    )
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert "rgb.jpg" in res.stderr and "FileNotFoundError" in res.stderr
    assert "ModuleNotFoundError" not in res.stderr
    assert "import of jax halted" not in res.stderr
