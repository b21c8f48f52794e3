"""The port's entry points (lif_tpu_torch.entry) against __graft_entry__.

entry() is one exact-march forward at __graft_entry__.entry()'s shapes
and seed: held to lif_tpu's image and to the float64 reference march.
dryrun_multichip(8, device_type="cpu") runs its sharded fit step on a
(4, 2) (data, tile) mesh and the 256x320 fused render over 8 views on 8
gloo ranks (parallel.launch.run_ranks): every
rank reports the same finite loss and a fused image that does not change
(within 1e-5) when the projector-to-rank order is reversed. The
launcher raises a rank's failure and kills a launch that outlives its
timeout. By default the dry run asks for the cards: without one it
raises before any rank starts, and never carries on on the CPU.
"""

import numpy as np
import pytest

import __graft_entry__ as graft
from lif_tpu_torch import entry
from lif_tpu_torch.parallel.launch import run_ranks

from . import reference_renderer as ref
from . import torch_rank_bodies as bodies


def test_entry_matches_graft_entry(monkeypatch):
    """The same forward as __graft_entry__.entry()'s, on its inputs: >= 60
    dB against lif_tpu's image (tests/test_torch_core.py's gate for the
    exact march) and at least as close as lif_tpu's to the float64
    reference march (tests/reference_renderer.py) at the same 16 steps.
    The inputs are per-texel uniform noise, where the march's crossings
    follow the last bits of each multiply-add: lif_tpu's image, computed
    with XLA's fused multiply-adds, is 62.4 dB from the float64 one (max
    abs 0.39), the port's 78.6 dB (0.021), so the two packages differ by
    more than 1e-5 at 2.7% of the pixels."""
    jfn, jargs = graft.entry()
    want = np.asarray(jfn(*jargs))
    fn, args = entry.entry(device="cpu")
    got = fn(*args)
    assert got.device.type == "cpu" and tuple(got.shape) == want.shape
    got = got.numpy()
    assert ref.psnr(want, got) >= 60.0
    rgb, disp, mask = (t.numpy().astype(np.float64) for t in args[:3])
    layer_res, izmin, izmax, focal, skew, c1, rot = args[3:10]
    layers = [dict(rgb=rgb[i], disp=disp[i], mask=mask[i],
                   res=tuple(layer_res[i]), invz_min=float(izmin[i]),
                   invz_max=float(izmax[i]), focal=float(focal[i]))
              for i in range(len(rgb))]
    monkeypatch.setattr(ref, "NUM_STEPS", 16)
    golden = ref.render_mono_reference(
        layers, skew, c1.astype(np.float64), rot.astype(np.float64),
        0.78 * got.shape[1], skew, got.shape[1], got.shape[0])
    assert ref.psnr(golden, got) >= ref.psnr(golden, want)


def test_entry_defaults_to_the_card(monkeypatch):
    """Without device= the textures go to 'cuda' (torch raises where there
    is none)."""
    import torch

    seen = []
    real = torch.as_tensor

    def spy(*a, **kw):
        seen.append(kw.get("device"))
        return real(*a, **{**kw, "device": "cpu"})

    monkeypatch.setattr(torch, "as_tensor", spy)
    entry.entry()
    assert seen and set(seen) == {"cuda"}


def test_dryrun_multichip_on_eight_ranks():
    records = entry.dryrun_multichip(8, device_type="cpu")
    assert len(records) == 8
    losses = {r["loss"] for r in records}
    assert len(losses) == 1 and np.isfinite(losses.pop())
    for rec in records:
        assert rec["shape"] == (256, 320, 4) and rec["finite"]
        assert rec["order_err"] <= 1e-5


def test_dryrun_multichip_defaults_to_the_card(monkeypatch):
    """dryrun_multichip(n) runs on the cards: with no card it raises, and
    never falls back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)


def test_run_ranks_raises_a_rank_failure():
    """A rank whose body raises stops the launch with its traceback."""
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_ranks(bodies.fail_on_rank_1, 2, backend="gloo",
                  device_type="cpu", timeout_s=120)


def test_run_ranks_kills_a_hung_launch():
    """A rank that never returns (rank 1 waits in a collective rank 0
    never joins) runs into timeout_s: TimeoutError, every rank killed."""
    with pytest.raises(TimeoutError):
        run_ranks(bodies.hang_on_rank_1, 2, backend="gloo",
                  device_type="cpu", timeout_s=10)
