"""Scene fitting (lif_tpu_torch.train) against lif_tpu.train (CPU).

The fit of tests/test_train.py::_setup (24x32, four poses, the start a
clipped N(0, 0.15) perturbation of the true disparity, targets from the
soft sweep) goes through lif_tpu (JAX and optax on the CPU) and through
the port (torch.optim.Adam on CPU tensors). Gates: the losses, the
Rodrigues map and the clip's derivative equal lif_tpu's to float32
rounding (rtol 1e-5 / 1e-6); one train step's gradients within 1e-4 of
the largest gradient (tests/test_torch_sweep.py's gate) and its updated
parameters within 1e-5 (lr / 300); a 5-step loss history within rtol
1e-5 on poses off the texel lattice. On
_setup's own poses, whose pose 0 reads the source exactly at texel
centres, the first two losses agree to 1e-5 and the next three to 1e-2:
there the pose gradient is one-sided, the packages' roundings pick
different sides in a few rows, and Adam carries that into steps 3-5
(lif_tpu's fit itself is the same in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lif_tpu_torch
from lif_tpu.train import fit as jfit
from lif_tpu.train import losses as jlosses
from lif_tpu_torch.train import fit as tfit
from lif_tpu_torch.train import losses as tlosses

from .test_train import _setup

torch.set_num_threads(1)


def _problem(rng, off_lattice=True, b=4):
    """_setup's problem for both packages: (lif_tpu's bad projector, the
    port's, positions, rotations, lif_tpu's camera, the port's, targets,
    true disparity); off_lattice moves every pose 1 mm in y."""
    proj_bad, positions, rotations, cam, targets, true_disp = _setup(rng, b=b)
    if off_lattice:
        positions = positions + np.array([0.0, 0.001, 0.0])
    tp = lif_tpu_torch.projector_from_reference(proj_bad, device="cpu")
    tcam = lif_tpu_torch.Camera.create(cam.width, cam.height,
                                       focal_px=float(cam.focal_px))
    return (proj_bad, tp, positions, rotations, cam, tcam,
            np.asarray(targets), true_disp)


def test_losses_match_lif_tpu(rng):
    a = rng.random((4, 6, 3)).astype(np.float32)
    b = rng.random((4, 6, 3)).astype(np.float32)
    for name in ("l2_loss", "l1_loss", "psnr"):
        want = float(getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b)))
        got = float(getattr(tlosses, name)(torch.tensor(a), torch.tensor(b)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    zero = torch.zeros(4, 4)
    assert float(tlosses.psnr(zero, zero)) > 100.0
    np.testing.assert_allclose(float(tlosses.psnr(zero, zero + 0.1)), 20.0,
                               atol=1e-4)


@pytest.mark.parametrize("w", [[0.0, 0.0, 0.0], [0.3, -0.2, 0.5]])
def test_rodrigues_value_and_jacobian(w):
    """_rodrigues and its Jacobian equal lif_tpu's, at w = 0 (where the
    small-angle guard theta = sqrt(|w|^2 + 1e-12) makes R = I exactly and
    the Jacobian the cross-product generators) and at a generic w."""
    wj = jnp.asarray(w, jnp.float32)
    wt = torch.tensor(w, dtype=torch.float32)
    np.testing.assert_allclose(tfit._rodrigues(wt).numpy(),
                               np.asarray(jfit._rodrigues(wj)), atol=1e-6)
    jac_t = torch.autograd.functional.jacobian(tfit._rodrigues, wt)
    jac_j = jax.jacobian(jfit._rodrigues)(wj)
    np.testing.assert_allclose(jac_t.numpy(), np.asarray(jac_j), atol=1e-6)
    if not any(w):
        assert torch.equal(tfit._rodrigues(wt), torch.eye(3))


def test_clip_tie_rule_matches_jnp_clip():
    """clip01's derivative is jnp.clip's: 1 inside, 0 outside and 0.5 at
    exactly 0 or 1 (torch.clamp gives 1 there); the value is clamp's."""
    x = np.array([-0.5, 0.0, 0.3, 1.0, 1.5, 0.0], np.float32)
    weights = np.arange(1.0, 7.0, dtype=np.float32)
    want = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0) * weights))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = tfit.clip01(xt)
    (out * torch.tensor(weights)).sum().backward()
    assert np.array_equal(xt.grad.numpy(), np.asarray(want))
    assert np.array_equal(xt.grad.numpy(),
                          weights * np.array([0, 0.5, 1, 0.5, 0, 0.5]))
    assert torch.equal(out, torch.tensor(x).clamp(0.0, 1.0))
    xc = torch.tensor(x, requires_grad=True)
    (xc.clamp(0.0, 1.0) * torch.tensor(weights)).sum().backward()
    assert xc.grad[1] == weights[1]  # torch.clamp's tie rule differs


def _jax_state(proj_bad, cam, learning_rate):
    baseline = jnp.asarray(proj_bad.baseline, jnp.float32)
    static = dict(
        rgb=jnp.asarray(proj_bad.rgb), mask=jnp.asarray(proj_bad.mask),
        layer_res=jnp.asarray(proj_bad.layer_res),
        invz_min=jnp.asarray(proj_bad.invz_min, jnp.float32) / baseline,
        invz_max=jnp.asarray(proj_bad.invz_max, jnp.float32) / baseline,
        focal=jnp.asarray(proj_bad.focal), skew=jnp.asarray(proj_bad.skew),
        f2=jnp.asarray(cam.focal_px, jnp.float32),
        skew2=jnp.asarray(cam.skew, jnp.float32),
    )
    params = jfit.FitParams(jnp.asarray(proj_bad.disp),
                            jnp.zeros(3, jnp.float32),
                            jnp.zeros(3, jnp.float32))
    opt = optax.adam(learning_rate)
    return static, params, opt


def test_train_step_matches_lif_tpu(rng):
    """One train step: the loss, the gradients of the three parameters
    (against jax.value_and_grad of lif_tpu's loss) and the parameters
    after the Adam update (against optax.adam's), on poses off the texel
    lattice."""
    proj_bad, tp, positions, rotations, cam, tcam, targets, _ = _problem(rng)
    rel_p, rel_r = tfit.relative_poses(tp, positions, rotations)
    static, params, opt = _jax_state(proj_bad, cam, 3e-3)

    def loss_fn(prm):
        pred = jfit.render_with_params(prm, static, jnp.asarray(rel_p),
                                       jnp.asarray(rel_r), cam.width,
                                       cam.height, 1, 12)
        return jlosses.l2_loss(pred, jnp.asarray(targets))

    jl, jg = jax.value_and_grad(loss_fn)(params)
    updates, _ = opt.update(jg, opt.init(params), params)
    jnew = optax.apply_updates(params, updates)

    zero = torch.zeros(3)
    model = tfit.SceneFit(tfit.FitParams(tp.disp, zero, zero),
                          tfit.static_projector(tp, tcam), cam.width,
                          cam.height, 1, 12)
    adam = torch.optim.Adam(model.parameters(), lr=3e-3)
    loss = tfit.make_train_step(model, adam)(
        torch.tensor(rel_p), torch.tensor(rel_r), torch.tensor(targets))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for got, want, new, jn in zip(
            (model.disp.grad, model.position_delta.grad,
             model.rotation_delta.grad), jg, model.params(), jnew):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() < 1e-4 * np.abs(want).max()
        # Adam's first step moves each entry by lr * g / (|g| + 1e-8): where
        # |g| is near 1e-8 the gradient's last bits set the step's share
        assert np.abs(new.numpy() - np.asarray(jn)).max() < 1e-5


@pytest.mark.parametrize("off_lattice", [True, False])
def test_five_step_losses_match_lif_tpu(rng, off_lattice):
    """fit_projector's 5-step loss history and fitted parameters against
    lif_tpu's fit_projector (see the module note for the two gates)."""
    proj_bad, tp, positions, rotations, cam, tcam, targets, _ = _problem(
        rng, off_lattice)
    jparams, jh = jfit.fit_projector(proj_bad, positions, rotations, cam,
                                     targets, steps=5, learning_rate=3e-3,
                                     num_steps=12)
    tparams, th = tfit.fit_projector(tp, positions, rotations, tcam, targets,
                                     steps=5, learning_rate=3e-3, num_steps=12)
    jh, th = np.array(jh), np.array(th)
    if off_lattice:
        np.testing.assert_allclose(th, jh, rtol=1e-5)
        for got, want in zip(tparams, jparams):
            assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5
    else:
        np.testing.assert_allclose(th[:2], jh[:2], rtol=1e-5)
        np.testing.assert_allclose(th[2:], jh[2:], rtol=1e-2)


def test_fit_reduces_loss(rng):
    """tests/test_train.py::test_fit_reduces_loss's gates on the port: the
    photometric loss falls below 0.85 of the first within 80 steps, and
    the fitted disparity is closer to the truth than the start."""
    _, tp, positions, rotations, _, tcam, targets, true_disp = _problem(
        rng, off_lattice=False)
    start = tp.disp[0].clone()
    params, history = tfit.fit_projector(
        tp, positions, rotations, tcam, targets, steps=80,
        learning_rate=3e-3, num_steps=12)
    assert min(history[-5:]) < history[0] * 0.85, history
    err0 = np.abs(start.numpy() - true_disp).mean()
    err1 = np.abs(np.clip(params.disp[0].numpy(), 0, 1) - true_disp).mean()
    assert err1 < err0
    assert torch.equal(tp.disp[0], start)  # the projector is not written


def test_fit_params_carry_across_and_mesh_raises(rng):
    """fit_params_from_arrays carries lif_tpu's FitParams into the port
    (float32 tensors on the device asked for); render_with_params on them
    equals lif_tpu's render; a mesh= that is not a DeviceMesh raises
    TypeError (the sharded fit itself: tests/test_torch_parallel.py)."""
    proj_bad, tp, positions, rotations, cam, tcam, targets, _ = _problem(rng)
    jparams = jfit.FitParams(jnp.asarray(proj_bad.disp),
                             jnp.asarray([0.01, -0.02, 0.005], jnp.float32),
                             jnp.asarray([0.002, 0.01, -0.003], jnp.float32))
    tparams = tfit.fit_params_from_arrays(*jparams, device="cpu")
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in tparams)
    rel_p, rel_r = tfit.relative_poses(tp, positions, rotations)
    static, _, _ = _jax_state(proj_bad, cam, 3e-3)
    want = np.asarray(jfit.render_with_params(
        jparams, static, jnp.asarray(rel_p), jnp.asarray(rel_r), cam.width,
        cam.height, 1, 12))
    got = tfit.render_with_params(
        tparams, tfit.static_projector(tp, tcam), torch.tensor(rel_p),
        torch.tensor(rel_r), cam.width, cam.height, 1, 12)
    assert np.abs(got.numpy() - want).max() < 1e-5
    with pytest.raises(TypeError, match="DeviceMesh"):
        tfit.fit_projector(tp, positions, rotations, tcam, targets, steps=1,
                           mesh=object())
