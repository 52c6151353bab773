"""Hamiltonian calibration through quandary_tpu_torch
(quandary_tpu_torch/calibration.py) against examples/example_calibration.py
of the JAX package: the stack cotangents of the stream route in user
position.

1. The operator parts are bit-equal to the example's, and the misfit
   gradient d loss / d xi (which reaches xi only through the operator
   stack) agrees with the JAX example's make_stream_propagate in interpret
   mode at 'highest' to 1e-4 relative (f32 over 200 steps).
2. The example's Kerr recovery runs through the port on the CPU to its own
   accuracy, relative error < 1e-4.
3. The streamK route in user position: the JAX example asserts a gradient
   of exactly 0 (stack cotangents are zero by that kernel's contract). In
   the port the streamK result is not connected to the stacks in the
   autograd graph, so asking for the gradient RAISES (torch: the loss does
   not require grad); it never returns a silent 0.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from quandary_tpu.ops import pallas_stream  # noqa: E402
from quandary_tpu_torch import calibration  # noqa: E402
from quandary_tpu_torch.ops import streamk  # noqa: E402


def _example():
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "example_calibration.py")
    spec = importlib.util.spec_from_file_location("example_calibration",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_misfit_gradient_matches_jax_stream(monkeypatch):
    monkeypatch.setattr(pallas_stream, "_PRECISION_MODE", "highest")
    for a, b in zip(_example().build_parts(4), calibration.kerr_parts(4)):
        assert np.array_equal(a, b)
    cal = calibration.KerrCalibration(device="cpu")
    xi = calibration.XI_TRUE * 1.05

    n, P = 4, 128
    kerr, re_d, im_d = calibration.kerr_parts(n)
    prop = pallas_stream.make_stream_propagate(
        np.zeros((3, n, n), np.complex64), 0.05, 6, interpret=True)
    x0 = (cal.x0[0].numpy() + 1j * cal.x0[1].numpy()).astype(np.complex64)
    C = jnp.asarray(cal.C.numpy())

    def hist(xi):
        S = jnp.stack([xi * jnp.asarray(kerr, jnp.complex64),
                       jnp.asarray(re_d, jnp.complex64),
                       jnp.asarray(im_d, jnp.complex64)])
        pad = lambda A: jnp.zeros((3, P, P), jnp.float32).at[:, :n, :n].set(A)
        _, h = prop(pad(jnp.real(S)), pad(jnp.imag(S)), jnp.asarray(x0), C)
        return h[::10]

    data = hist(jnp.float32(calibration.XI_TRUE))
    gj = float(jax.grad(lambda x: jnp.sum(jnp.abs(hist(x) - data) ** 2))(
        jnp.float32(xi)))
    gt = cal.grad(xi)
    assert gj != 0.0 and abs(gt - gj) <= 1e-4 * abs(gj), (gt, gj)


def test_kerr_recovery_through_the_port():
    xi, err, iterations = calibration.KerrCalibration(device="cpu").run()
    assert err < 1e-4 and iterations < 30, (xi, err, iterations)


def test_streamk_route_refuses_the_stack_gradient():
    cal = calibration.KerrCalibration(device="cpu")
    with pytest.raises(RuntimeError, match="does not require grad"):
        cal.grad(calibration.XI_TRUE * 1.05,
                 streamk.make_streamk_propagate(0.05, 6))
