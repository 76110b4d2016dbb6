"""K11 (depthwise 3×3) and K12 (small-channel K×K conv): the twins against the Pallas kernels.

* K11: ``depthwise_fwd_plain`` against ``_pallas_depthwise_fwd`` (2e-5; in bf16
  within two bf16 half-ulps of the largest output and at least 99% of the
  elements equal to the bit, the contract the card kernel is held to), and the
  backward of ``DepthwiseConvFn`` on the CPU (dx = the forward twin on g with
  the flipped kernel, dw = ``depthwise_dw_plain``) against
  ``_pallas_depthwise_fwd(g, flipped w)`` and ``_pallas_depthwise_dw`` (2e-4).
* K12: ``conv_small_c_plain`` against ``_pallas_conv_fwd`` (3e-5), and the
  backward of ``ConvSmallCFn`` on the CPU (``conv_small_c_bwd_plain``) against
  ``_pallas_conv_bwd`` (3e-4).

The Pallas kernels run in interpret mode, loaded from ``tools/negative_results/``
by path; shapes and tolerances are those of ``tests/test_ops.py``. Beside them,
both Functions' CPU gradients against autograd of ``F.conv2d``, and the domain
rule of ``conv_small_c`` at the model's OutHead sites.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as tF

from cenet_tpu_torch.ops import depthwise as DW
from cenet_tpu_torch.ops import smallc_conv as SC
from torch_parity import jit_bound


def _negative_result(mod):
    path = os.path.join(os.path.dirname(__file__), "..", "tools", "negative_results", f"{mod}.py")
    spec = importlib.util.spec_from_file_location(f"torch_port_negative_results_{mod}", path)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


@pytest.fixture(scope="module")
def dwmod():
    return _negative_result("depthwise")


@pytest.fixture(scope="module")
def scmod():
    return _negative_result("smallc_conv")


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _assert(got, want, tol, name):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("shape,dil", [((2, 16, 16, 8), 1), ((1, 14, 14, 20), 2), ((2, 9, 11, 5), 3)])
def test_depthwise_fwd_twin_matches_pallas(dwmod, shape, dil):
    rng = np.random.default_rng(shape[-1] + dil)
    x, w = _rand(rng, *shape), _rand(rng, 3, 3, 1, shape[-1])
    want = jit_bound(dwmod._pallas_depthwise_fwd, dilation=dil, interpret=True)(jnp.asarray(x), jnp.asarray(w))
    _assert(DW.depthwise_fwd_plain(torch.from_numpy(x), torch.from_numpy(w), dil), want, 2e-5, "fwd")


@pytest.mark.parametrize("shape,dil", [((2, 9, 13, 16), 1), ((1, 14, 12, 8), 5)])
def test_depthwise_fwd_twin_rounds_as_pallas_in_bf16(dwmod, shape, dil):
    rng = np.random.default_rng(3 * shape[-1] + dil)
    x = torch.from_numpy(_rand(rng, *shape)).bfloat16()
    w = _rand(rng, 3, 3, 1, shape[-1])
    got = DW.depthwise_fwd_plain(x, torch.from_numpy(w), dil)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    want = jit_bound(dwmod._pallas_depthwise_fwd, dilation=dil, interpret=True)(xj, jnp.asarray(w))
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    a, b = got.float().numpy(), np.asarray(want, np.float32)
    assert np.abs(a - b).max() <= 2 * 2.0**-8 * np.abs(b).max()
    assert (a == b).mean() >= 0.99


@pytest.mark.parametrize("shape,dil", [((2, 12, 12, 8), 1), ((1, 14, 10, 20), 2)])
def test_depthwise_function_backward_matches_pallas(dwmod, shape, dil):
    rng = np.random.default_rng(shape[-1] + 10 * dil)
    x, w, g = _rand(rng, *shape), _rand(rng, 3, 3, 1, shape[-1]), _rand(rng, *shape)
    c = shape[-1]
    wf = jnp.flip(jnp.flip(jnp.asarray(w).reshape(3, 3, c), 0), 1)
    want_dx = jit_bound(dwmod._pallas_depthwise_fwd, dilation=dil, interpret=True)(jnp.asarray(g), wf)
    want_dw = jit_bound(dwmod._pallas_depthwise_dw, dilation=dil, interpret=True)(jnp.asarray(x), jnp.asarray(g))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    DW.DepthwiseConvFn.apply(xt, wt, dil).backward(torch.from_numpy(g))
    _assert(xt.grad, want_dx, 2e-4, "dx")
    _assert(wt.grad, np.asarray(want_dw).reshape(w.shape), 2e-4, "dw")


@pytest.mark.parametrize("shape,k,cout", [((2, 16, 16, 8), 5, 16), ((1, 20, 20, 1), 5, 32), ((2, 12, 10, 32), 3, 32)])
def test_smallc_fwd_twin_matches_pallas(scmod, shape, k, cout):
    rng = np.random.default_rng(k * cout)
    x, w = _rand(rng, *shape), _rand(rng, k, k, shape[-1], cout)
    want = jit_bound(scmod._pallas_conv_fwd, padding=k // 2, interpret=True)(jnp.asarray(x), jnp.asarray(w))
    _assert(SC.conv_small_c_plain(torch.from_numpy(x), torch.from_numpy(w), k // 2), want, 3e-5, "fwd")


@pytest.mark.parametrize("shape,k,cout", [((2, 12, 12, 8), 5, 16), ((1, 10, 14, 1), 3, 8), ((2, 16, 16, 64), 3, 64)])
def test_smallc_function_backward_matches_pallas(scmod, shape, k, cout):
    rng = np.random.default_rng(k * cout + 1)
    x, w, g = _rand(rng, *shape), _rand(rng, k, k, shape[-1], cout), _rand(rng, *shape[:3], cout)
    want_dx, want_dw = jit_bound(scmod._pallas_conv_bwd, padding=k // 2, interpret=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(g))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    SC.ConvSmallCFn.apply(xt, wt, k // 2).backward(torch.from_numpy(g))
    _assert(xt.grad, want_dx, 3e-4, "dx")
    _assert(wt.grad, want_dw, 3e-4, "dw")


def _conv2d_grads(x_nchw, w_oihw, g_nhwc, **kw):
    x, w = x_nchw.clone().requires_grad_(), w_oihw.clone().requires_grad_()
    tF.conv2d(x, w, **kw).permute(0, 2, 3, 1).backward(g_nhwc)
    return x.grad.permute(0, 2, 3, 1), w.grad


def test_functions_backward_match_conv2d_autograd():
    """On NCHW tensors handed over as NHWC views, as the model's sites hand them."""
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(2, 12, 9, 11, generator=g), torch.randn(12, 1, 3, 3, generator=g)
    gy = torch.randn(2, 9, 11, 12, generator=g)
    want_dx, want_dw = _conv2d_grads(x, w, gy, padding=2, dilation=2, groups=12)
    xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
    DW.depthwise_conv3x3(xt.permute(0, 2, 3, 1), wt.permute(2, 3, 1, 0), 2).backward(gy)
    torch.testing.assert_close(xt.grad.permute(0, 2, 3, 1), want_dx, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(wt.grad, want_dw, atol=1e-5, rtol=1e-5)
    x, w = torch.randn(1, 16, 12, 10, generator=g), torch.randn(24, 16, 5, 5, generator=g)
    gy = torch.randn(1, 12, 10, 24, generator=g)
    want_dx, want_dw = _conv2d_grads(x, w, gy, padding=2)
    xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
    SC.ConvSmallCFn.apply(xt.permute(0, 2, 3, 1), wt.permute(2, 3, 1, 0), 2).backward(gy)
    torch.testing.assert_close(xt.grad.permute(0, 2, 3, 1), want_dx, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(wt.grad, want_dw, atol=1e-4, rtol=1e-4)


# (x NHWC, w HWIO, padding, stride): the OutHead convolutions of the Synapse
# preset at batch 8, and rb.0.conv1 (Cin = 1) which stays outside
OUTHEAD = {
    "rb.0.conv2": ((8, 224, 224, 32), (5, 5, 32, 32), 2, 1),
    "up.1": ((8, 112, 112, 64), (3, 3, 64, 32), 1, 1),
    "out.0.conv1": ((8, 112, 112, 64), (3, 3, 64, 64), 1, 1),
    "out.0.conv2": ((8, 112, 112, 64), (3, 3, 64, 64), 1, 1),
    "rb.0.conv1": ((8, 224, 224, 1), (5, 5, 1, 32), 2, 1),
}


def test_smallc_domain_at_the_outhead_sites():
    assert {name: SC.in_domain(*spec) for name, spec in OUTHEAD.items()} == {
        "rb.0.conv2": True, "up.1": True, "out.0.conv1": True, "out.0.conv2": True, "rb.0.conv1": False}
    x, w, p, _ = OUTHEAD["up.1"]
    assert not SC.in_domain(x, w, p, stride=2)
    assert not SC.in_domain(x, w, 0)  # padding other than k // 2
    assert not SC.in_domain((8, 56, 56, 64), w, p)  # H·W < 112²
    assert not SC.in_domain((8, 112, 112, 48), (3, 3, 48, 32), p)  # Cin outside {8, 16, 32, 64}
    assert not SC.in_domain(x, (3, 3, 64, 36), p)  # Cout % 8 != 0
    assert SC.in_domain((1, 112, 113, 64), w, p)  # W % 8 is a TPU tiling rule, dropped
    # outside the domain the function is F.conv2d
    gen = torch.Generator().manual_seed(1)
    xs, ws = torch.randn(1, 9, 7, 3, generator=gen), torch.randn(3, 3, 3, 8, generator=gen)
    want = tF.conv2d(xs.permute(0, 3, 1, 2), ws.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(SC.conv_small_c(xs, ws, 1), want)
