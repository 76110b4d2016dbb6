"""K12's rounding contract in bf16: its twins against the Pallas kernels.

``conv_small_c_plain`` (the twin the tensor-core K12 forward is held to on the
card) against ``_pallas_conv_fwd`` in interpret mode, both on the same bf16 x
and bf16-rounded weights: products and sums in fp32 and one rounding of each
output to bf16, so they agree within two bf16 half-ulps of the output's
largest element (2·2^-8·max|y|: the output's rounding, and sums that round to
the other side where the two add the taps in another order), and at least 99%
of the elements are equal to the bit (the twin reads 100% here; one that
rounds the sum after every tap reads 30–39% and fails). At Cin 8 (the Pallas kernel packs
several taps into one contraction, the card kernel two taps into one 16-deep
step) and Cin 32, kernels 3 and 5, maps that are not multiples of the tiles.
The backward's twin ``conv_small_c_bwd_plain`` (the tensor-core dx and dw
are held to it on the card) against ``_pallas_conv_bwd`` on bf16 x and g and
fp32 weights (rounded to bf16 by both): dx under the same contract as the
forward (g and the flipped weights as bf16 operands of fp32 sums, one
rounding), dw within 1e-4 of its largest element (exact bf16 products summed
in fp32 in another order), at Cin 8 and 32, kernels 5 and 3, ragged maps.
The Pallas kernels are loaded from ``tools/negative_results/`` by path, as
``tests/test_torch_conv_kernels.py`` does.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cenet_tpu_torch.ops import smallc_conv as SC
from torch_parity import jit_bound


@pytest.fixture(scope="module")
def scmod():
    path = os.path.join(os.path.dirname(__file__), "..", "tools", "negative_results", "smallc_conv.py")
    spec = importlib.util.spec_from_file_location("torch_port_negative_results_smallc_conv_rounding", path)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


@pytest.mark.parametrize("shape,k,cout", [((1, 18, 20, 8), 5, 16), ((1, 17, 24, 32), 3, 24)])
def test_smallc_fwd_twin_rounds_as_pallas_in_bf16(scmod, shape, k, cout):
    rng = np.random.default_rng(k * cout + shape[-1])
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
    w = torch.from_numpy((0.2 * rng.standard_normal((k, k, shape[-1], cout))).astype(np.float32)).bfloat16()
    got = SC.conv_small_c_plain(x, w, k // 2)
    xj, wj = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (x, w))
    want = jit_bound(scmod._pallas_conv_fwd, padding=k // 2, interpret=True)(xj, wj)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    a, w_ = got.float().numpy(), np.asarray(want, np.float32)
    assert np.abs(a - w_).max() <= 2 * 2.0**-8 * np.abs(w_).max()
    assert (a == w_).mean() >= 0.99


@pytest.mark.parametrize("shape,k,cout", [((1, 13, 18, 8), 5, 16), ((1, 11, 17, 32), 3, 32)])
def test_smallc_bwd_twin_rounds_as_pallas_in_bf16(scmod, shape, k, cout):
    rng = np.random.default_rng(7 * k + cout + shape[-1])
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((*shape[:3], cout)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((0.2 * rng.standard_normal((k, k, shape[-1], cout))).astype(np.float32))
    dx, dw = SC.conv_small_c_bwd_plain(x, w, g, k // 2)
    xj, gj = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (x, g))
    want_dx, want_dw = jit_bound(scmod._pallas_conv_bwd, padding=k // 2, interpret=True)(xj, jnp.asarray(w.numpy()), gj)
    assert dx.dtype == torch.bfloat16 and str(want_dx.dtype) == "bfloat16"
    assert dw.dtype == torch.float32 and str(want_dw.dtype) == "float32"
    a, b = dx.float().numpy(), np.asarray(want_dx, np.float32)
    assert np.abs(a - b).max() <= 2 * 2.0**-8 * np.abs(b).max()
    assert (a == b).mean() >= 0.99
    want_dw = np.asarray(want_dw)
    assert np.abs(dw.numpy() - want_dw).max() <= 1e-4 * np.abs(want_dw).max()
