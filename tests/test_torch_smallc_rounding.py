"""K12's forward rounding contract in bf16: its twin against the Pallas kernel.

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
The Pallas kernel is loaded from ``tools/negative_results/`` by path, as
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
