"""K11's dw cut and ordered sum, and K10's in-kernel table rounding, against the Pallas kernels.

* K11 dw: a torch mirror of the card kernel's partition (the cuts that
  ``csrc/depthwise_conv.cu::dw_plan`` makes: the positions in parts, by tasks
  of ``xt`` positions on the channels-last route and by strips of rows on the
  plane route, each part's partial in fp32, then the partials added in part
  order) against ``_pallas_depthwise_dw`` in interpret mode within 2e-4, at
  small shapes of each layout (both channels-last, a channel slice, both
  NCHW, and the two mixed layouts, which take the plane route) and several
  dilations, in one part and in many parts and strips. The mirror drops every
  position that the cut leaves out, so a cut that does not cover the map
  fails here.
* K10: the twin fed the fp32 tables of ``make_rotary_tables`` (the kernel
  rounds them to x's dtype itself) against ``_rotary_kernel`` through
  ``pl.pallas_call(interpret=True)`` on tables cast first, as the JAX wrapper
  casts them: equal to the bit in bf16 at every head dim the card tests use.

The Pallas dw kernel is loaded from ``tools/negative_results/`` by path, as
``tests/test_torch_conv_kernels.py`` does.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cenet_tpu.ops import rotary as jrot
from cenet_tpu_torch.ops import depthwise as DW
from cenet_tpu_torch.ops import rotary as trot
from torch_parity import jit_bound


@pytest.fixture(scope="module")
def dwmod():
    path = os.path.join(os.path.dirname(__file__), "..", "tools", "negative_results", "depthwise.py")
    spec = importlib.util.spec_from_file_location("torch_port_negative_results_depthwise_order", path)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def _nhwc(rng, shape, layout):
    """fp32 NHWC values in the layout the backward hands over: channels-last,
    the view of NCHW memory, or a channel slice of a wider channels-last tensor."""
    b, h, w, c = shape
    if layout == "cl":
        return torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32))
    if layout == "nchw":
        return torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(np.float32)).permute(0, 2, 3, 1)
    wide = torch.from_numpy(rng.standard_normal((b, h, w, c + 7)).astype(np.float32))
    return wide[..., 3:3 + c]


def _ceil(a, b):
    return -(-a // b)


def dw_mirror(x, g, dilation, route, per, xt=8):
    """The card kernel's sum on a cut of ``per`` tasks (channels-last) or rows
    (planes) a part: each part's partial over its positions in fp32, then the
    partials in part order. Channels-last: position (b, y, x) is in task
    ((b·H + y)·dilation + x mod dilation)·tiles + (x div dilation) div xt, part
    = task div per. Planes: part = b·strips + y div per. Returns dw and the
    part count."""
    b, h, w, c = x.shape
    prods = torch.stack([xs.float() * g.float() for xs in DW._shifted(x, dilation)])  # (9, B, H, W, C)
    bi, y, xc = torch.meshgrid(torch.arange(b), torch.arange(h), torch.arange(w), indexing="ij")
    if route == "planes":
        part, parts = bi * _ceil(h, per) + y // per, b * _ceil(h, per)
    else:
        tiles = _ceil(_ceil(w, dilation), xt)
        task = ((bi * h + y) * dilation + xc % dilation) * tiles + (xc // dilation) // xt
        part, parts = task // per, _ceil(b * h * dilation * tiles, per)
    dw = torch.zeros(9, c)
    for p in range(parts):
        dw = dw + prods[:, part == p].sum(dim=1)
    return dw.reshape(3, 3, c), parts


# targets: the cut, {"per": tasks or rows a part}; the first takes every
# position in one part
@pytest.mark.parametrize("shape,dil,xl,gl,targets,route", [
    ((2, 9, 11, 16), 1, "cl", "cl", {"per": 2 * 9 * 2}, "channels_last"),
    ((2, 9, 10, 20), 2, "slice", "cl", {"per": 3}, "channels_last"),
    ((2, 13, 9, 5), 3, "nchw", "nchw", {"per": 4}, "planes"),
    ((1, 12, 10, 24), 5, "nchw", "cl", {"per": 5}, "planes"),
    ((2, 10, 7, 12), 4, "cl", "nchw", {"per": 3}, "planes"),
])
def test_dw_cut_and_ordered_sum_match_pallas(dwmod, shape, dil, xl, gl, targets, route):
    rng = np.random.default_rng(sum(shape) + dil)
    x, g = _nhwc(rng, shape, xl), _nhwc(rng, shape, gl)
    got, parts = dw_mirror(x, g, dil, route, targets["per"])
    want = jit_bound(dwmod._pallas_depthwise_dw, dilation=dil, interpret=True)(
        jnp.asarray(x.contiguous().numpy()), jnp.asarray(g.contiguous().numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    assert (parts == 1) == (route == "channels_last" and dil == 1)


def test_rotary_twin_rounds_fp32_tables_as_pallas():
    """bf16 x at D = 8 … 128 and an odd N: the twin on fp32 tables equals
    ``_rotary_kernel`` on tables cast to bf16 first, to the bit."""
    rng = np.random.default_rng(10)
    b, h, n = 2, 3, 29
    for d in (8, 16, 32, 64, 128):
        x = torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(np.float32)).bfloat16()
        cos, sin = trot.make_rotary_tables(n, d)
        cos, sin = 3 * cos, 2 * sin  # entries that bf16 rounds
        got = trot.apply_rotary_emb_kernel(x, cos, sin)
        xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16).reshape(b * h, n, d)
        cj, sj = (jnp.asarray(t.numpy()).astype(jnp.bfloat16) for t in (cos, sin))
        want = pl.pallas_call(jrot._rotary_kernel, out_shape=jax.ShapeDtypeStruct((b * h, n, d), jnp.bfloat16),
                              interpret=True)(xj, cj, sj)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32).reshape(b, h, n, d))
