"""K9 (RMSNorm) and K10 (rotary): the port's twins and Functions against the JAX package.

* ``RMSNormFn`` (K9's twin forward, ``_rms_bwd``'s formula backward) against
  ``cenet_tpu.ops.rms_norm.rms_norm`` and its ``jax.grad`` (on the CPU the JAX
  package's own ``_xla_rms`` and ``_rms_bwd``), with and without a weight:
  fp32 within 1e-5, bf16 within 2·2^-8 of max |want|.
* K9's twin against the Pallas bodies ``_rms_kernel`` / ``_rms_weight_kernel``
  and K10's twin against ``_rotary_kernel``, each through
  ``pl.pallas_call(..., interpret=True)`` built here: fp32 within 1e-6, bf16
  within 2·2^-8.
* Plain rotary (both conventions, partial rd) and K10's twin against
  ``apply_rotary_emb``; the de-interleave → K10 → re-interleave composition
  against ``apply_rotary_emb(interleaved=True)``: fp32 within 1e-6.
* ``MultiheadDiffAttn`` with ``use_rotary`` and ``rel_pos`` (the rotary branch,
  and the ``weights + rel_pos`` branch) against the JAX module, weights through
  ``state_dict_from_jax``: fp32 within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cenet_tpu.nn import attention as jatt
from cenet_tpu.ops import rms_norm as jrms
from cenet_tpu.ops import rotary as jrot
from cenet_tpu_torch.nn import attention as tatt
from cenet_tpu_torch.ops import rms_norm as trms
from cenet_tpu_torch.ops import rotary as trot
from torch_parity import jax_init, load_port

BF16_LIM = 2 * 2.0**-8  # two bf16 half-ulps of max |want|


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _pair(a, dtype):
    """The same values as a torch tensor and a JAX array in ``dtype``."""
    t = torch.from_numpy(a).to(dtype)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def _close(got, want, dtype, fp32_tol, name):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    tol = fp32_tol if dtype == torch.float32 else BF16_LIM
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max()), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_weight", [False, True])
def test_rms_norm_function_matches_jax_and_its_grad(dtype, with_weight):
    shape = (2, 3, 37, 40)
    x, xj = _pair(_rand(0, *shape, scale=2.0), dtype)
    g, gj = _pair(_rand(1, *shape), dtype)
    w = torch.from_numpy(_rand(2, shape[-1])) if with_weight else None
    wj = jnp.asarray(w.numpy()) if with_weight else None
    want = jrms.rms_norm(xj, wj, 1e-5)

    def loss(x_, w_):
        return jnp.sum(jrms.rms_norm(x_, w_, 1e-5).astype(jnp.float32) * gj.astype(jnp.float32))

    want_grads = jax.grad(loss, argnums=(0, 1) if with_weight else 0)(xj, wj)
    want_grads = want_grads if with_weight else (want_grads,)

    xt = x.clone().requires_grad_()
    wt = w.clone().requires_grad_() if with_weight else None
    got = trms.RMSNormFn.apply(xt, wt, 1e-5)
    got.backward(g)
    assert got.dtype == dtype and xt.grad.dtype == dtype
    _close(got.detach(), want, dtype, 1e-5, "y")
    _close(trms.rms_norm(x, w), want, dtype, 1e-5, "rms_norm")
    _close(xt.grad, want_grads[0], dtype, 1e-5, "dx")
    if with_weight:
        _close(wt.grad, want_grads[1], torch.float32, 1e-5, "dw")


def _pallas_rms(x2, w, eps):
    out = jax.ShapeDtypeStruct(x2.shape, x2.dtype)
    if w is None:
        return pl.pallas_call(functools.partial(jrms._rms_kernel, eps=eps), out_shape=out, interpret=True)(x2)
    return pl.pallas_call(functools.partial(jrms._rms_weight_kernel, eps=eps), out_shape=out, interpret=True)(x2, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_twins_match_pallas_bodies(dtype):
    """K9's twin against ``_rms_kernel``/``_rms_weight_kernel`` on rows × D, and
    K10's twin against ``_rotary_kernel`` on (B·H, N, D), in interpret mode."""
    for d in (16, 40):
        x, xj = _pair(_rand(d, 50, d, scale=3.0), dtype)
        w = _rand(d + 1, d)
        _close(trms.rms_norm_plain(x), _pallas_rms(xj, None, 1e-5), dtype, 1e-6, f"rms d={d}")
        _close(trms.rms_norm_plain(x, torch.from_numpy(w)), _pallas_rms(xj, jnp.asarray(w), 1e-5), dtype, 1e-6,
               f"rms+w d={d}")
    b, h, n, d = 2, 3, 29, 16
    x, xj = _pair(_rand(5, b, h, n, d), dtype)
    cos, sin = trot.make_rotary_tables(n, d)
    jdt = xj.dtype
    want = pl.pallas_call(jrot._rotary_kernel, out_shape=jax.ShapeDtypeStruct((b * h, n, d), jdt), interpret=True)(
        xj.reshape(b * h, n, d), jnp.asarray(cos.numpy()).astype(jdt), jnp.asarray(sin.numpy()).astype(jdt))
    _close(trot.apply_rotary_emb_kernel(x, cos, sin), want.reshape(b, h, n, d), dtype, 1e-6, "rotary")


def test_rotary_plain_and_k10_composition_match_jax():
    b, h, n, d = 2, 4, 33, 20
    x = _rand(7, b, h, n, d)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    c, s = trot.make_rotary_tables(n, d)
    cj, sj = jrot.make_rotary_tables(n, d)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=1e-6)
    for rd in (d, 12):  # full and partial rotary dim
        cr, sr = trot.make_rotary_tables(n, rd)
        cjr, sjr = jnp.asarray(cr.numpy()), jnp.asarray(sr.numpy())
        for inter in (True, False):
            np.testing.assert_allclose(trot.apply_rotary_emb(xt, cr, sr, inter).numpy(),
                                       np.asarray(jrot.apply_rotary_emb(xj, cjr, sjr, inter)), atol=1e-6)
    cj, sj = jnp.asarray(c.numpy()), jnp.asarray(s.numpy())
    np.testing.assert_allclose(trot.apply_rotary_emb_kernel(xt, c, s).numpy(),
                               np.asarray(jrot.apply_rotary_emb(xj, cj, sj, interleaved=False)), atol=1e-6)
    composed = trot.reinterleave(trot.apply_rotary_emb_kernel(trot.deinterleave(xt), c, s))
    np.testing.assert_allclose(composed.numpy(), np.asarray(jrot.apply_rotary_emb(xj, cj, sj, interleaved=True)),
                               atol=1e-6)


@pytest.mark.parametrize("branch,impl", [("rotary", "xla"), ("rotary", "pallas"), ("bias", "pallas")])
def test_diff_attention_rotary_and_rel_pos_match_jax(branch, impl):
    """``use_rotary=True`` with rel_pos = (cos, sin); ``use_rotary=False`` with
    rel_pos a (N, N) bias on A₁ − λ·A₂ (the naive path, whatever the impl)."""
    b, n, e, heads = 2, 30, 64, 2
    x = _rand(11, b, n, e)
    rotary = branch == "rotary"
    if rotary:
        cos, sin = trot.make_rotary_tables(n, e // heads // 2)
        rel_t, rel_j = (cos, sin), (jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()))
    else:
        bias = _rand(12, n, n, scale=0.1)
        rel_t, rel_j = torch.from_numpy(bias), jnp.asarray(bias)
    jm = jatt.MultiheadDiffAttn(e, depth=2, num_heads=heads, attn_impl=impl, use_rotary=rotary)
    v = jax_init(jm, jnp.asarray(x), rel_j)
    tm = load_port(tatt.MultiheadDiffAttn(e, depth=2, num_heads=heads, attn_impl=impl, use_rotary=rotary), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), rel_t).numpy()
        plain = tm(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply(v, jnp.asarray(x), rel_j))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.abs(got - plain).max() > 1e-3  # rel_pos changed the output
