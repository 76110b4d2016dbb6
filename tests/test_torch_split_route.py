"""The split-group route against the JAX package's: ``DiffAttentionFn``, the
router's ``diff_attention_core``/``diff_attention_split``, and the modules whose
diff attention takes the route.

The JAX side runs ``pallas_diff_attention`` (K5 forward, K6 backward) in
interpret mode; the port runs its twins on CPU tensors, through
``DiffAttentionFn`` where the route takes the kernel. Forward and every
gradient, fp32, 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cenet_tpu.nn import attention as jatt
from cenet_tpu.nn import dseb as jdseb
from cenet_tpu.ops import flash_attention, pallas_attention
from cenet_tpu_torch.convert.jax2torch import state_dict_from_jax
from cenet_tpu_torch.nn import attention as tatt
from cenet_tpu_torch.nn import dseb as tdseb
from cenet_tpu_torch.ops import attention_kernels as K
from cenet_tpu_torch.ops import router
from torch_parity import (assert_all_close, head_groups, interleaved_qkv, jax_init, load_port, nchw, nhwc, rand32,
                          randomize_stats, to_jax, to_torch)

ATOL = 1e-5


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(pallas_attention, "_INTERPRET", True)
    monkeypatch.setattr(flash_attention, "_SMALL_LIMIT", 0)


@pytest.fixture
def split_route(pallas_interpret, monkeypatch):
    """Both packages on the split-group route: the JAX router finds the interleaved
    pair kernel failing and falls to ``diff_attention_core`` →
    ``pallas_diff_attention``; the port's interleaved sites go to
    ``router.diff_attention_split`` (as ``chip_smoke.py`` routes them), and
    ``diff_attention_core`` takes its kernel route (``DiffAttentionFn``)."""

    def pair_kernel_fails(*args, **kwargs):
        raise RuntimeError("the interleaved pair kernel is not taken on the split route")

    monkeypatch.setattr(pallas_attention, "pallas_diff_attention_interleaved", pair_kernel_fails)
    monkeypatch.setattr(router, "diff_attention_interleaved", router.diff_attention_split)
    monkeypatch.setattr(router, "_use_kernel", lambda q, map_elems: True)


def _jax_value_and_grads(fn, arrays, cot):
    """fn(*arrays) and the gradients of ⟨fn(*arrays), cot⟩, jitted whole."""

    def value_and_grads(arrays, cot):
        out, vjp = jax.vjp(fn, *arrays)
        return out, vjp(cot)

    return jax.jit(value_and_grads)(arrays, cot)


def _torch_value_and_grads(fn, tensors, cot):
    leaves = [t.detach().clone().requires_grad_() for t in tensors]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, cot)


def test_diff_attention_fn_matches_jax_grad(pallas_interpret):
    """``DiffAttentionFn`` (twins both ways) against ``pallas_diff_attention``'s
    custom_vjp: o and all six gradients, dλ included."""
    rng = np.random.default_rng(11)
    q, k, v = interleaved_qkv(rng, 2, 2, 90, 70, 8, 16)
    lam = torch.tensor(0.3)
    cot = to_torch(rand32(rng, 2, 2, 90, 16))
    args = (*(t.contiguous() for t in head_groups(q, k)), v, lam)
    want = _jax_value_and_grads(pallas_attention.pallas_diff_attention, to_jax(*args), *to_jax(cot))
    got = _torch_value_and_grads(K.DiffAttentionFn.apply, args, cot)
    assert_all_close([got[0], *got[1]], [want[0], *want[1]], ATOL, ["o", "dq1", "dk1", "dq2", "dk2", "dv", "dlam"])


@pytest.mark.parametrize("kernel_route", [False, True], ids=["plain", "kernel"])
def test_router_split_matches_jax(pallas_interpret, monkeypatch, kernel_route):
    """``router.diff_attention_split`` on the interleaved layout and
    ``router.diff_attention_core`` on its head groups, in plain math or (forced)
    through ``DiffAttentionFn``, against JAX's ``diff_attention_core(impl="pallas")``
    on the same groups: forward and the gradients of q, k, v and λ."""
    if kernel_route:
        monkeypatch.setattr(router, "_use_kernel", lambda q, map_elems: True)
    rng = np.random.default_rng(12)
    q, k, v = interleaved_qkv(rng, 1, 2, 80, 80, 8, 16)
    lam = torch.tensor(0.25)
    cot = to_torch(rand32(rng, 1, 2, 80, 16))

    def jax_split(q, k, v, lam):
        return flash_attention.diff_attention_core(q[:, 0::2], k[:, 0::2], q[:, 1::2], k[:, 1::2], v, lam,
                                                   impl="pallas")

    want = _jax_value_and_grads(jax_split, to_jax(q, k, v, lam), *to_jax(cot))
    names = ["o", "dq", "dk", "dv", "dlam"]
    for fn in (router.diff_attention_split, lambda q, k, v, lam: router.diff_attention_core(*head_groups(q, k), v, lam)):
        got = _torch_value_and_grads(fn, (q, k, v, lam), cot)
        assert_all_close([got[0], *got[1]], [want[0], *want[1]], ATOL, names)


def test_multihead_diff_attn_split_route_matches_jax(split_route):
    """``MultiheadDiffAttn`` on the split route in both packages: the output and
    every parameter's gradient (JAX's under the port's names and layouts)."""
    rng = np.random.default_rng(13)
    x, cot = rand32(rng, 2, 100, 64), rand32(rng, 2, 100, 64)
    jm = jatt.MultiheadDiffAttn(64, depth=2, num_heads=4, attn_impl="pallas")
    variables = jax_init(jm, jnp.asarray(x))
    tm = load_port(tatt.MultiheadDiffAttn(64, depth=2, num_heads=4, attn_impl="pallas"), variables)
    want_out, (grads,) = _jax_value_and_grads(lambda p: jm.apply({"params": p}, jnp.asarray(x)),
                                              [variables["params"]], jnp.asarray(cot))
    want = {name[len("m."):]: t
            for name, t in state_dict_from_jax({"params": {"m": jax.tree.map(np.asarray, grads)}}).items()}
    out = tm(torch.from_numpy(x))
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=ATOL, rtol=ATOL)
    assert set(want) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=ATOL, rtol=ATOL, err_msg=name)


def test_dseb_split_route_matches_jax(split_route):
    """A DSEB block as the Synapse preset builds it (``mode="cat"``, diff
    attention and FEA) on the split route, forward."""
    skip, dec = rand32(np.random.default_rng(14), 2, 10, 10, 16), rand32(np.random.default_rng(15), 2, 10, 10, 16)
    kw = dict(scale_factors=(0.8, 0.4), num_heads=2, mode="cat", use_command="dat-fea", depth=2, attn_impl="pallas")
    jm = jdseb.DSEBlock(16, input_size=10, **kw)
    variables = randomize_stats(jax_init(jm, jnp.asarray(skip), jnp.asarray(dec)))
    tm = load_port(tdseb.DSEBlock(16, **kw), variables)
    with torch.no_grad():
        got = tm(nchw(skip), nchw(dec))
    want = jax.jit(jm.apply)(variables, jnp.asarray(skip), jnp.asarray(dec))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=ATOL)
