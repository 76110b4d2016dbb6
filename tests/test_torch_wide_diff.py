"""K1 and K3 past head dim 128 on the CPU: the twins against the Pallas kernels, and a ResNet CENet.

The wide designs of ``csrc/diff_attention_wide.cuh`` (held against these
twins on the card in ``tests/test_torch_cuda.py``) compute what the JAX
package's ``_diff_fwd_pair_impl`` and ``_diff_bwd_pair_impl`` compute at any
head dim: their blocks span the whole of d and dv. Here the twins
``diff_attention_interleaved_fwd_plain`` and
``diff_attention_interleaved_bwd_plain`` (what the port's wrappers run on CPU
tensors) are held against those Pallas kernels in interpret mode at the wide
sites' head dims (PVT DSEB3 d = 80, ResNet DSEB1–3 d = 128, 256, 512, dv = 2d),
on ragged token counts: ``o`` and both LSEs at 2e-5 (``tests/test_torch_kernels.py``'s
tolerance), dq, dk, dv and dλ at 3e-4 (``tests/test_torch_backward.py``'s).

The slice as a whole: the logits of the port's CENet(resnet18) with the PH2
preset's model settings (3 channels, 2 classes, heads (2, 2, 2), scale factors
(1.0, 0.75, 0.5); DSEB3 at d = 128, dv = 256) at 64 px, batch 2, fp32, within
max abs 1e-4 of the JAX model's on the same weights, carried as
``tests/test_torch_model_zoo_models.py`` carries CENet(resnet18)'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cenet_tpu.core.config import get_preset as jget_preset
from cenet_tpu.ops.pallas_attention import _diff_bwd_pair_impl, _diff_fwd_pair_impl
from cenet_tpu.train.trainer import build_model as jbuild_model
from cenet_tpu_torch.convert.jax2torch import state_dict_from_jax
from cenet_tpu_torch.core.config import get_preset
from cenet_tpu_torch.models.cenet import build_model
from cenet_tpu_torch.ops import attention_kernels as K
from torch_parity import FAST_COMPILE, nchw, nhwc, randomize_stats, variables_from_port

# One intra-op thread, as tests/torch_parity.py sets it for the files that import it:
# in the parallel test run torch's default pool spins against the other workers.
torch.set_num_threads(1)

# (b, h, n, m, d, dv): the wide sites' head dims on ragged token counts
WIDE_SHAPES = [(1, 2, 64, 64, 80, 160), (1, 1, 100, 49, 128, 256), (1, 1, 64, 64, 256, 512),
               (1, 1, 49, 49, 512, 1024)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _inputs(b, h, n, m, d, dv):
    rng = np.random.default_rng(n + d)
    q = rng.standard_normal((b, 2 * h, n, d)).astype(np.float32) * d**-0.5
    k = rng.standard_normal((b, 2 * h, m, d)).astype(np.float32)
    v = rng.standard_normal((b, h, m, dv)).astype(np.float32)
    g = rng.standard_normal((b, h, n, dv)).astype(np.float32)
    return q, k, v, g, np.float32(0.37)


@pytest.mark.parametrize("b,h,n,m,d,dv", WIDE_SHAPES)
def test_wide_diff_twin_matches_pallas(b, h, n, m, d, dv):
    q, k, v, _, lam = _inputs(b, h, n, m, d, dv)
    o_ref, l1, l2 = _diff_fwd_pair_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lam),
                                        interpret=True, with_lse=True)
    o, lse1, lse2 = K.diff_attention_interleaved_fwd(_t(q), _t(k), _t(v), torch.tensor(lam))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse1.numpy(), np.asarray(l1)[:, :n, 0].reshape(b, h, n), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse2.numpy(), np.asarray(l2)[:, :n, 0].reshape(b, h, n), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,h,n,m,d,dv", WIDE_SHAPES)
def test_wide_diff_backward_twin_matches_pallas(b, h, n, m, d, dv):
    q, k, v, g, lam = _inputs(b, h, n, m, d, dv)
    _, l1, l2 = _diff_fwd_pair_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lam),
                                    interpret=True, with_lse=True)
    want = _diff_bwd_pair_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lam), l1, l2,
                               jnp.asarray(g), interpret=True)
    _, lse1, lse2 = K.diff_attention_interleaved_fwd_plain(_t(q), _t(k), _t(v), torch.tensor(lam))
    got = K.diff_attention_interleaved_bwd(_t(q), _t(k), _t(v), torch.tensor(lam), lse1, lse2, _t(g))
    for name, a, w in zip(["dq", "dk", "dv", "dlam"], got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=3e-4, rtol=3e-4, err_msg=name)


def _ph2_resnet18(get):
    cfg = get("ph2")
    return cfg.replace(model=dataclasses.replace(cfg.model, encoder="resnet18", drop_path_rate=0.0))


def test_cenet_resnet18_ph2_logits_match_jax():
    cfg = _ph2_resnet18(get_preset)
    assert (cfg.model.input_channels, cfg.model.num_classes, cfg.model.diffatt_num_heads,
            cfg.model.scale_factors) == (3, 2, (2, 2, 2), (1.0, 0.75, 0.5))
    jm = jbuild_model(_ph2_resnet18(jget_preset))
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    model = build_model(cfg, device="cpu", seed=4)
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x), jax.random.PRNGKey(0), jnp.asarray(x))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    variables = randomize_stats(variables_from_port(model, template))
    want = jax.jit(lambda v, x: jm.apply(v, x)).lower(variables, x).compile(compiler_options=FAST_COMPILE)(variables, x)
    model.load_state_dict(state_dict_from_jax(variables, "cenet"), strict=True)
    with torch.no_grad():
        got = model(nchw(x))
    assert got.shape == (2, 2, 64, 64)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4, rtol=0)
