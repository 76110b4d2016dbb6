"""Port parity for the model zoo's modules against the JAX package.

GroupNorm, LayerNorm2d and ConvTranspose2d; the cenet_org CFAM (rates
(6, 12, 18), whose dilated branches pad past the 7² and 14² maps, the ReLU
pool branch, fp32 gating, the GN and LN2d norms and the reference's
``attn``/``crm`` names); UpRb, UpTConv, DownRb, UnetBasicBlock, UnetUpBlock
and ``make_up_block``'s ``uprb``/``uptc``; DoGEdge, SkipEnhancer and the DSEB
``dog`` modes; MultiheadDiffAttnCross v1 and v2 on maps; WeightedNonLocalBlock
and the dot-product Nonlocal; ResNet's BasicBlock and Bottleneck (torchvision
keys, in train and eval mode); SRAAttention's ``qk_scale``; the encoder
factory's fallback; and the CCU's and SRM's std at a constant channel, whose
gradient is NaN in the JAX package and 0 in the port (``std_sqrt``). Inputs made with numpy from a seed, weights from the JAX
module's init through ``state_dict_from_jax``, BatchNorm statistics
randomised; fp32, max abs and relative error ≤ 1e-5 (sums in another order
than XLA's). Where the JAX side routes attention through Pallas, it runs in
interpret mode (size limit 0); the port takes its CPU twins.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cenet_tpu.models import resnet as jresnet
from cenet_tpu.nn import attention as jatt
from cenet_tpu.nn import blocks as jblocks
from cenet_tpu.nn import cfam as jcfam
from cenet_tpu.nn import dseb as jdseb
from cenet_tpu.nn import layers as jlayers
from cenet_tpu_torch.models import encoder as tencoder
from cenet_tpu_torch.models import resnet as tresnet
from cenet_tpu_torch.nn import attention as tatt
from cenet_tpu_torch.nn import blocks as tblocks
from cenet_tpu_torch.nn import cfam as tcfam
from cenet_tpu_torch.nn import dseb as tdseb
from cenet_tpu_torch.nn import layers as tlayers
from torch_parity import jax_init, load_port, nchw, nhwc, randomize_stats

ATOL = 1e-5


@pytest.fixture
def pallas_interpret(monkeypatch):
    from cenet_tpu.ops import flash_attention, pallas_attention

    monkeypatch.setattr(pallas_attention, "_INTERPRET", True)
    monkeypatch.setattr(flash_attention, "_SMALL_LIMIT", 0)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _check(jm, tm, *xs, wrap="m", strip=None, model_version="cenet", train=None, layer_scale=None):
    """``jm`` and ``tm`` on the same weights and NHWC/NCHW inputs; ``train`` (when
    not None) is passed to the JAX module, and puts the port module in that mode."""
    kw = {} if train is None else {"train": train}
    v = randomize_stats(jax_init(jm, *map(jnp.asarray, xs), **kw))
    if layer_scale is not None:  # lift CFAM's 1e-6 layer scales so the branches show
        for k in ("layer_scale_1", "layer_scale_2"):
            v["params"][k] = np.full_like(v["params"][k], layer_scale)
    load_port(tm, v, wrap=wrap, strip=strip, model_version=model_version)
    tm.train(bool(train))
    with torch.no_grad():
        got = tm(*[nchw(x) for x in xs])
    want = jm.apply(v, *map(jnp.asarray, xs), **kw, mutable=["batch_stats"] if train else False)
    if train:  # the updated running statistics too
        want, stats = want
        moved = load_port(type(tm)(*tm.init_args), {**v, "batch_stats": stats["batch_stats"]}, wrap=wrap, strip=strip,
                          model_version=model_version).state_dict()
        for k, t in tm.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(t.numpy(), moved[k].numpy(), atol=ATOL, rtol=ATOL, err_msg=k)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_group_norm_layer_norm_2d_and_conv_transpose_match_jax():
    x = _x((2, 9, 7, 16))
    _check(jlayers.GroupNorm(4, 16), tlayers.GroupNorm(4, 16), x)
    _check(jcfam.build_norm("LN2d", 16, "norm"), tcfam.build_norm("LN2d", 16), x)
    _check(jcfam.build_norm("GN", 16, "norm"), tcfam.build_norm("GN", 16), x)
    # torch's output_padding, and a bias: the weight is (I, O, kh, kw) under a "transp_conv" key
    _check(jlayers.ConvTranspose2d(16, 6, 3, stride=2, padding=1, output_padding=1),
           tlayers.ConvTranspose2d(16, 6, 3, stride=2, padding=1, output_padding=1), x, wrap="transp_conv")


@pytest.mark.parametrize("size,norm,fp32,impl", [(7, "BN", False, "xla"), (14, "GN", True, "pallas"),
                                                 (7, "LN2d", True, "xla")])
def test_org_cfam_matches_jax(pallas_interpret, size, norm, fp32, impl):
    """The cenet_org CFAM: rates (6, 12, 18) pad the dilated branches past the
    map (7² and 14², dec4 and dec3), ReLU pool branch, ``attn``/``crm`` names."""
    x = _x((2, size, size, 32))
    kw = dict(ffn_ratio=4, init_value=1e-6, norm_type=norm, mca_rates=(6, 12, 18), attn_force_fp32=fp32,
              pool_act="relu", attn_impl=impl)
    _check(jcfam.CFAModule(32, **kw), tcfam.CFAModule(32, org_names=True, **kw), x, model_version="cenet_org",
           layer_scale=0.5)


@pytest.mark.parametrize("kind", ["uprb", "uptc", "uptc5", "downrb", "basic"])
def test_up_down_and_basic_blocks_match_jax(kind):
    x = _x((2, 10, 12, 16))
    if kind in ("uprb", "uptc", "uptc5"):
        k = 5 if kind == "uptc5" else 3
        _check(jblocks.make_up_block(kind[:4], 16, 8, k), tblocks.make_up_block(kind[:4], 16, 8, k), x, wrap="up1")
    elif kind == "downrb":
        _check(jblocks.DownRb(16, 8), tblocks.DownRb(16, 8), x)
    else:
        _check(jblocks.UnetBasicBlock(16, 8, 3, 2), tblocks.UnetBasicBlock(16, 8, 3, 2), x)


def test_unet_up_block_matches_jax():
    x, skip = _x((2, 6, 5, 16)), _x((2, 12, 10, 8), 1)
    _check(jblocks.UnetUpBlock(16, 8, 3, 2), tblocks.UnetUpBlock(16, 8, 3, 2), x, skip)


@pytest.mark.parametrize("mode", ["cat", "add"])
def test_dog_edge_and_skip_enhancer_match_jax(pallas_interpret, mode):
    skip, dec = _x((2, 10, 10, 16), 1), _x((2, 10, 10, 16), 2)
    _check(jdseb.DoGEdge(16, (0.6, 0.3)), tdseb.DoGEdge(16, (0.6, 0.3)), skip)
    kw = dict(scale_factors=(0.6, 0.3), num_heads=2, mode=mode, attn_impl="pallas" if mode == "add" else "xla")
    _check(jdseb.SkipEnhancer(16, input_size=10, **kw), tdseb.SkipEnhancer(16, **kw), skip, dec)


@pytest.mark.parametrize("cmd", ["dog", "dat-dog-seq", "fea-dog"])
def test_dseb_dog_modes_match_jax(pallas_interpret, cmd):
    """The DoG branch: per-channel σ = 2·sigmoid(raw), the reference's per-tap
    normalisation across channels."""
    skip, dec = _x((2, 10, 10, 8), 1), _x((2, 10, 10, 8), 2)
    kw = dict(scale_factors=(0.8, 0.4), num_heads=2, mode="cat", use_command=cmd, depth=2, attn_impl="pallas")
    _check(jdseb.DSEBlock(8, input_size=10, **kw), tdseb.DSEBlock(8, **kw), skip, dec)


@pytest.mark.parametrize("variant,impl", [("v1", "xla"), ("v2", "pallas")])
def test_diff_attn_cross_matches_jax(pallas_interpret, variant, impl):
    x, q_src = _x((2, 8, 8, 16), 1), _x((2, 8, 8, 16), 2)
    kw = dict(depth=2, num_heads=2, variant=variant, spatial=8, attn_impl=impl)
    _check(jatt.MultiheadDiffAttnCross(16, **kw), tatt.MultiheadDiffAttnCross(16, **kw), x, q_src)


def test_weighted_and_dot_product_nonlocal_match_jax():
    x = _x((2, 7, 9, 16))
    _check(jatt.WeightedNonLocalBlock(16, 8), tatt.WeightedNonLocalBlock(16, 8), x)
    _check(jatt.Nonlocal(16, instantiation="dot_product"), tatt.Nonlocal(16, instantiation="dot_product"), x)


@pytest.mark.parametrize("block,stride,train", [("basic", 1, False), ("basic", 2, True), ("bottleneck", 1, True),
                                                ("bottleneck", 2, False)])
def test_resnet_blocks_match_jax(block, stride, train):
    """Torchvision keys under the backbone (``layerN.i.convK``, ``downsample.{0,1}``),
    BatchNorm in the module's mode (train: batch statistics, updated buffers)."""
    x = _x((2, 9, 10, 32))
    jb = (jresnet.BasicBlock if block == "basic" else jresnet.Bottleneck)(32, 16, stride)
    tb = (tresnet.BasicBlock if block == "basic" else tresnet.Bottleneck)(32, 16, stride)
    tb.init_args = (32, 16, stride)
    _check(jb, tb, x, wrap="backbone/layer2_0", strip="backbone.layer2.0.", train=train)


def test_sra_qk_scale_and_drop_options():
    x = _x((2, 36, 16))
    jm = jatt.SRAAttention(16, num_heads=2, qkv_bias=True, qk_scale=0.3, sr_ratio=2, attn_drop=0.1, proj_drop=0.1)
    tm = tatt.SRAAttention(16, num_heads=2, qkv_bias=True, qk_scale=0.3, sr_ratio=2, attn_drop=0.1, proj_drop=0.1)
    v = jax_init(jm, jnp.asarray(x), H=6, W=6)
    load_port(tm, v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), 6, 6)  # eval mode: both dropouts are the identity
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(v, jnp.asarray(x), 6, 6)), atol=ATOL, rtol=ATOL)
    tm.train()
    tlayers.set_generator(tm, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="attn_impl='xla'"):  # as the JAX module raises
        tatt.SRAAttention(16, num_heads=2, attn_drop=0.1, attn_impl="pallas").train()(torch.from_numpy(x), 6, 6)
    assert tm(torch.from_numpy(x), 6, 6).shape == (2, 36, 16)


def test_encoder_fallback_and_channels(caplog):
    """An unknown encoder falls back to pvt_v2_b2 with a warning, as the JAX
    package (and the reference, ``encoder.py:48-52``) does; ResNets report
    torchvision's channels."""
    from cenet_tpu.models import encoder as jencoder

    with caplog.at_level(logging.WARNING):
        backbone, channels = tencoder.make_encoder("pvt_v3_nonesuch")
    assert "pvt_v2_b2" in caplog.text
    assert channels == jencoder.get_encoder_channels("pvt_v3_nonesuch") == [512, 320, 128, 64]
    assert [len(getattr(backbone, f"block{s}")) for s in range(1, 5)] == [3, 4, 6, 3]
    for name in tresnet.RESNET_VARIANTS:
        assert tencoder.ENCODER_CHANNELS[name] == jencoder.ENCODER_CHANNELS[name]
        assert tresnet.RESNET_VARIANTS[name] == jresnet.RESNET_VARIANTS[name]


def test_ccu_and_srm_std_gradients_are_finite_at_a_constant_channel():
    """A channel that a ReLU leaves at 0 over an image: equal forwards, and the
    port's gradient finite, equal to JAX's wherever JAX's is finite (its
    ``sqrt`` gives NaN at the zero std, and BatchNorm spreads it over the
    channel), within 1e-4 of the largest: train-mode statistics of a batch of
    2 amplify the fp32 sums' other order."""
    import jax

    x = np.maximum(_x((2, 3, 4, 8)), 0)
    x[0, ..., 3] = 0.0  # CCU: one image's channel constant over its map
    x[1, 1, 2, :] = 0.5  # SRM: one pixel constant over the channels
    for jm, tm in ((jcfam.CCU(8), tcfam.CCU(8)), (jcfam.SRM(), tcfam.SRM())):
        v = randomize_stats(jax_init(jm, jnp.asarray(x)))
        load_port(tm, v, wrap="srm" if isinstance(tm, tcfam.SRM) else "m")
        xt = nchw(x).requires_grad_()
        tm.train()
        got = tm(xt)
        got.square().sum().backward()
        jgrad = np.asarray(jax.grad(lambda a: jnp.sum(jm.apply(v, a, train=True, mutable=["batch_stats"])[0] ** 2))(
            jnp.asarray(x)))
        want = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])[0]
        np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=ATOL)
        grad = nhwc(xt.grad)
        assert np.isfinite(grad).all() and not np.isfinite(jgrad).all()
        live = np.isfinite(jgrad)
        assert np.abs(grad[live] - jgrad[live]).max() <= 1e-4 * np.abs(jgrad[live]).max()
