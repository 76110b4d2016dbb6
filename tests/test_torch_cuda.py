"""The port's CUDA kernels against their plain twins, on the card.

Forward kernels (K1, K2, K5) on ``o`` and the LSE; backward kernels (K3, K4,
K6, K7, K8) on their gradients and, for the diff kernels, dλ, with the limits
of ``chip_smoke.py``. K1–K8 run on the tensor cores in bf16 and on CUDA cores
in fp32 (K5 is K1's kernel on split views, K7 K3's kernels with its own dv
rounding, K6 a one-launch kernel of its own), so their shapes include the
edges of 64-row tiles and of 16-deep steps (N, M of 1, 63, 65, 127, 129, 196,
784 and 3136; d of 8, 16, 20, 32 and 64 with dv = 2d, and d = dv = 64 and
128; the ACDC and skin presets' DSEB head dims (16, 32), (32, 64) and
(64, 128) at 784 and 3136 tokens for K1 and K3), the
strided views that the DSEB projections and ``Nonlocal`` hand over, and
bit-identity checks of K1, K3 and K7 (δ and dλ included), K4, K6's dq, δ and
dλ, and K8's dk and dv. K2 and K4 also at head dims past 128 (their wide
designs, d and dv up to 512: the ResNet-50 Nonlocal sites and ragged chunks),
with their repeat-run bit-identity, and the router sending ResNet-50's dec1
Nonlocal to K2 and K4. Limits in max-abs
and in norm: fp32 1e-4 of max |grad| and 1e-5 in norm (only the order of
summation differs); bf16 two bf16 half-ulps of max |grad| (2·2^-8 in norm) plus
the twin's own cost of rounding ds and p (or w) to bf16, measured the same way.

K9–K12 (RMSNorm, rotary, depthwise and small-channel convolution) against
their twins: fp32 within 1e-5 of max |want| for the elementwise kernels (the
card's rsqrtf and fused multiply-adds), and for the convolutions 1e-4 of max
and 1e-5 in norm (order of summation); bf16 outputs within two bf16
half-ulps of max |want| (2·2^-8), fp32 weight gradients as in fp32. K12's
bf16 forward and backward (the tensor-core implicit GEMMs, and the CUDA-core
dx of the shape rule) at every kernel size and input width of its domain,
K11's forward at every dilation of its domain in both layouts, and K11's dw at
every dilation on every route of its layout rule and at the train step's size
classes, with their repeat-run bit-identity; K10 equal to its twin to the bit
at head dims 6–128 on fp32 tables and on tables in x's dtype.

The one-card training surface: a CENet-b0 step at 224² (its DSEB1, DSEB2 and
dec1 sites launch K1–K4) with ``train.remat`` equal to the step without it to
the bit, in a fresh process under the determinism settings; ``model_cost``
equal on the card and on the CPU, with the sites routed or not; the device
augmentation on the card against the CPU for the same per-sample choices.

The volume engine's card path: the overlapped chunk pipeline (pinned staging,
side-stream uploads) gives the serial loop's labels to the bit in bf16 on a
CENet-b0 (its DSEB and Nonlocal sites launch K1 and K2), a uint16 upload
decodes to the integer volume exactly on both paths, and the pinned buffers
are made in the first case only.

The Orbax bridge where the card is: the zstd decoder built from its source
and the committed CENet-b2 TrainState (``tests/torch_orbax_data``) read,
hashed against its manifest and loaded onto a trainer on the card.

Marked ``cuda``; each test skips without a CUDA device. This file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cenet_tpu_torch.core.config import get_preset
from cenet_tpu_torch.evaluate.predict import make_predict_fn
from cenet_tpu_torch.evaluate.volume import VolumeInferenceConfig, VolumeInferencer
from cenet_tpu_torch.models.cenet import build_model
from cenet_tpu_torch.ops import attention_kernels as K
from cenet_tpu_torch.ops import depthwise as DW
from cenet_tpu_torch.ops import rms_norm as RN
from cenet_tpu_torch.ops import rotary as RO
from cenet_tpu_torch.ops import smallc_conv as SC

# One intra-op thread, as tests/torch_parity.py sets it for the files that import it:
# in the parallel test run torch's default pool spins against the other workers.
torch.set_num_threads(1)

# (b, h, n, m, d) and (b, h, n, m, d, dv): ragged N/M and the slice's head dims
DIFF_SHAPES = [(2, 2, 100, 100, 8), (1, 2, 196, 196, 20), (1, 1, 64, 100, 16), (1, 1, 196, 49, 64),
               (1, 1, 1, 1, 8), (1, 1, 1, 65, 16), (2, 1, 63, 65, 20), (1, 2, 65, 63, 8), (2, 2, 65, 1, 16),
               (1, 2, 784, 784, 16), (2, 1, 196, 784, 20), (1, 1, 130, 70, 64),
               # the ACDC and skin presets' DSEB1 and DSEB2 head dims (d, dv = 2d)
               (1, 1, 784, 784, 32), (1, 1, 784, 784, 64), (1, 1, 3136, 3136, 16), (1, 1, 3136, 3136, 32),
               (1, 1, 3136, 3136, 64)]
ATTN_SHAPES = [(2, 1, 100, 100, 64, 64), (1, 2, 196, 196, 16, 24), (1, 1, 100, 196, 8, 8), (1, 1, 64, 64, 20, 40),
               (1, 1, 130, 70, 128, 128), (1, 1, 1, 1, 64, 64), (1, 1, 1, 65, 20, 40), (2, 1, 63, 65, 64, 64),
               (1, 1, 65, 63, 128, 128), (1, 1, 65, 1, 16, 24), (1, 1, 3136, 3136, 64, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _o_limit(dtype, want, want_w) -> float:
    """fp32: 1e-4. bf16: two bf16 half-ulps (2^-8 relative each) of max |want|,
    for rounding o and for w values rounded the other way, plus the cost of
    rounding w to bf16 as the twin computes it (``want_w``)."""
    if dtype == torch.float32:
        return 1e-4
    return 2 * 2.0**-8 * float(want.abs().max()) + float((want_w - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_twins(cuda, dtype):
    """Kernel vs twin on the card at ragged shapes (the twin in fp32 on the same
    rounded inputs): o within ``_o_limit``, the fp32 LSE within 1e-4."""
    g = torch.Generator().manual_seed(0)
    for b, h, n, m, d in DIFF_SHAPES:
        q = (torch.randn(b, 2 * h, n, d, generator=g) * d**-0.5).to(cuda, dtype)
        k = torch.randn(b, 2 * h, m, d, generator=g).to(cuda, dtype)
        v = torch.randn(b, h, m, 2 * d, generator=g).to(cuda, dtype)
        lam = torch.tensor(0.37, device=cuda)
        got = K.diff_attention_interleaved_fwd(q, k, v, lam)
        want = K.diff_attention_interleaved_fwd_plain(q.float(), k.float(), v.float(), lam)
        want_w = K.diff_attention_interleaved_fwd_plain(q.float(), k.float(), v, lam)[0]
        torch.cuda.synchronize()
        assert (got[0].float() - want[0]).abs().max() <= _o_limit(dtype, want[0], want_w)
        assert max((a - b_).abs().max() for a, b_ in zip(got[1:], want[1:])) <= 1e-4
    for b, h, n, m, d, dv in ATTN_SHAPES:
        q = (torch.randn(b, h, n, d, generator=g) * d**-0.5).to(cuda, dtype)
        k = torch.randn(b, h, m, d, generator=g).to(cuda, dtype)
        v = torch.randn(b, h, m, dv, generator=g).to(cuda, dtype)
        got = K.attention_fwd(q, k, v)
        want = K.attention_fwd_plain(q.float(), k.float(), v.float())
        want_w = K.attention_fwd_plain(q.float(), k.float(), v)[0]
        torch.cuda.synchronize()
        assert (got[0].float() - want[0]).abs().max() <= _o_limit(dtype, want[0], want_w)
        assert (got[1] - want[1]).abs().max() <= 1e-4


@pytest.mark.cuda
def test_cuda_diff_kernel_takes_strided_views(cuda):
    """The diff-attention projections hand over transposed views
    (``reshape(B, N, 2h, d).transpose(1, 2)``); the kernel reads them by strides."""
    g = torch.Generator().manual_seed(1)
    b, n, h, d = 2, 150, 4, 20
    q = torch.randn(b, n, 2 * h, d, generator=g).to(cuda).transpose(1, 2) * d**-0.5
    k = torch.randn(b, n, 2 * h, d, generator=g).to(cuda).transpose(1, 2)
    v = torch.randn(b, n, h, 2 * d, generator=g).to(cuda).transpose(1, 2)
    lam = torch.tensor(0.5, device=cuda)
    got = K.diff_attention_interleaved_fwd(q, k, v, lam)
    want = K.diff_attention_interleaved_fwd_plain(q.contiguous(), k.contiguous(), v.contiguous(), lam)
    torch.cuda.synchronize()
    for a, b_ in zip(got, want):
        assert (a - b_).abs().max() <= 1e-4


# (b, h, n, m, d, dv) for the backward kernels: ragged N/M, every head dim of
# the main path, and dv ≠ 2d
BWD_DIFF_SHAPES = [(2, 2, 100, 100, 8, 16), (1, 2, 196, 196, 20, 40), (1, 1, 64, 100, 16, 32),
                   (1, 1, 130, 70, 64, 128), (1, 1, 70, 65, 128, 24), (1, 1, 1, 63, 8, 16), (2, 1, 63, 65, 16, 32),
                   (1, 2, 65, 63, 20, 40), (2, 2, 1, 65, 20, 40), (1, 2, 784, 784, 8, 16),
                   (2, 1, 784, 196, 16, 32), (1, 1, 196, 784, 20, 40),
                   # the ACDC and skin presets' DSEB1 and DSEB2 head dims
                   (1, 1, 784, 784, 16, 32), (1, 1, 784, 784, 32, 64), (1, 1, 784, 784, 64, 128),
                   (1, 1, 3136, 3136, 16, 32), (1, 1, 3136, 3136, 32, 64), (1, 1, 3136, 3136, 64, 128)]
BWD_ATTN_SHAPES = [(2, 1, 100, 100, 64, 64), (1, 2, 196, 196, 16, 24), (1, 1, 100, 196, 8, 8),
                   (1, 1, 130, 70, 128, 128), (1, 1, 64, 64, 20, 40), (1, 1, 1, 65, 64, 64), (2, 1, 63, 65, 64, 64),
                   (1, 1, 65, 63, 128, 128), (1, 1, 3136, 3136, 64, 64)]


def _rel_norm(got, want) -> float:
    return float(torch.linalg.vector_norm(got.float() - want.float()) / torch.linalg.vector_norm(want.float()))


def _grad_limits(dtype, want, want_r):
    """Per-gradient limits as (max |grad − want|, ‖grad − want‖ / ‖want‖): fp32
    1e-4·max|want| and 1e-5; bf16 2·2^-8·max|want| plus max|want_r − want|, and
    2·2^-8 plus ‖want_r − want‖ / ‖want‖ (``want_r``: the twin with ds and p/w
    rounded to bf16). The norm limit holds the typical element, which the
    max-abs limit, scaled by the largest, does not."""
    if dtype == torch.float32:
        return [(1e-4 * float(w.abs().max()), 1e-5) for w in want]
    return [(2 * 2.0**-8 * float(w.abs().max()) + float((r.float() - w).abs().max()), 2 * 2.0**-8 + _rel_norm(r, w))
            for w, r in zip(want, want_r)]


def _assert_grads(got, want, want_r, dtype, where):
    for name, a, w, (lim, nlim) in zip("dq dk dv".split(), got, want, _grad_limits(dtype, want, want_r)):
        assert a.dtype == dtype and a.shape == w.shape
        assert (a.float() - w).abs().max() <= lim, (name, where)
        assert _rel_norm(a, w) <= nlim, (name, where)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_diff_backward_matches_twin(cuda, dtype):
    g = torch.Generator().manual_seed(2)
    for b, h, n, m, d, dv in BWD_DIFF_SHAPES:
        q = (torch.randn(b, 2 * h, n, d, generator=g) * d**-0.5).to(cuda, dtype)
        k = torch.randn(b, 2 * h, m, d, generator=g).to(cuda, dtype)
        v = torch.randn(b, h, m, dv, generator=g).to(cuda, dtype)
        do = torch.randn(b, h, n, dv, generator=g).to(cuda, dtype)
        lam = torch.tensor(0.37, device=cuda)
        f = [t.float() for t in (q, k, v, do)]
        _, lse1, lse2 = K.diff_attention_interleaved_fwd_plain(f[0], f[1], f[2], lam)
        got = K.diff_attention_interleaved_bwd(q, k, v, lam, lse1, lse2, do)
        want = K.diff_attention_interleaved_bwd_plain(f[0], f[1], f[2], lam, lse1, lse2, f[3])
        want_r = (K.diff_attention_interleaved_bwd_plain(f[0], k, f[2], lam, lse1, lse2, do)[0],
                  K.diff_attention_interleaved_bwd_plain(q, f[1], f[2], lam, lse1, lse2, do)[1],
                  K.diff_attention_interleaved_bwd_plain(f[0], f[1], f[2], lam, lse1, lse2, do)[2])
        torch.cuda.synchronize()
        _assert_grads(got[:3], want[:3], want_r, dtype, (b, h, n, m, d, dv))
        assert abs(float(got[3]) - float(want[3])) <= 1e-4 * max(1.0, abs(float(want[3])))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_backward_matches_twin(cuda, dtype):
    g = torch.Generator().manual_seed(3)
    for b, h, n, m, d, dv in BWD_ATTN_SHAPES:
        q = (torch.randn(b, h, n, d, generator=g) * d**-0.5).to(cuda, dtype)
        k = torch.randn(b, h, m, d, generator=g).to(cuda, dtype)
        v = torch.randn(b, h, m, dv, generator=g).to(cuda, dtype)
        do = torch.randn(b, h, n, dv, generator=g).to(cuda, dtype)
        f = [t.float() for t in (q, k, v, do)]
        o, lse = K.attention_fwd_plain(f[0], f[1], f[2])
        o = o.to(dtype)
        got = K.attention_bwd(q, k, v, o, lse, do)
        want = K.attention_bwd_plain(f[0], f[1], f[2], o.float(), lse, f[3])
        want_r = (K.attention_bwd_plain(f[0], k, f[2], o, lse, do)[0],
                  K.attention_bwd_plain(q, f[1], f[2], o, lse, do)[1],
                  K.attention_bwd_plain(f[0], f[1], f[2], o, lse, do)[2])
        torch.cuda.synchronize()
        _assert_grads(got, want, want_r, dtype, (b, h, n, m, d, dv))


def _token_views(g, b, h, n, c, dtype, device):
    """q, k, v and dO as ``Nonlocal`` hands them over: (B, N, C) tokens with a
    head axis, ``[:, None]`` for one head and, for two, (B, N, 2, C) viewed as
    (B, 2, N, C) (head stride C, row stride 2C); q pre-scaled."""
    def tok():
        t = torch.randn(b, n, h * c, generator=g).to(device, dtype)
        return t[:, None] if h == 1 else t.view(b, n, h, c).transpose(1, 2)

    return (tok() * c**-0.5).to(dtype), tok(), tok(), tok()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_kernels_take_token_views(cuda, dtype):
    """K2 and K4 on the strided token views of the Nonlocal sites, one head and
    two, against their twins on contiguous copies, with the limits above; C = 20
    gives rows of 40 bytes, whose last 8 the bf16 kernels stage by element loads."""
    g = torch.Generator().manual_seed(6)
    for b, h, n, c in [(2, 1, 196, 64), (1, 2, 196, 64), (2, 2, 65, 20), (1, 2, 130, 128)]:
        q, k, v, do = _token_views(g, b, h, n, c, dtype, cuda)
        f = [t.float().contiguous() for t in (q, k, v, do)]
        o, lse = K.attention_fwd(q, k, v)
        want = K.attention_fwd_plain(f[0], f[1], f[2])
        want_w = K.attention_fwd_plain(f[0], f[1], v.contiguous())[0]
        got = K.attention_bwd(q, k, v, o, lse, do)
        want_b = K.attention_bwd_plain(f[0], f[1], f[2], o.float(), lse, f[3])
        want_r = (K.attention_bwd_plain(f[0], k, f[2], o, lse, do)[0],
                  K.attention_bwd_plain(q, f[1], f[2], o, lse, do)[1],
                  K.attention_bwd_plain(f[0], f[1], f[2], o, lse, do)[2])
        torch.cuda.synchronize()
        assert (o.float() - want[0]).abs().max() <= _o_limit(dtype, want[0], want_w), (b, h, n, c)
        assert (lse - want[1]).abs().max() <= 1e-4, (b, h, n, c)
        _assert_grads(got, want_b, want_r, dtype, (b, h, n, c))


def _dseb_views(g, b, n, h, d, dtype, device):
    """q, k, v and dO as ``MultiheadDiffAttn`` hands them over: (B, N, heads, ·)
    projections viewed as (B, heads, N, ·); q pre-scaled."""
    def view(heads, width, scale=1.0):
        return (torch.randn(b, n, heads, width, generator=g) * scale).to(device, dtype).transpose(1, 2)

    return view(2 * h, d, d**-0.5), view(2 * h, d), view(h, 2 * d), view(h, 2 * d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_diff_kernels_take_dseb_views(cuda, dtype):
    """K1 and K3 on the strided views of the DSEB sites' head dims (d = 8, 16,
    20; row stride 2h·d, head stride d, so group 2 starts d elements in) against
    their twins on contiguous copies, with the limits above."""
    g = torch.Generator().manual_seed(8)
    lam = torch.tensor(0.37, device=cuda)
    for b, n, h, d in [(2, 150, 4, 20), (1, 196, 8, 8), (2, 65, 2, 16), (1, 784, 8, 16)]:
        q, k, v, do = _dseb_views(g, b, n, h, d, dtype, cuda)
        f = [t.float().contiguous() for t in (q, k, v, do)]
        got = K.diff_attention_interleaved_fwd(q, k, v, lam)
        want = K.diff_attention_interleaved_fwd_plain(f[0], f[1], f[2], lam)
        want_w = K.diff_attention_interleaved_fwd_plain(f[0], f[1], v.contiguous(), lam)[0]
        grads = K.diff_attention_interleaved_bwd(q, k, v, lam, want[1], want[2], do)
        want_b = K.diff_attention_interleaved_bwd_plain(f[0], f[1], f[2], lam, want[1], want[2], f[3])
        want_r = (K.diff_attention_interleaved_bwd_plain(f[0], k, f[2], lam, want[1], want[2], do)[0],
                  K.diff_attention_interleaved_bwd_plain(q, f[1], f[2], lam, want[1], want[2], do)[1],
                  K.diff_attention_interleaved_bwd_plain(f[0], f[1], f[2], lam, want[1], want[2], do)[2])
        torch.cuda.synchronize()
        assert (got[0].float() - want[0]).abs().max() <= _o_limit(dtype, want[0], want_w), (b, n, h, d)
        assert max((a - w).abs().max() for a, w in zip(got[1:], want[1:])) <= 1e-4, (b, n, h, d)
        _assert_grads(grads[:3], want_b[:3], want_r, dtype, (b, n, h, d))
        assert abs(float(grads[3]) - float(want_b[3])) <= 1e-4 * max(1.0, abs(float(want_b[3])))


def _diff_bwd_with_deltas(q, k, v, lam, lse1, lse2, do):
    """K3's C entry as ``diff_attention_interleaved_bwd`` calls it, returning
    the per-row δ₁, δ₂ that its dq kernel writes besides dq, dk and dv."""
    from cenet_tpu_torch.ops import binding

    b, h2, n, d = q.shape
    m, dv = k.shape[2], v.shape[3]
    d1, d2 = (torch.empty((b, h2 // 2, n), dtype=torch.float32, device=q.device) for _ in range(2))
    dq, dk, dvv = (torch.empty(shape, dtype=q.dtype, device=q.device)
                   for shape in ((b, h2, n, d), (b, h2, m, d), (b, h2 // 2, m, dv)))
    rc = K._kernel("diff_attention_bwd", "cenet_diff_attention_bwd")(
        binding.is_bf16(q), *binding.ptrs(q, k, v, do, lam, lse1, lse2, d1, d2, dq, dk, dvv), b, h2 // 2, n, m, d, dv,
        *binding.strides(q), *binding.strides(k), *binding.strides(v), *binding.strides(do), binding.stream())
    binding.raise_on("diff_attention_bwd", rc)
    return dq, dk, dvv, d1, d2


@pytest.mark.cuda
def test_cuda_diff_kernels_repeat_bit_identical(cuda):
    """K1 and K3 in bf16 write each output element from one block (no atomics):
    two runs on the same inputs give the same bits in o and both LSEs, in dq,
    dk, dv, in the per-row δ₁, δ₂ and in dλ."""
    g = torch.Generator().manual_seed(9)
    lam = torch.tensor(0.37, device=cuda)
    for b, n, h, d in [(2, 3136, 8, 8), (2, 784, 8, 16)]:
        q, k, v, do = _dseb_views(g, b, n, h, d, torch.bfloat16, cuda)
        first, again = K.diff_attention_interleaved_fwd(q, k, v, lam), K.diff_attention_interleaved_fwd(q, k, v, lam)
        grads = [K.diff_attention_interleaved_bwd(q, k, v, lam, first[1], first[2], do) for _ in range(2)]
        deltas = [_diff_bwd_with_deltas(q, k, v, lam, first[1], first[2], do) for _ in range(2)]
        torch.cuda.synchronize()
        for a, b_ in zip((*first, *grads[0], *deltas[0]), (*again, *grads[1], *deltas[1])):
            assert torch.equal(a, b_), (b, n, h, d)
        assert torch.equal(grads[0][3], -deltas[0][4].sum())


# K2 and K4 past 128 (the wgmma designs, csrc/attention_wide.cuh): the ResNet-50
# Nonlocal sites (dec1 56² at d = dv = 256, dec2 28² at 512), ragged widths
# (200, 300, 136, 130 against the 64-column tiles and 128-column chunks), N and
# M just past a 64-row own tile and a 128-row streamed tile, a narrow dv beside
# a wide d and the widest dv (512) beside d = 16, whose dk/dv kernel runs two
# column slices
WIDE_ATTN_SHAPES = [(1, 1, 3136, 3136, 256, 256), (2, 1, 784, 784, 512, 512), (1, 1, 130, 70, 200, 300),
                    (1, 2, 65, 63, 512, 136), (1, 1, 1, 65, 130, 16), (2, 1, 100, 129, 16, 260),
                    (1, 1, 65, 129, 256, 256), (1, 1, 129, 65, 200, 136), (2, 1, 64, 257, 16, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_wide_attention_kernels_match_twins(cuda, dtype):
    """K2 and K4 at head dims past 128 against their twins, with the limits of
    the narrow kernels; the token views of a one-head Nonlocal at d = 256 (TMA
    loads) and of a two-head one at C = 130 (rows of 260 bytes: cp.async of 4
    bytes) too."""
    g = torch.Generator().manual_seed(11)
    cases = [[(torch.randn(b, h, n, d, generator=g) * d**-0.5).to(cuda, dtype),
              torch.randn(b, h, m, d, generator=g).to(cuda, dtype), torch.randn(b, h, m, dv, generator=g).to(cuda, dtype),
              torch.randn(b, h, n, dv, generator=g).to(cuda, dtype)] for b, h, n, m, d, dv in WIDE_ATTN_SHAPES]
    cases.append(list(_token_views(g, 2, 1, 196, 256, dtype, cuda)))
    cases.append(list(_token_views(g, 1, 2, 130, 130, dtype, cuda)))
    for q, k, v, do in cases:
        where = (tuple(q.shape), tuple(v.shape))
        f = [t.float().contiguous() for t in (q, k, v, do)]
        o, lse = K.attention_fwd(q, k, v)
        want = K.attention_fwd_plain(f[0], f[1], f[2])
        want_w = K.attention_fwd_plain(f[0], f[1], v.contiguous())[0]
        got = K.attention_bwd(q, k, v, o, lse, do)
        want_b = K.attention_bwd_plain(f[0], f[1], f[2], o.float(), lse, f[3])
        want_r = (K.attention_bwd_plain(f[0], k, f[2], o, lse, do)[0],
                  K.attention_bwd_plain(q, f[1], f[2], o, lse, do)[1],
                  K.attention_bwd_plain(f[0], f[1], f[2], o, lse, do)[2])
        torch.cuda.synchronize()
        assert (o.float() - want[0]).abs().max() <= _o_limit(dtype, want[0], want_w), where
        assert (lse - want[1]).abs().max() <= 1e-4, where
        _assert_grads(got, want_b, want_r, dtype, where)


@pytest.mark.cuda
def test_cuda_wide_attention_repeats_and_limits(cuda):
    """The wide K2 and K4 in bf16 repeat to the bit (each output element from one
    block; the forward's row max and sum combined across its two warpgroups in
    a fixed order); past 512 both raise, naming the ROADMAP item."""
    g = torch.Generator().manual_seed(12)
    q, k, v, do = _token_views(g, 2, 1, 784, 512, torch.bfloat16, cuda)
    o, lse = K.attention_fwd(q, k, v)
    o2, lse2 = K.attention_fwd(q, k, v)
    first, again = K.attention_bwd(q, k, v, o, lse, do), K.attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    for a, b_ in zip(first, again):
        assert torch.equal(a, b_)
    big = torch.zeros(1, 1, 8, 520, device=cuda)
    with pytest.raises(ValueError, match="item 13"):
        K.attention_fwd(big, big, big)
    with pytest.raises(ValueError, match="item 13"):
        K.attention_bwd(big, big, big, big, torch.zeros(1, 1, 8, device=cuda), big)
    # one side past 512 beside d or dv = 200, which the kernels take
    mid = torch.zeros(1, 1, 8, 200, device=cuda)
    with pytest.raises(ValueError, match="item 13"):
        K.attention_fwd(big, big, mid)
    with pytest.raises(ValueError, match="item 13"):
        K.attention_fwd(mid, mid, big)
    with pytest.raises(ValueError, match="item 13"):
        K.attention_bwd(mid, mid, big, big, torch.zeros(1, 1, 8, device=cuda), big)


@pytest.mark.cuda
def test_cuda_router_sends_resnet50_dec1_nonlocal_to_k2(cuda, monkeypatch):
    """A Nonlocal block at ResNet-50's dec1 (C = 256 at 56², a 39 MB map per
    image, above the router's 32 MiB) reaches K2 on the card, and K4 when
    autograd records; fp32 output and gradients agree with the CPU's plain path
    (cuDNN's TF32 off for the block's output conv)."""
    from cenet_tpu_torch.nn.attention import Nonlocal

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    torch.manual_seed(0)
    cpu = Nonlocal(256, attn_impl="pallas").eval()
    card = Nonlocal(256, attn_impl="pallas").eval()
    card.load_state_dict(cpu.state_dict())
    card = card.to(cuda)
    x = torch.randn(1, 256, 56, 56, generator=torch.Generator().manual_seed(1))
    xc = x.to(cuda).requires_grad_()
    xh = x.clone().requires_grad_()
    K.reset_launches()
    out = card(xc)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert K.LAUNCHES["attention_fwd"] == 1 and K.LAUNCHES["attention_bwd"] == 1
    want = cpu(xh)
    want.square().sum().backward()
    assert (out.detach().cpu() - want.detach()).abs().max() <= 1e-4 * max(1.0, float(want.abs().max()))
    assert (xc.grad.cpu() - xh.grad).abs().max() <= 1e-4 * max(1.0, float(xh.grad.abs().max()))


@pytest.mark.cuda
def test_cuda_attention_backward_repeats_bit_identical(cuda):
    """K4 in bf16 writes each gradient element from one block (no atomics): two
    runs on the same inputs give the same bits in dq, dk and dv."""
    g = torch.Generator().manual_seed(7)
    q, k, v, do = _token_views(g, 2, 1, 3136, 64, torch.bfloat16, cuda)
    o, lse = K.attention_fwd(q, k, v)
    first, again = K.attention_bwd(q, k, v, o, lse, do), K.attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for a, b_ in zip(first, again):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_cuda_functions_take_strided_views_and_match_cpu(cuda):
    """The autograd Functions on the card (K1/K3, K2/K4, strided q/k/v and a
    strided dO) against the same Functions on the CPU (the twins), fp32."""
    g = torch.Generator().manual_seed(4)
    b, n, h, d = 2, 150, 4, 20
    base = [torch.randn(b, n, 2 * h, d, generator=g), torch.randn(b, n, 2 * h, d, generator=g),
            torch.randn(b, n, h, 2 * d, generator=g), torch.randn(b, n, h, 2 * d, generator=g)]
    lam0 = torch.tensor(0.45)
    grads = []
    for dev in ("cpu", cuda):
        q, k, v = [t.to(dev, copy=True).requires_grad_() for t in base[:3]]
        lam = lam0.to(dev, copy=True).requires_grad_()
        o = K.DiffAttentionInterleavedFn.apply(q.transpose(1, 2) * d**-0.5, k.transpose(1, 2), v.transpose(1, 2), lam)
        o.backward(base[3].to(dev).transpose(1, 2))
        grads.append([t.grad.cpu() for t in (q, k, v, lam)])
    for a, w in zip(grads[1], grads[0]):
        assert (a - w).abs().max() <= 1e-4 * max(1.0, float(w.abs().max()))
    grads = []
    for dev in ("cpu", cuda):
        q, k, v = [t[:, :, :1].to(dev, copy=True).requires_grad_() for t in base[:3]]
        o = K.AttentionFn.apply(q.transpose(1, 2) * d**-0.5, k.transpose(1, 2), v.transpose(1, 2)[..., :d])
        o.backward(base[3][:, :, :1, :d].to(dev).transpose(1, 2))
        grads.append([t.grad.cpu() for t in (q, k, v)])
    for a, w in zip(grads[1], grads[0]):
        assert (a - w).abs().max() <= 1e-4 * max(1.0, float(w.abs().max()))


def _split_inputs(g, b, h, n, m, d, dv, dtype, device):
    """Interleaved projections as the model lays them out ((B, N, 2h, d) viewed as
    (B, 2h, N, d)), their split head views, v and a strided dO."""
    q = (torch.randn(b, n, 2 * h, d, generator=g) * d**-0.5).to(device, dtype).transpose(1, 2)
    k = torch.randn(b, m, 2 * h, d, generator=g).to(device, dtype).transpose(1, 2)
    v = torch.randn(b, h, m, dv, generator=g).to(device, dtype)
    do = torch.randn(b, n, h, dv, generator=g).to(device, dtype).transpose(1, 2)
    return q, k, v, do, (q[:, 0::2], k[:, 0::2], q[:, 1::2], k[:, 1::2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_split_forward_matches_twin_and_pair_kernel(cuda, dtype):
    """K5 on the 0::2 / 1::2 head views against its twin (o within ``_o_limit``,
    LSEs within 1e-4), and against K1 on the same interleaved inputs where
    dv = 2d: the same kernel in each dtype, so equal to the bit."""
    g = torch.Generator().manual_seed(5)
    lam = torch.tensor(0.37, device=cuda)
    for b, h, n, m, d in DIFF_SHAPES:
        q, k, v, _, groups = _split_inputs(g, b, h, n, m, d, 2 * d, dtype, cuda)
        got = K.diff_attention_fwd(*groups, v, lam)
        want = K.diff_attention_fwd_plain(*(t.float() for t in groups), v.float(), lam)
        want_w = K.diff_attention_fwd_plain(*(t.float() for t in groups), v, lam)[0]
        pair = K.diff_attention_interleaved_fwd(q, k, v, lam)
        torch.cuda.synchronize()
        lim = _o_limit(dtype, want[0], want_w)
        assert (got[0].float() - want[0]).abs().max() <= lim
        assert max((a - b_).abs().max() for a, b_ in zip(got[1:], want[1:])) <= 1e-4
        assert (got[0].float() - pair[0].float()).abs().max() <= lim
        assert max((a - b_).abs().max() for a, b_ in zip(got[1:], pair[1:])) <= 1e-4
        assert all(torch.equal(a, b_) for a, b_ in zip(got, pair)), (b, h, n, m, d)


def _split_refs(groups, v, lam, lse1, lse2, do):
    """(want, want_r) for the split backward, as ``bwd_refs`` in ``chip_smoke.py``:
    the twin on fp32 copies, and per gradient the twin that rounds ds (dq: to k's
    dtype, dk: to q's) or P (dv: to dO's) as the kernel does."""
    q1, k1, q2, k2 = groups
    f = [t.float() for t in groups]
    plain = K.diff_attention_bwd_plain
    want = plain(*f, v.float(), lam, lse1, lse2, do.float())
    r_dq = plain(f[0], k1, f[2], k2, v.float(), lam, lse1, lse2, do)
    r_dk = plain(q1, f[1], q2, f[3], v.float(), lam, lse1, lse2, do)
    r_dv = plain(*f, v.float(), lam, lse1, lse2, do)
    return want, (r_dq[0], r_dk[1], r_dq[2], r_dk[3], r_dv[4])


def _assert_split_grads(got, want, want_r, dtype, where):
    for name, a, w, (lim, nlim) in zip("dq1 dk1 dq2 dk2 dv".split(), got, want, _grad_limits(dtype, want[:5], want_r)):
        assert a.dtype == dtype and a.shape == w.shape
        assert (a.float() - w).abs().max() <= lim, (name, where)
        assert _rel_norm(a, w) <= nlim, (name, where)
    assert abs(float(got[5]) - float(want[5])) <= 1e-4 * max(1.0, abs(float(want[5]))), ("dlam", where)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_split_backwards_match_twin(cuda, dtype):
    """K6 (one launch, fp32 atomics) and K7 (two launches) against their shared
    twin on strided head views and a strided dO: the five gradients in max-abs
    and in norm, and dλ; K7 against K6 within the same limits."""
    g = torch.Generator().manual_seed(6)
    lam = torch.tensor(0.37, device=cuda)
    for b, h, n, m, d, dv in BWD_DIFF_SHAPES:
        _, _, v, do, groups = _split_inputs(g, b, h, n, m, d, dv, dtype, cuda)
        _, lse1, lse2 = K.diff_attention_fwd_plain(*(t.float() for t in groups), v.float(), lam)
        want, want_r = _split_refs(groups, v, lam, lse1, lse2, do)
        got6 = K.diff_attention_bwd(*groups, v, lam, lse1, lse2, do)
        got7 = K.diff_attention_bwd_split(*groups, v, lam, lse1, lse2, do)
        torch.cuda.synchronize()
        _assert_split_grads(got6, want, want_r, dtype, ("K6", b, h, n, m, d, dv))
        _assert_split_grads(got7, want, want_r, dtype, ("K7", b, h, n, m, d, dv))
        _assert_split_grads(got7, [t.float() for t in got6], want_r, dtype, ("K7 vs K6", b, h, n, m, d, dv))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_attention_backward_matches_twin_and_k4(cuda, dtype):
    """K8 (one launch, dq in fp32 atomics) against K4's twin, and against K4."""
    g = torch.Generator().manual_seed(7)
    for b, h, n, m, d, dv in BWD_ATTN_SHAPES:
        q = (torch.randn(b, h, n, d, generator=g) * d**-0.5).to(cuda, dtype)
        k = torch.randn(b, h, m, d, generator=g).to(cuda, dtype)
        v = torch.randn(b, h, m, dv, generator=g).to(cuda, dtype)
        do = torch.randn(b, h, n, dv, generator=g).to(cuda, dtype)
        f = [t.float() for t in (q, k, v, do)]
        o, lse = K.attention_fwd_plain(f[0], f[1], f[2])
        o = o.to(dtype)
        got = K.attention_bwd_fused(q, k, v, o, lse, do)
        k4 = K.attention_bwd(q, k, v, o, lse, do)
        want = K.attention_bwd_plain(f[0], f[1], f[2], o.float(), lse, f[3])
        want_r = (K.attention_bwd_plain(f[0], k, f[2], o, lse, do)[0],
                  K.attention_bwd_plain(q, f[1], f[2], o, lse, do)[1],
                  K.attention_bwd_plain(f[0], f[1], f[2], o, lse, do)[2])
        torch.cuda.synchronize()
        _assert_grads(got, want, want_r, dtype, (b, h, n, m, d, dv))
        _assert_grads(got, [t.float() for t in k4], want_r, dtype, ("vs K4", b, h, n, m, d, dv))


@pytest.mark.cuda
def test_cuda_split_function_matches_cpu(cuda):
    """``DiffAttentionFn`` on the card (K5/K6 on strided head views, strided dO)
    against the same Function on the CPU (the twins), fp32, gradients reaching
    the interleaved leaves through the views."""
    g = torch.Generator().manual_seed(8)
    b, n, h, d = 2, 150, 4, 20
    base = [torch.randn(b, n, 2 * h, d, generator=g), torch.randn(b, n, 2 * h, d, generator=g),
            torch.randn(b, h, n, 2 * d, generator=g), torch.randn(b, n, h, 2 * d, generator=g)]
    grads = []
    for dev in ("cpu", cuda):
        q, k, v = [t.to(dev, copy=True).requires_grad_() for t in base[:3]]
        lam = torch.tensor(0.45, device=dev, requires_grad=True)
        qt, kt = q.transpose(1, 2) * d**-0.5, k.transpose(1, 2)
        o = K.DiffAttentionFn.apply(qt[:, 0::2], kt[:, 0::2], qt[:, 1::2], kt[:, 1::2], v, lam)
        o.backward(base[3].to(dev).transpose(1, 2))
        grads.append([t.grad.cpu() for t in (q, k, v, lam)])
    for a, w in zip(grads[1], grads[0]):
        assert (a - w).abs().max() <= 1e-4 * max(1.0, float(w.abs().max()))


# (b, h, n, m, d, dv): the tile edges of the tensor-core K7 (K3's kernels) and
# K8 (K4's dk/dv tiles), N of 1, 63, 65, 196, 784 and M of 63, 65, 196, 784,
# every B·h > 1. Not M = 1: one key gives P = 1, so dq and dk vanish
# identically and a limit relative to them means nothing.
K7_EDGE_SHAPES = [(2, 2, 1, 63, 8, 16), (1, 2, 63, 65, 8, 16), (2, 1, 65, 63, 16, 32), (1, 2, 196, 196, 20, 40),
                  (2, 2, 784, 65, 16, 32), (1, 2, 65, 784, 8, 16), (2, 1, 196, 65, 20, 40)]
K8_EDGE_SHAPES = [(2, 1, 1, 65, 64, 64), (1, 2, 63, 65, 64, 64), (2, 1, 65, 63, 128, 128), (1, 2, 196, 196, 64, 64),
                  (2, 2, 784, 65, 64, 64), (2, 1, 65, 784, 128, 128), (1, 2, 196, 63, 128, 128),
                  (2, 1, 784, 784, 64, 64)]


@pytest.mark.cuda
def test_cuda_k7_k8_bf16_tile_edges_match_twins(cuda):
    """K7 and K8 in bf16 (the tensor-core designs) at the tile edges, against
    their twins with the limits above: K7 on strided head views and a strided
    dO, its five gradients and dλ; K8 on its three gradients."""
    g = torch.Generator().manual_seed(10)
    lam = torch.tensor(0.37, device=cuda)
    for b, h, n, m, d, dv in K7_EDGE_SHAPES:
        _, _, v, do, groups = _split_inputs(g, b, h, n, m, d, dv, torch.bfloat16, cuda)
        _, lse1, lse2 = K.diff_attention_fwd_plain(*(t.float() for t in groups), v.float(), lam)
        want, want_r = _split_refs(groups, v, lam, lse1, lse2, do)
        got = K.diff_attention_bwd_split(*groups, v, lam, lse1, lse2, do)
        torch.cuda.synchronize()
        _assert_split_grads(got, want, want_r, torch.bfloat16, ("K7", b, h, n, m, d, dv))
    for b, h, n, m, d, dv in K8_EDGE_SHAPES:
        q = (torch.randn(b, h, n, d, generator=g) * d**-0.5).to(cuda, torch.bfloat16)
        k = torch.randn(b, h, m, d, generator=g).to(cuda, torch.bfloat16)
        v = torch.randn(b, h, m, dv, generator=g).to(cuda, torch.bfloat16)
        do = torch.randn(b, h, n, dv, generator=g).to(cuda, torch.bfloat16)
        f = [t.float() for t in (q, k, v, do)]
        o, lse = K.attention_fwd_plain(f[0], f[1], f[2])
        o = o.bfloat16()
        got = K.attention_bwd_fused(q, k, v, o, lse, do)
        want = K.attention_bwd_plain(f[0], f[1], f[2], o.float(), lse, f[3])
        want_r = (K.attention_bwd_plain(f[0], k, f[2], o, lse, do)[0],
                  K.attention_bwd_plain(q, f[1], f[2], o, lse, do)[1],
                  K.attention_bwd_plain(f[0], f[1], f[2], o, lse, do)[2])
        torch.cuda.synchronize()
        _assert_grads(got, want, want_r, torch.bfloat16, ("K8", b, h, n, m, d, dv))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_split_backward_takes_dseb_views(cuda, dtype):
    """K7 on the split head views of the DSEB projections (``q[:, 0::2]`` …
    ``k[:, 1::2]`` of (B, N, 2h, d) views; d = 8, 16, 20, so group 2 starts d
    elements in and d = 20's 40-byte rows are staged by element loads) and a
    strided dO, against the twin on contiguous copies."""
    g = torch.Generator().manual_seed(11)
    lam = torch.tensor(0.37, device=cuda)
    for b, n, h, d in [(2, 150, 4, 20), (1, 196, 8, 8), (2, 65, 2, 16), (1, 784, 8, 16)]:
        q, k, v, do = _dseb_views(g, b, n, h, d, dtype, cuda)
        groups = (q[:, 0::2], k[:, 0::2], q[:, 1::2], k[:, 1::2])
        _, lse1, lse2 = K.diff_attention_fwd_plain(*(t.float() for t in groups), v.float(), lam)
        got = K.diff_attention_bwd_split(*groups, v, lam, lse1, lse2, do)
        want, want_r = _split_refs([t.contiguous() for t in groups], v.contiguous(), lam, lse1, lse2,
                                   do.contiguous())
        torch.cuda.synchronize()
        _assert_split_grads(got, want, want_r, dtype, ("K7 DSEB views", b, n, h, d))


def _split_bwd_with_deltas(groups, v, lam, lse1, lse2, do, one_launch=False):
    """K7's C entry as ``diff_attention_bwd_split`` calls it (with
    ``one_launch``, K6's as ``diff_attention_bwd`` calls it: dk and dv summed
    into zeroed fp32 buffers, returned in q's dtype), returning the per-row
    δ₁, δ₂ that its dq kernel writes besides the five gradients."""
    from cenet_tpu_torch.ops import binding

    q1, k1, q2, k2 = groups
    b, h, n, d = q1.shape
    m, dv = k1.shape[2], v.shape[3]
    d1, d2 = (torch.empty((b, h, n), dtype=torch.float32, device=q1.device) for _ in range(2))
    dq1, dq2 = (torch.empty((b, h, n, d), dtype=q1.dtype, device=q1.device) for _ in range(2))
    make, acc = (torch.zeros, torch.float32) if one_launch else (torch.empty, q1.dtype)
    dk1, dk2, dvv = (make(shape, dtype=acc, device=q1.device) for shape in ((b, h, m, d), (b, h, m, d), (b, h, m, dv)))
    source = "diff_attention_split_bwd" if one_launch else "diff_attention_split_bwd_two_kernel"
    rc = K._kernel(source, f"cenet_{source}")(
        binding.is_bf16(q1), *binding.ptrs(q1, k1, q2, k2, v, do, lam, lse1, lse2, d1, d2, dq1, dk1, dq2, dk2, dvv),
        b, h, n, m, d, dv, *binding.strides(q1), *binding.strides(k1), *binding.strides(q2), *binding.strides(k2),
        *binding.strides(v), *binding.strides(do), binding.stream())
    binding.raise_on(source, rc)
    return dq1, dk1.to(q1.dtype), dq2, dk2.to(q1.dtype), dvv.to(q1.dtype), d1, d2


@pytest.mark.cuda
def test_cuda_split_backward_repeats_bit_identical(cuda):
    """K7 in bf16 writes each output element from one block (no atomics): two
    runs on the same inputs give the same bits in dq₁, dq₂, dk₁, dk₂, dv, the
    per-row δ₁, δ₂ and dλ, at the DSEB1 and DSEB2 head dims."""
    g = torch.Generator().manual_seed(12)
    lam = torch.tensor(0.37, device=cuda)
    for b, n, h, d in [(2, 3136, 8, 8), (2, 784, 8, 16)]:
        q, k, v, do = _dseb_views(g, b, n, h, d, torch.bfloat16, cuda)
        groups = (q[:, 0::2], k[:, 0::2], q[:, 1::2], k[:, 1::2])
        _, lse1, lse2 = K.diff_attention_fwd(*groups, v, lam)
        grads = [K.diff_attention_bwd_split(*groups, v, lam, lse1, lse2, do) for _ in range(2)]
        deltas = [_split_bwd_with_deltas(groups, v, lam, lse1, lse2, do) for _ in range(2)]
        torch.cuda.synchronize()
        for a, b_ in zip((*grads[0], *deltas[0]), (*grads[1], *deltas[1])):
            assert torch.equal(a, b_), (b, n, h, d)
        assert torch.equal(grads[0][5], -deltas[0][6].sum())


@pytest.mark.cuda
def test_cuda_fused_attention_backward_repeats_dk_dv(cuda):
    """K8 in bf16 writes dk and dv from one block each, so two runs on the same
    inputs give the same bits there; dq sums over key tiles with atomics and
    stays within the twin's limits in both runs."""
    g = torch.Generator().manual_seed(13)
    q, k, v, do = _token_views(g, 2, 1, 3136, 64, torch.bfloat16, cuda)
    o, lse = K.attention_fwd(q, k, v)
    runs = [K.attention_bwd_fused(q, k, v, o, lse, do) for _ in range(2)]
    f = [t.float().contiguous() for t in (q, k, v, do)]
    want = K.attention_bwd_plain(f[0], f[1], f[2], o.float(), lse, f[3])
    want_r = (K.attention_bwd_plain(f[0], k, f[2], o, lse, do)[0],
              K.attention_bwd_plain(q, f[1], f[2], o, lse, do)[1],
              K.attention_bwd_plain(f[0], f[1], f[2], o, lse, do)[2])
    torch.cuda.synchronize()
    assert torch.equal(runs[0][1], runs[1][1]) and torch.equal(runs[0][2], runs[1][2])
    for run in runs:
        _assert_grads(run, want, want_r, torch.bfloat16, "K8 repeat")


def _assert_close(got, want, dtype, where, fp32_rel=1e-4, norm=1e-5):
    """fp32: max |got − want| ≤ ``fp32_rel``·max |want| and ‖got − want‖/‖want‖ ≤
    ``norm``; bf16 outputs: 2·2^-8·max |want|."""
    assert got.shape == want.shape and got.dtype == dtype, where
    e, m = float((got.float() - want.float()).abs().max()), float(want.float().abs().max())
    if dtype == torch.float32:
        assert e <= fp32_rel * m and _rel_norm(got, want) <= norm, (where, e, m)
    else:
        assert e <= 2 * 2.0**-8 * m, (where, e, m)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rms_norm_and_rotary_match_twins(cuda, dtype):
    """K9 with and without a weight, short and long rows, ragged chunks; K10 on
    strided (B, N, H, D) → (B, H, N, D) views; both against their twins."""
    g = torch.Generator().manual_seed(9)
    for shape in [(2, 8, 100, 16), (3, 70, 32), (5, 40), (4, 13), (2, 300), (1, 1024)]:
        x = (3 * torch.randn(*shape, generator=g)).to(cuda, dtype)
        for w in (None, torch.randn(shape[-1], generator=g).to(cuda)):
            got, want = RN.rms_norm(x, w), RN.rms_norm_plain(x, w)
            torch.cuda.synchronize()
            _assert_close(got, want, dtype, ("rms", shape, w is None), fp32_rel=1e-5)
    for b, h, n, d in [(2, 4, 100, 8), (1, 3, 70, 40), (2, 1, 33, 6)]:
        x = torch.randn(b, n, h, d, generator=g).to(cuda, dtype).transpose(1, 2)
        cos, sin = RO.make_rotary_tables(n, d, device=cuda)
        got, want = RO.apply_rotary_emb_kernel(x, cos, sin), RO.apply_rotary_emb_kernel_plain(x, cos, sin)
        torch.cuda.synchronize()
        _assert_close(got, want, dtype, ("rotary", b, h, n, d), fp32_rel=1e-5)
        inter = RO.reinterleave(RO.apply_rotary_emb_kernel(RO.deinterleave(x), cos, sin))
        _assert_close(inter, RO.apply_rotary_emb(x, cos, sin, interleaved=True), dtype,
                      ("interleaved rotary", b, h, n, d), fp32_rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_depthwise_kernels_match_twins(cuda, dtype):
    """K11's forward and dw on NCHW views and channels-last tensors, dilations 1–3,
    against the twins; dw bit-identical over repeat runs; the Function's
    gradients on the card against the same Function on the CPU."""
    g = torch.Generator().manual_seed(10)
    for (b, c, h, w, dil), channels_last in [((2, 5, 9, 11, 1), False), ((1, 40, 14, 10, 2), True),
                                             ((2, 33, 7, 6, 3), False), ((2, 64, 56, 56, 1), True)]:
        base = torch.randn(b, c, h, w, generator=g).to(cuda, dtype)
        x = base.permute(0, 2, 3, 1)
        x = x.contiguous() if channels_last else x
        wt = torch.randn(c, 1, 3, 3, generator=g).to(cuda)
        w_hwio = wt.permute(2, 3, 1, 0)
        gg = torch.randn(b, h, w, c, generator=g).to(cuda, dtype)
        got, dw = DW.depthwise_fwd(x, w_hwio, dil), DW.depthwise_dw(x, gg, dil)
        torch.cuda.synchronize()
        assert got.stride() == x.stride()
        _assert_close(got, DW.depthwise_fwd_plain(x, w_hwio, dil), dtype, ("fwd", b, c, h, w, dil))
        _assert_close(dw, DW.depthwise_dw_plain(x, gg, dil), torch.float32, ("dw", b, c, h, w, dil))
        assert torch.equal(dw, DW.depthwise_dw(x, gg, dil))
    base = torch.randn(2, 12, 15, 13, generator=g)
    wt, gout = torch.randn(12, 1, 3, 3, generator=g), torch.randn(2, 15, 13, 12, generator=g)
    grads = []
    for dev in ("cpu", cuda):
        xb, wb = base.to(dev, copy=True).requires_grad_(), wt.to(dev, copy=True).requires_grad_()
        DW.depthwise_conv3x3(xb.permute(0, 2, 3, 1), wb.permute(2, 3, 1, 0), 2).backward(gout.to(dev))
        grads.append([xb.grad.cpu(), wb.grad.cpu()])
    for a, w_ in zip(grads[1], grads[0]):
        assert (a - w_).abs().max() <= 1e-4 * float(w_.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_smallc_conv_kernels_match_twins(cuda, dtype):
    """K12's forward and fused dx/dw on ragged maps inside the domain (k 3, 5, 7;
    Cin 8–64; Cout 8–64), NCHW views and channels-last, against the twins; dw
    bit-identical over repeat runs; the Function on the card against the CPU."""
    g = torch.Generator().manual_seed(11)
    for (b, cin, cout, h, w, k), channels_last in [((1, 32, 32, 115, 110, 5), False), ((2, 8, 16, 112, 113, 7), True),
                                                   ((1, 64, 40, 120, 112, 3), False), ((1, 16, 8, 112, 112, 3), True)]:
        base = torch.randn(b, cin, h, w, generator=g).to(cuda, dtype)
        x = base.permute(0, 2, 3, 1)
        x = x.contiguous() if channels_last else x
        w_hwio = (0.1 * torch.randn(cout, cin, k, k, generator=g)).to(cuda).permute(2, 3, 1, 0)
        gg = torch.randn(b, cout, h, w, generator=g).to(cuda, dtype).permute(0, 2, 3, 1)
        got = SC.conv_small_c_fwd(x, w_hwio, k // 2)
        dx, dwk = SC.conv_small_c_bwd(x, w_hwio, gg, k // 2)
        dxp, dwp = SC.conv_small_c_bwd_plain(x, w_hwio, gg, k // 2)
        torch.cuda.synchronize()
        where = (b, cin, cout, h, w, k)
        _assert_close(got, SC.conv_small_c_plain(x, w_hwio, k // 2), dtype, ("fwd",) + where)
        _assert_close(dx, dxp, dtype, ("dx",) + where)
        _assert_close(dwk, dwp, torch.float32, ("dw",) + where)
        assert torch.equal(dwk, SC.conv_small_c_bwd(x, w_hwio, gg, k // 2)[1])
    base = torch.randn(1, 16, 112, 114, generator=g)
    wt, gout = 0.1 * torch.randn(24, 16, 5, 5, generator=g), torch.randn(1, 112, 114, 24, generator=g)
    grads = []
    for dev in ("cpu", cuda):
        xb, wb = base.to(dev, copy=True).requires_grad_(), wt.to(dev, copy=True).requires_grad_()
        SC.conv_small_c(xb.permute(0, 2, 3, 1), wb.permute(2, 3, 1, 0), 2).backward(gout.to(dev))
        grads.append([xb.grad.cpu(), wb.grad.cpu()])
    for a, w_ in zip(grads[1], grads[0]):
        assert (a - w_).abs().max() <= 1e-4 * float(w_.abs().max())


# (b, h, n, m, d, dv): the tile edges of the tensor-core K6 (64 query rows a
# block, 64-key tiles, 16-key blocks of its dk/dv partials): N and M of 63, 65,
# 127 and 129, at DSEB1's head dims and at d = dv = 64; every B·h > 1
K6_EDGE_SHAPES = [(2, 1, 63, 65, 8, 16), (1, 2, 65, 63, 8, 16), (1, 2, 127, 129, 8, 16), (2, 1, 129, 127, 8, 16),
                  (2, 1, 63, 129, 64, 64), (1, 2, 129, 65, 64, 64), (2, 1, 127, 63, 64, 64), (1, 2, 65, 127, 64, 64)]


@pytest.mark.cuda
def test_cuda_k6_bf16_tile_edges_match_twin_and_k7(cuda):
    """K6 in bf16 (the one-launch tensor-core design) at its tile edges, on
    strided head views and a strided dO, and on the split head views of the
    DSEB projections: the five gradients against the twin in max-abs and in
    norm, dλ within 1e-4, and against K7 on the same inputs under the same
    limits."""
    g = torch.Generator().manual_seed(14)
    lam = torch.tensor(0.37, device=cuda)
    cases = [(_split_inputs(g, *shape, torch.bfloat16, cuda)[2:], shape) for shape in K6_EDGE_SHAPES]
    for b, n, h, d in [(2, 150, 4, 20), (1, 196, 8, 8), (2, 65, 2, 16), (1, 784, 8, 16)]:
        q, k, v, do = _dseb_views(g, b, n, h, d, torch.bfloat16, cuda)
        cases.append(((v, do, (q[:, 0::2], k[:, 0::2], q[:, 1::2], k[:, 1::2])), ("DSEB views", b, n, h, d)))
    for (v, do, groups), where in cases:
        _, lse1, lse2 = K.diff_attention_fwd_plain(*(t.float() for t in groups), v.float(), lam)
        want, want_r = _split_refs([t.contiguous() for t in groups], v.contiguous(), lam, lse1, lse2, do.contiguous())
        got6 = K.diff_attention_bwd(*groups, v, lam, lse1, lse2, do)
        got7 = K.diff_attention_bwd_split(*groups, v, lam, lse1, lse2, do)
        torch.cuda.synchronize()
        _assert_split_grads(got6, want, want_r, torch.bfloat16, ("K6", where))
        _assert_split_grads(got6, [t.float() for t in got7], want_r, torch.bfloat16, ("K6 vs K7", where))


@pytest.mark.cuda
def test_cuda_k6_repeats_dq_delta_dlam(cuda):
    """K6 in bf16 writes dq₁, dq₂ and the per-row δ₁, δ₂ from one block each, so
    two runs on the same inputs give the same bits there and in dλ; dk₁, dk₂
    and dv sum over query blocks with atomics and stay within the twin's
    limits in both runs. At the DSEB1 and DSEB2 head dims."""
    g = torch.Generator().manual_seed(15)
    lam = torch.tensor(0.37, device=cuda)
    for b, n, h, d in [(2, 3136, 8, 8), (2, 784, 8, 16)]:
        q, k, v, do = _dseb_views(g, b, n, h, d, torch.bfloat16, cuda)
        groups = (q[:, 0::2], k[:, 0::2], q[:, 1::2], k[:, 1::2])
        _, lse1, lse2 = K.diff_attention_fwd(*groups, v, lam)
        grads = [K.diff_attention_bwd(*groups, v, lam, lse1, lse2, do) for _ in range(2)]
        deltas = [_split_bwd_with_deltas(groups, v, lam, lse1, lse2, do, one_launch=True) for _ in range(2)]
        want, want_r = _split_refs([t.contiguous() for t in groups], v.contiguous(), lam, lse1, lse2, do.contiguous())
        torch.cuda.synchronize()
        for i in (0, 2, 5):  # dq1, dq2, dlam
            assert torch.equal(grads[0][i], grads[1][i]), (i, b, n, h, d)
        for a, b_ in zip(deltas[0][5:], deltas[1][5:]):  # delta1, delta2
            assert torch.equal(a, b_), (b, n, h, d)
        assert torch.equal(deltas[0][0], grads[0][0]) and torch.equal(grads[0][5], -deltas[0][6].sum())
        for run in grads:
            _assert_split_grads(run, want, want_r, torch.bfloat16, ("K6 repeat", b, n, h, d))


@pytest.mark.cuda
def test_cuda_smallc_conv_fwd_bf16_every_k_and_cin(cuda):
    """K12's bf16 forward (the tensor-core implicit GEMM) at every kernel size
    (3, 5, 7) and input width (8, 16, 32, 64) of its domain, on ragged maps of
    at least 112², as NCHW views and channels-last, Cout from 8 to 256 (one or
    several 32- or 64-channel blocks, the last one partial): within two bf16
    half-ulps of max |want| of the twin, the output in x's memory order, and
    bit-identical over two runs."""
    g = torch.Generator().manual_seed(16)
    couts = [8, 24, 32, 40, 64, 72, 136, 256]
    for i, (k, cin) in enumerate([(k, c) for k in (3, 5, 7) for c in (8, 16, 32, 64)]):
        cout = couts[i % len(couts)]
        h, w = 112 + i % 3, 113 + 2 * (i % 4)
        for channels_last in (False, True):
            x = torch.randn(1, cin, h, w, generator=g).to(cuda, torch.bfloat16).permute(0, 2, 3, 1)
            x = x.contiguous() if channels_last else x
            w_hwio = (0.1 * torch.randn(cout, cin, k, k, generator=g)).to(cuda).permute(2, 3, 1, 0)
            got, again = SC.conv_small_c_fwd(x, w_hwio, k // 2), SC.conv_small_c_fwd(x, w_hwio, k // 2)
            want = SC.conv_small_c_plain(x, w_hwio, k // 2)
            torch.cuda.synchronize()
            where = ("fwd", k, cin, cout, h, w, channels_last)
            assert got.stride() == SC._out_like(x, cout).stride(), where
            _assert_close(got, want, torch.bfloat16, where)
            assert torch.equal(got, again), where


@pytest.mark.cuda
def test_cuda_smallc_conv_bwd_bf16_every_k_and_cin(cuda):
    """K12's bf16 backward at every kernel size (3, 5, 7) and input width (8, 16,
    32, 64) of its domain, on ragged maps of at least 112², as NCHW views and
    channels-last: dx on the tensor cores where Cout is 8, 16, 32 or 64 and on
    the CUDA-core dx blocks at Cout 24 and 128 (the shape rule), dw on the
    tensor cores; dx within two bf16 half-ulps of max |want| of the twin and in
    x's memory order, dw within the fp32 limits, both bit-identical over two
    runs."""
    g = torch.Generator().manual_seed(17)
    couts = [8, 16, 32, 64, 24, 128]
    for i, (k, cin) in enumerate([(k, c) for k in (3, 5, 7) for c in (8, 16, 32, 64)]):
        cout = couts[i % len(couts)]
        h, w = 112 + i % 3, 113 + 2 * (i % 4)
        for channels_last in (False, True):
            x = torch.randn(1, cin, h, w, generator=g).to(cuda, torch.bfloat16).permute(0, 2, 3, 1)
            gg = torch.randn(1, cout, h, w, generator=g).to(cuda, torch.bfloat16).permute(0, 2, 3, 1)
            if channels_last:
                x, gg = x.contiguous(), gg.contiguous()
            w_hwio = (0.1 * torch.randn(cout, cin, k, k, generator=g)).to(cuda).permute(2, 3, 1, 0)
            dx, dwk = SC.conv_small_c_bwd(x, w_hwio, gg, k // 2)
            dx2, dwk2 = SC.conv_small_c_bwd(x, w_hwio, gg, k // 2)
            dxp, dwp = SC.conv_small_c_bwd_plain(x, w_hwio, gg, k // 2)
            torch.cuda.synchronize()
            where = ("bwd", k, cin, cout, h, w, channels_last, SC.dx_on_tensor_cores(x.dtype, cout))
            assert dx.stride() == SC._out_like(x, cin).stride(), where
            _assert_close(dx, dxp, torch.bfloat16, ("dx",) + where)
            _assert_close(dwk, dwp, torch.float32, ("dw",) + where)
            assert torch.equal(dx, dx2) and torch.equal(dwk, dwk2), where


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_depthwise_fwd_every_dilation_and_layout(cuda, dtype):
    """K11's forward at dilations 1–5, as NCHW views and channels-last, at widths
    that are not multiples of the 16-byte vector (8 bf16, 4 fp32), at 7² and
    14² planes with many channels and at a map wider than one block's rows:
    within the limits of the twin, the output in x's memory order, and
    bit-identical over two runs."""
    g = torch.Generator().manual_seed(18)
    shapes = [(2, 24, 13, 19), (1, 2048, 7, 7), (2, 1280, 14, 14), (1, 40, 30, 29), (1, 16, 5, 227),
              (1, 64, 56, 56), (1, 4, 150, 70), (2, 3, 9, 6)]
    for i, (b, c, h, w) in enumerate(shapes):
        for dil in range(1, 6):
            if dil >= max(h, w):
                continue
            for channels_last in (False, True):
                x = torch.randn(b, c, h, w, generator=g).to(cuda, dtype).permute(0, 2, 3, 1)
                x = x.contiguous() if channels_last else x
                w_hwio = torch.randn(c, 1, 3, 3, generator=g).to(cuda).permute(2, 3, 1, 0)
                got, again = DW.depthwise_fwd(x, w_hwio, dil), DW.depthwise_fwd(x, w_hwio, dil)
                want = DW.depthwise_fwd_plain(x, w_hwio, dil)
                torch.cuda.synchronize()
                where = ("dw fwd", b, c, h, w, dil, channels_last)
                assert got.stride() == x.stride(), where
                _assert_close(got, want, dtype, where)
                assert torch.equal(got, again), where


def _dw_input(shape, layout, dtype, g, dev):
    """NHWC values laid out as channels-last, as the view of NCHW memory, or as a
    channel slice of a wider channels-last tensor (unit channel stride, no
    16-byte channel vectors)."""
    b, h, w, c = shape
    if layout == "cl":
        return torch.randn(b, h, w, c, generator=g).to(dev, dtype)
    if layout == "nchw":
        return torch.randn(b, c, h, w, generator=g).to(dev, dtype).permute(0, 2, 3, 1)
    return torch.randn(b, h, w, c + 9, generator=g).to(dev, dtype)[..., 5:5 + c]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_depthwise_dw_every_dilation_and_layout(cuda, dtype):
    """K11's dw at dilations 1–5 on both routes of its layout rule (both
    channels-last, channel slices, both NCHW views, and the two mixed layouts,
    which take the plane route), C not a multiple of the 16-byte vector, W
    smaller than a task of 8 positions, and one site of each size class of the
    train step at batch 8: within the fp32 limits of the twin, through the route
    the rule names, and bit-identical over two runs."""
    g = torch.Generator().manual_seed(19)
    routes = {("cl", "cl"): "channels_last", ("slice", "cl"): "channels_last", ("nchw", "nchw"): "planes",
              ("nchw", "cl"): "planes", ("cl", "nchw"): "planes"}
    cases = [((2, 13, 19, 24), d, *lay) for d in range(1, 6) for lay in routes]
    cases += [((2, 9, 3, 20), 1, "cl", "cl"), ((1, 6, 5, 13), 2, "nchw", "nchw"), ((3, 7, 6, 5), 3, "nchw", "cl"),
              ((2, 11, 4, 36), 4, "slice", "cl")]
    cases += [((8, 56, 56, 512), 1, "cl", "cl"), ((8, 28, 28, 1024), 1, "cl", "cl"), ((8, 14, 14, 1280), 1, "cl", "cl"),
              ((8, 7, 7, 2048), 1, "cl", "cl"), ((8, 56, 56, 256), 1, "nchw", "nchw"),
              ((8, 56, 56, 128), 1, "nchw", "cl"), ((8, 7, 7, 2048), 1, "nchw", "nchw"),
              ((8, 56, 56, 20), 5, "slice", "cl"), ((8, 14, 14, 100), 3, "nchw", "nchw")]
    for shape, dil, xl, gl in cases:
        x, gg = _dw_input(shape, xl, dtype, g, cuda), _dw_input(shape, gl, dtype, g, cuda)
        where = ("dw", shape, dil, xl, gl)
        before = dict(DW.DW_ROUTES)
        got, again = DW.depthwise_dw(x, gg, dil), DW.depthwise_dw(x, gg, dil)
        want = DW.depthwise_dw_plain(x.float(), gg.float(), dil)
        torch.cuda.synchronize()
        assert DW.DW_ROUTES[routes[xl, gl]] - before.get(routes[xl, gl], 0) == 2, where
        _assert_close(got, want, torch.float32, where)
        assert torch.equal(got, again), where


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rotary_bit_equal_every_head_dim(cuda, dtype):
    """K10 at D = 8, 16, 32, 64 and 128 (and D = 6, 10, whose halves take no
    16-byte vector), an odd N, contiguous x, a transposed (B, N, H, D) view and a
    view at an odd element offset, with the tables in fp32 (rounded in the
    kernel) and in x's dtype: equal to its twin to the bit."""
    g = torch.Generator().manual_seed(20)
    b, h, n = 2, 3, 97
    for d in (8, 16, 32, 64, 128, 6, 10):
        cos, sin = RO.make_rotary_tables(n, d, device=cuda)
        cos, sin = 3 * cos, 2 * sin  # entries that bf16 rounds
        for view in ("contiguous", "transposed", "offset"):
            if view == "contiguous":
                x = torch.randn(b, h, n, d, generator=g).to(cuda, dtype)
            elif view == "transposed":
                x = torch.randn(b, n, h, d, generator=g).to(cuda, dtype).transpose(1, 2)
            else:
                x = torch.randn(b, h, n, d + 1, generator=g).to(cuda, dtype)[..., 1:]
            # the kernel's runs first: its outputs cannot land in a buffer that
            # holds the twin's result
            got = {t: RO.apply_rotary_emb_kernel(x, cos.to(t), sin.to(t)) for t in (torch.float32, dtype)}
            want = RO.apply_rotary_emb_kernel_plain(x, cos, sin)
            torch.cuda.synchronize()
            for t, out in got.items():
                assert out.is_contiguous() and torch.equal(out, want), (d, view, t, dtype)


@pytest.mark.cuda
def test_cuda_volume_overlap_equals_serial_in_bf16(cuda):
    cfg = get_preset("synapse")
    model = build_model(cfg.replace(model=dataclasses.replace(cfg.model, encoder="pvt_v2_b0")), device=cuda, seed=0)
    predict = make_predict_fn(model, torch.bfloat16)
    image = np.random.default_rng(0).integers(-200, 700, (40, 300, 260)).astype(np.float32)
    labels = {}
    for run in ("serial", "overlapped"):
        inf = VolumeInferencer(predict, VolumeInferenceConfig(img_size=224, chunk=16, num_classes=9), device=cuda)
        K.reset_launches()
        labels[run] = inf._predict_chunked(image, getattr(inf, f"_run_{run}"))
        assert K.LAUNCHES["diff_attention_interleaved_fwd"] > 0 and K.LAUNCHES["attention_fwd"] > 0
    assert labels["overlapped"].shape == image.shape
    np.testing.assert_array_equal(labels["overlapped"], labels["serial"])


@pytest.mark.cuda
@pytest.mark.parametrize("run", ["serial", "overlapped"])
def test_cuda_volume_uint16_decode_is_exact(cuda, run):
    """Codes up to 65535 (past int16's range) decode on the card to the integer volume."""
    image = np.random.default_rng(1).integers(-30000, 35536, (5, 48, 48)).astype(np.float32)
    image[0, 0, :2] = -30000, 35535  # the full uint16 span
    seen = []

    def predict(x):
        seen.append(x[:, 0].cpu())
        return torch.zeros(x.shape[0], 2, *x.shape[2:], device=x.device)

    vcfg = VolumeInferenceConfig(img_size=48, chunk=4, normalize=False, num_classes=2, transfer_dtype="uint16")
    inf = VolumeInferencer(predict, vcfg, device=cuda)
    enc, scale, offset = inf._encode(image)
    assert enc.dtype == np.uint16 and scale == 1.0 and int(enc.max()) == 65535
    inf._predict_chunked(image, getattr(inf, f"_run_{run}"))
    np.testing.assert_array_equal(torch.cat(seen)[:5].numpy(), image)


@pytest.mark.cuda
def test_cuda_volume_staging_buffers_are_reused(cuda):
    vcfg = VolumeInferenceConfig(img_size=32, chunk=4, normalize=False, num_classes=2)
    inf = VolumeInferencer(lambda x: torch.cat([x, -x], dim=1), vcfg, device=cuda)
    rng = np.random.default_rng(2)
    inf.predict_volume(rng.standard_normal((10, 40, 40)).astype(np.float32))
    assert inf.staging.allocations == 2 + 3  # two upload buffers, one output buffer per chunk
    for _ in range(2):
        inf.predict_volume(rng.standard_normal((10, 40, 40)).astype(np.float32))
    assert inf.staging.allocations == 5
    bufs = [b[0] for ring in inf.staging._inputs.values() for b in ring]
    bufs += [b for out in inf.staging._outputs.values() for b in out]
    assert len(bufs) == 5 and all(b.is_pinned() for b in bufs)


# two steps of CENet-b0 at 224², batch 2, bf16, drop-path 0.1, with and without
# ``train.remat``, in a fresh process: CUBLAS_WORKSPACE_CONFIG must be set
# before the process first touches cuBLAS
_REMAT_STEPS = r"""
import dataclasses, json, os
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
import numpy as np, torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.use_deterministic_algorithms(True)
from cenet_tpu_torch.core.config import get_preset
from cenet_tpu_torch.ops import attention_kernels as K
from cenet_tpu_torch.train.trainer import Trainer
rng = np.random.default_rng(0)
x = torch.from_numpy(rng.standard_normal((2, 1, 224, 224)).astype(np.float32)).cuda()
y = torch.from_numpy(rng.integers(0, 9, (2, 224, 224))).cuda()
out = {}
for remat in (False, True):
    base = get_preset("synapse")
    cfg = base.replace(model=dataclasses.replace(base.model, encoder="pvt_v2_b0"),
                       train=dataclasses.replace(base.train, remat=remat))
    t = Trainer(cfg, 10, device="cuda", model_seed=0)
    K.reset_launches()
    losses = [t.train_step(x, y).item() for _ in range(2)]
    state = {**t.model.state_dict(), **{n + "." + k: v for n, s in t.optimizer.state.items() for k, v in s.items()}}
    out[remat] = (losses, dict(K.LAUNCHES), state)
(la, ka, a), (lb, kb, b) = out[False], out[True]
print(json.dumps({"losses": [la, lb], "launches": [ka, kb], "tensors": len(a),
                  "unequal": sorted(k for k in a if not torch.equal(a[k], b[k]))}))
"""


@pytest.mark.cuda
def test_cuda_remat_step_equals_the_plain_step(cuda):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _REMAT_STEPS], cwd=repo, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["losses"][0] == got["losses"][1] and got["unequal"] == [], got
    assert got["launches"][0] == got["launches"][1] and got["launches"][0]["diff_attention_interleaved_bwd"] == 4, got


@pytest.mark.cuda
def test_cuda_model_cost_equals_the_cpu_count(cuda, monkeypatch):
    """The card's model reads the CPU's count, with its sites routed as the
    card routes them and with every site routed."""
    from cenet_tpu_torch.core.stats import model_cost
    from cenet_tpu_torch.ops import router

    cfg = get_preset("synapse")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, encoder="pvt_v2_b0"))
    want = model_cost(build_model(cfg, device="cpu", seed=0), (1, 1, 224, 224))
    model = build_model(cfg, device=cuda, seed=0)
    K.reset_launches()
    assert model_cost(model, (1, 1, 224, 224)) == want
    monkeypatch.setattr(router, "_SMALL_LIMIT", 0)
    assert model_cost(model, (1, 1, 224, 224)) == want
    assert not any(K.LAUNCHES.values()), K.LAUNCHES


@pytest.mark.cuda
def test_cuda_device_augment_matches_the_cpu(cuda):
    """For the same per-sample choices: labels equal, images within 1e-5 of max |x|."""
    from cenet_tpu_torch.data import device_augment as DA

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((16, 1, 96, 96)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 9, (16, 96, 96)))
    choices = DA.draw_choices(torch.Generator(device=cuda).manual_seed(0), 16)
    img, lab = DA.apply_choices(x.to(cuda), y.to(cuda), choices, 64)
    want_img, want_lab = DA.apply_choices(x, y, {k: v.cpu() for k, v in choices.items()}, 64)
    assert torch.equal(lab.cpu(), want_lab)
    assert float((img.cpu() - want_img).abs().max()) <= 1e-5 * float(want_img.abs().max())


@pytest.mark.cuda
def test_cuda_ring_without_a_mesh_takes_the_kernels(cuda):
    """``'ring'`` where the ring does not run (no mesh registered) and the map
    is above the router's 32 MB keeps the card's kernels: a ``Nonlocal``-like
    site (batch 2, 3136² tokens, d 64) launches K2 and K4, and the diff
    route (DSEB1 of CENet-b0 at 224²: 3136 tokens, head dim 8) K1 and K3,
    each equal to the bit to ``'pallas'`` on the same inputs, forward and
    gradients (the same kernels on the same tensors)."""
    from cenet_tpu_torch.core import mesh as M
    from cenet_tpu_torch.nn.attention import get_attention_core
    from cenet_tpu_torch.ops import router

    M.set_attention_mesh(None)
    gen = torch.Generator(device=cuda).manual_seed(0)
    qkv = [torch.randn(2, 1, 3136, 64, generator=gen, device=cuda) for _ in range(3)]
    diff = [torch.randn(s, generator=gen, device=cuda) for s in ((2, 8, 3136, 8), (2, 8, 3136, 8), (2, 4, 3136, 16))]
    lam = torch.tensor(0.35, device=cuda)
    cases = [("attention", lambda impl, q, k, v: get_attention_core(impl)(q, k, v), qkv,
              {"attention_fwd": 1, "attention_bwd": 1}),
             ("diff", lambda impl, q, k, v, lam: router.diff_attention_interleaved(q, k, v, lam, impl=impl),
              diff + [lam], {"diff_attention_interleaved_fwd": 1, "diff_attention_interleaved_bwd": 1})]
    for name, run, inputs, launches in cases:
        got = {}
        for impl in ("ring", "pallas"):
            xs = [t.clone().requires_grad_() for t in inputs]
            K.reset_launches()
            out = run(impl, *xs)
            out.backward(torch.ones_like(out))
            torch.cuda.synchronize()
            assert {k: n for k, n in K.LAUNCHES.items() if n} == launches, (name, impl, dict(K.LAUNCHES))
            got[impl] = [out.detach()] + [x.grad for x in xs]
        assert all(torch.equal(a, b) for a, b in zip(got["ring"], got["pallas"])), name


@pytest.mark.cuda
def test_cuda_ring_two_ranks_share_the_card_over_gloo(cuda):
    """``chip_smoke.py`` phase 6i (b) at small size: two ranks on ``cuda:0``
    over gloo, mesh (1, 1, 2) with ``attn_impl='ring'`` (K2 and K4 on every
    hop of every ring site, the hops through host copies), 2 fp32 SGD steps of
    CENet-b0 at 64 px against the one-process steps on the card under
    ``test_cuda_two_ranks_share_the_card_over_gloo``'s limits, and the two
    ranks' states equal to the bit."""
    import torch_mesh_ranks as R

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(attn_impl="ring")
    got = R.run_ranks("rank_train", 2, {"cases": [(kw, (1, 1, 2))], "device": "cuda:0"}, device="cuda:0",
                      backend="gloo")
    want = R.train(R.dp_config(**kw), device="cuda")
    for rank in got:
        run = rank["train"][0]
        assert run["impl"] == "ring"
        np.testing.assert_allclose(run["losses"], want["losses"], rtol=2e-4)
        ref = want["state"]["state_dict"]
        assert max((run["state"]["state_dict"][k].double() - ref[k].double()).abs().max().item() for k in ref) < 5e-4
        errs = R.relative_errors(run["state"], want["state"], want["init"])
        assert max(errs["update"][0], errs["slot"][0]) < R.WHOLE_RTOL, errs
        assert max(errs["update"][1], errs["slot"][1]) < R.TENSOR_RTOL, errs
    s0, s1 = (rank["train"][0]["state"]["state_dict"] for rank in got)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


@pytest.mark.cuda
def test_cuda_two_ranks_share_the_card_over_gloo(cuda):
    """``chip_smoke.py`` phase 6h (b) at small size: two ranks on ``cuda:0``
    over gloo, meshes (2, 1) and (1, 2), 2 fp32 SGD steps of CENet-b0 at 64 px
    (batch 8, drop-path, the clip; ``tests/torch_mesh_ranks.py``) against the
    one-process steps on the card: losses to rtol 2e-4, weights and statistics
    to 5e-4 max-abs, the parameter updates and SGD slots within 1e-3 of their
    whole norm and 1e-2 of each tensor's (``R.relative_errors``)."""
    import torch_mesh_ranks as R

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(dict(loss_type="boundary"), (2, 1)), (dict(loss_type="dice,ce", loss_weights="0.5,0.5"), (1, 2))]
    got = R.run_ranks("rank_train", 2, {"cases": cases, "device": "cuda:0"}, device="cuda:0", backend="gloo")
    for i, (kw, _) in enumerate(cases):
        want = R.train(R.dp_config(**kw), device="cuda")
        for rank in got:
            run = rank["train"][i]
            np.testing.assert_allclose(run["losses"], want["losses"], rtol=2e-4)
            ref = want["state"]["state_dict"]
            assert max((run["state"]["state_dict"][k].double() - ref[k].double()).abs().max().item()
                       for k in ref) < 5e-4
            errs = R.relative_errors(run["state"], want["state"], want["init"])
            assert max(errs["update"][0], errs["slot"][0]) < R.WHOLE_RTOL, errs
            assert max(errs["update"][1], errs["slot"][1]) < R.TENSOR_RTOL, errs


@pytest.mark.cuda
def test_cuda_machine_builds_the_zstd_decoder_and_bridges_the_fixture(cuda):
    """The Orbax bridge where the card is: the zstd decoder built from its
    source (no libzstd, no ``zstandard`` used), CRC-32C's test vector, the
    committed fixture's step (``tests/torch_orbax_data``, the Synapse CENet-b2
    TrainState) read with every leaf equal to its manifest's sha256, and
    bridged onto a CENet-b2 ``Trainer`` on the card, every tensor and SGD
    slot equal to the bridged state's, at count 37."""
    import hashlib

    from cenet_tpu_torch import native
    from cenet_tpu_torch.core.checkpoint import load_train_state
    from cenet_tpu_torch.core.config import get_preset
    from cenet_tpu_torch.core.orbax import read_checkpoint
    from cenet_tpu_torch.train.trainer import Trainer

    assert native.crc32c(b"123456789") == 0xE3069283
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_orbax_data")
    with open(os.path.join(fixture, "manifest.json")) as f:
        manifest = json.load(f)
    step = os.path.join(fixture, "steps", str(manifest["step"]))
    tree = read_checkpoint(step)
    for r in manifest["leaves"]:
        node = tree
        for p in r["path"].split("/"):
            node = node[int(p)] if isinstance(node, list) else node[p]
        assert hashlib.sha256(np.ascontiguousarray(node).tobytes()).hexdigest() == r["sha256"], r["path"]
    cfg = get_preset("synapse")
    state = load_train_state(step, cfg)
    trainer = Trainer(cfg, 1, device=cuda)
    trainer.load_state_dict(state)
    assert trainer.step == manifest["step"] == 37
    live = trainer.model.state_dict()
    assert live.keys() == state["state_dict"].keys() and len(live) == 801
    assert all(v.is_cuda and torch.equal(v.cpu(), state["state_dict"][k]) for k, v in live.items())
    slots = state["optimizer"]["state"]
    assert len(slots) == 630 and all(torch.equal(trainer.optimizer.state[n]["trace"].cpu(), s["trace"])
                                     for n, s in slots.items())
