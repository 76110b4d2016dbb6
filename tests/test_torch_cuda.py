"""The port's CUDA kernels against their plain twins, on the card.

Forward kernels (K1, K2) on ``o`` and the LSE; backward kernels (K3, K4) on
dq, dk, dv and, for K3, dλ, with the limits of ``chip_smoke.py``, in max-abs
and in norm: fp32 1e-4 of max |grad| and 1e-5 in norm (only the order of
summation differs); bf16 two bf16 half-ulps of max |grad| (2·2^-8 in norm) plus
the twin's own cost of rounding ds and p (or w) to bf16, measured the same way.

Marked ``cuda``; each test skips without a CUDA device. This file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import pytest
import torch

from cenet_tpu_torch.ops import attention_kernels as K

# (b, h, n, m, d) and (b, h, n, m, d, dv): ragged N/M and the slice's head dims
DIFF_SHAPES = [(2, 2, 100, 100, 8), (1, 2, 196, 196, 20), (1, 1, 64, 100, 16), (1, 1, 196, 49, 64)]
ATTN_SHAPES = [(2, 1, 100, 100, 64, 64), (1, 2, 196, 196, 16, 24), (1, 1, 100, 196, 8, 8), (1, 1, 64, 64, 20, 40),
               (1, 1, 130, 70, 128, 128)]


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
                   (1, 1, 130, 70, 64, 128), (1, 1, 70, 65, 128, 24)]
BWD_ATTN_SHAPES = [(2, 1, 100, 100, 64, 64), (1, 2, 196, 196, 16, 24), (1, 1, 100, 196, 8, 8),
                   (1, 1, 130, 70, 128, 128), (1, 1, 64, 64, 20, 40)]


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
