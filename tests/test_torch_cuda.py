"""The port's CUDA kernels against their plain twins, on the card.

Forward kernels (K1, K2, K5) on ``o`` and the LSE; backward kernels (K3, K4,
K6, K7, K8) on their gradients and, for the diff kernels, dλ, with the limits
of ``chip_smoke.py``, in max-abs
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
    dv = 2d (the same arithmetic)."""
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
