"""Time the tensor-core kernels that have candidate block tilings at their
sites on the main paths.

    python3 -m cenet_tpu_torch.tools.time_tilings [k6] [k8] [k12] [k12bwd] [k11] [k11dw]

K8 (``attention_bwd_fused_tc_kernel``, ``csrc/attention_tc.cuh``) at the dec1
Nonlocal site: B = 8, H = 1, N = M = 3136, d = dv = 64, blocks of 16·warps
keys against streamed query tiles. K6 (``diff_bwd_one_tc_kernel``,
``csrc/diff_attention_tc.cuh``) at the DSEB1 site: B = 8, h = 8, N = M = 3136,
d = 8, dv = 16 on the split head views of the projections, blocks of
16·warps query rows against key tiles of 64. K12's bf16 forward
(``conv_fwd_tc_kernel``, ``csrc/smallc_conv.cu``) at the three OutHead
shapes of a 32-slice chunk (5×5 32→32 at 224², 3×3 64→32 and 64→64 at 112²,
NCHW views): warps, pixel rows a warp, weight rows a chunk and chunks in
flight. K12's bf16 dw (``conv_dw_tc_kernel``) at the same shapes at the
training batch of 8, with the ordered sum of its partials: m blocks a warp
(the block's slice of dW's rows), pixel rows a tile, and the partial count
(blocks aimed at 1, 2 or 4 per SM); held to the wrapper's dw within 1e-4 of
its largest element (another partial count sums in another order). K11's
forward (``dw3x3_plane_kernel``, ``dw3x3_cl_kernel``, ``csrc/depthwise_conv.cu``)
in bf16 at dilation 1 at the chunk's largest sites of both layouts: 16-byte
vectors of outputs a thread and runs a block (plane kernel), outputs along W
a thread (channels-last kernel); held to the wrapper to the bit. K11's dw
(``dw3x3_dw_cl_kernel``, ``dw3x3_dw_plane_kernel``) in bf16 at the training
batch of 8 at sites of both routes, large and small: channels a channels-last
thread, positions a task, and the blocks an SM (parts) and plane-block runs
that ``dw_plan`` aims at; held to the wrapper within 1e-4 of its largest
element (another cut sums in another order), and timed beside CUDA events by
device time (``tools/device_time.py``: a CUDA graph of calls on copies of the
inputs that pass twice the L2), which leaves out the host's dispatch that the
events read at the small sites. The first
tiling of k12bwd, k11 and k11dw is the one the sources launch. Each kernel's variants are
compiled into one small source (``nvcc -Xptxas -v`` prints each instance's
registers and spills); on bf16 inputs each tiling is held to the production
wrapper (the outputs that one block writes equal to the bit, K6's δ too;
the gradients summed with atomics within 2^-8 of their max) and the tilings are
timed in turns (a, b, …, b, a) with CUDA events. Prints one JSON line per
tiling and the card's name and power limit. Needs one CUDA device and
``nvcc``; with no argument it times every kernel.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from cenet_tpu_torch.ops import attention_kernels as K
from cenet_tpu_torch.ops import binding, build
from cenet_tpu_torch.tools.device_time import graph_ms, rotated

# each kernel's candidate tilings: (warps, streamed rows) for K6 and K8;
# (warps, 16-pixel rows a warp, weight rows a chunk, chunks in flight) for K12;
# (m blocks a warp at 32 output channels, at 64, pixel rows a tile, dw blocks
# aimed at per SM) for K12's dw (8 warps); (16-byte output vectors a thread,
# runs a block, outputs along W a thread) for K11's forward; (channels a
# channels-last thread, positions a task, channels-last blocks an SM at most,
# plane-block runs aimed at) for K11's dw (csrc/depthwise_conv.cu: DwTiles).
TILINGS = {"k8": [(4, 32), (8, 32)], "k6": [(4, 64), (8, 64)],
           "k12": [(4, 4, 64, 2), (4, 4, 128, 2), (4, 4, 64, 3), (4, 4, 128, 3), (8, 2, 64, 3), (8, 4, 64, 3)],
           "k12bwd": [(2, 1, 8, 2), (2, 1, 8, 1), (4, 2, 8, 1), (4, 2, 8, 2), (4, 2, 16, 1)],
           "k11": [(1, 512, 8), (2, 512, 8), (1, 256, 8), (1, 1024, 8), (1, 512, 4)],
           "k11dw": [(4, 8, 2, 512), (8, 8, 2, 512), (4, 8, 4, 512), (4, 8, 6, 512), (4, 16, 2, 512),
                     (4, 8, 2, 1024)]}
# K11's sites in bf16 at the 32-slice chunk, dilation 1: (name, NCHW shape, channels-last)
K11_SITES = [("PVT stage 1", (32, 512, 56, 56), True), ("PVT stage 2", (32, 1024, 28, 28), True),
             ("PVT stage 3", (32, 1280, 14, 14), True), ("CAggMlp 56²", (32, 256, 56, 56), False),
             ("CAggMlp 14²", (32, 1280, 14, 14), False), ("7² x 2048", (32, 2048, 7, 7), False)]
# K11 dw's sites in bf16 at the training batch of 8, in the layouts the train
# step hands over (chip_smoke.py records them): (name, NHWC shape, dilation,
# x layout, g layout), "cl" channels-last memory, "nchw" the view of NCHW
# memory, "slice" 20 channels of a 64-channel NCHW tensor
K11DW_SITES = [("PVT stage 1", (8, 56, 56, 512), 1, "cl", "cl"), ("PVT stage 2", (8, 28, 28, 1024), 1, "cl", "cl"),
               ("PVT stage 4", (8, 7, 7, 2048), 1, "cl", "cl"),
               ("NCHW 56² x 256", (8, 56, 56, 256), 1, "nchw", "nchw"),
               ("NCHW 7² x 2048", (8, 7, 7, 2048), 1, "nchw", "nchw"),
               ("dilated 56² x 20", (8, 56, 56, 20), 2, "slice", "nchw")]
# K12's sites: (name, x NHWC, k, cout), x handed over as a view of NCHW memory
K12_SITES = [("rb.0.conv2", (32, 224, 224, 32), 5, 32), ("up.1", (32, 112, 112, 64), 3, 32),
             ("out.0.conv", (32, 112, 112, 64), 3, 64)]

_SOURCE = {"k8": ("attention_tc.cuh", """
template <class C>
static int run(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
               float* dq, void* dk, void* dv, int B, int H, int N, int M, int D, void* stream) {
  const long long sb = (long long)H * N * D, sh = (long long)N * D;
  const tc::BwdArgs a{tc::operand(q, sb, sh, D, B, H), tc::operand(k, sb, sh, D, B, H), tc::operand(v, sb, sh, D, B, H),
                      tc::operand(dout, sb, sh, D, B, H), lse, delta, nullptr, static_cast<tc::bf16*>(dk),
                      static_cast<tc::bf16*>(dv), H, N, M, D, D, 0, tc::out_vec(dk, D), tc::out_vec(dv, D), dq};
  return tc::bwd_fused_launch<C>(a, B, static_cast<cudaStream_t>(stream));
}
""", """extern "C" int k8_{nw}_{bs}(const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, float* dq, void* dk, void* dv, int B, int H, int N, int M, int D, void* stream) {{
  return run<tc::Tiles<{nw}, {bs}>>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, N, M, D, stream);
}}
"""), "k12": ("smallc_conv.cu", """
// the OutHead shapes only: fwd_tc<K, CIN, NT, tiling>
template <class C>
static int run(int k, int cin, const void* x, const void* w, void* out, int b, int h, int wd, int cout,
               long long sxb, long long sxh, long long sxw, long long sxc, long long sob, long long soh,
               long long sow, long long soc, void* stream) {
  const Strides sx{sxb, sxh, sxw, sxc}, so{sob, soh, sow, soc};
  auto st = static_cast<cudaStream_t>(stream);
  if (k == 5 && cin == 32 && cout <= 32) return fwd_tc<5, 32, 32, C>(x, w, out, b, h, wd, cout, sx, so, st);
  if (k == 3 && cin == 64 && cout <= 32) return fwd_tc<3, 64, 32, C>(x, w, out, b, h, wd, cout, sx, so, st);
  if (k == 3 && cin == 64) return fwd_tc<3, 64, 64, C>(x, w, out, b, h, wd, cout, sx, so, st);
  return cudaErrorInvalidValue;
}
""", """extern "C" int k12_{nw}_{mb}_{kc}_{st}(int k, int cin, const void* x, const void* w, void* out, int b, int h, int wd,
    int cout, long long sxb, long long sxh, long long sxw, long long sxc, long long sob, long long soh, long long sow,
    long long soc, void* stream) {{
  return run<ConvTiles<{nw}, {mb}, {kc}, {st}>>(k, cin, x, w, out, b, h, wd, cout, sxb, sxh, sxw, sxc, sob, soh, sow,
                                                soc, stream);
}}
"""), "k12bwd": ("smallc_conv.cu", """
// the OutHead shapes only: dw_tc<K, CIN, NT, tiling>, then the ordered sum
template <class D32, class D64>
static int run(int k, int cin, const void* x, const void* g, float* partial, float* dw, int b, int h, int wd, int cout,
               long long sxb, long long sxh, long long sxw, long long sxc, long long sgb, long long sgh,
               long long sgw, long long sgc, int parts, void* stream) {
  const Strides sx{sxb, sxh, sxw, sxc}, sg{sgb, sgh, sgw, sgc};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (k == 5 && cin == 32 && cout <= 32) err = dw_tc<5, 32, 32, D32>(x, g, partial, b, h, wd, cout, sx, sg, parts, st);
  else if (k == 3 && cin == 64 && cout <= 32) err = dw_tc<3, 64, 32, D32>(x, g, partial, b, h, wd, cout, sx, sg, parts, st);
  else if (k == 3 && cin == 64) err = dw_tc<3, 64, 64, D64>(x, g, partial, b, h, wd, cout, sx, sg, parts, st);
  if (err != cudaSuccess) return err;
  return sum_parts(partial, dw, (long long)k * k * cin * cout, parts, st);
}
""", """extern "C" int k12bwd_{m32}_{m64}_{th}_{bps}(int k, int cin, const void* x, const void* g, float* partial, float* dw,
    int b, int h, int wd, int cout, long long sxb, long long sxh, long long sxw, long long sxc, long long sgb,
    long long sgh, long long sgw, long long sgc, int parts, void* stream) {{
  return run<DwTiles<8, {m32}, {th}>, DwTiles<8, {m64}, {th}>>(k, cin, x, g, partial, dw, b, h, wd, cout, sxb, sxh,
                                                               sxw, sxc, sgb, sgh, sgw, sgc, parts, stream);
}}
"""), "k11": ("depthwise_conv.cu", """
// dilation 1: launch_fwd_dil<T, 1, V, XT> with a block's runs
template <int OV, int XT>
static int run(int is_bf16, const void* x, const float* w, void* out, int b, int h, int wd, int c, long long sxb,
               long long sxh, long long sxw, long long sxc, long long sob, long long soh, long long sow, long long soc,
               int runs, void* stream) {
  const Strides sx{sxb, sxh, sxw, sxc}, so{sob, soh, sow, soc};
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd_dil<__nv_bfloat16, 1, OV * 8, XT>(x, w, out, b, h, wd, c, sx, so, runs, st)
                 : launch_fwd_dil<float, 1, OV * 4, XT>(x, w, out, b, h, wd, c, sx, so, runs, st);
}
""", """extern "C" int k11_{ov}_{runs}_{xt}(int is_bf16, const void* x, const float* w, void* out, int b, int h, int wd,
    int c, long long sxb, long long sxh, long long sxw, long long sxc, long long sob, long long soh, long long sow,
    long long soc, void* stream) {{
  return run<{ov}, {xt}>(is_bf16, x, w, out, b, h, wd, c, sxb, sxh, sxw, sxc, sob, soh, sow, soc, {runs}, stream);
}}
"""), "k11dw": ("depthwise_conv.cu", """
// bf16: dw_plan and launch_dw on a tiling of DwTiles' fields
template <int CPT_, int XT_, int BPS_, int RUNS_>
struct Tiles {
  static constexpr int CPT = CPT_, XT = XT_, BLOCKS_PER_SM = BPS_, RUNS = RUNS_;
};
using bf16 = __nv_bfloat16;
""", """extern "C" int k11dw_plan_{cpt}_{xt}_{bps}_{runs}(int b, int h, int wd, int c, int dil, long long sxc,
    long long sgc, int* out) {{
  const DwPlan p = dw_plan<bf16, Tiles<{cpt}, {xt}, {bps}, {runs}>>(b, h, wd, c, dil, sxc, sgc);
  out[0] = p.route, out[1] = p.groups, out[2] = p.parts, out[3] = p.log_block, out[4] = p.per;
  return p.route < 0;
}}
extern "C" int k11dw_{cpt}_{xt}_{bps}_{runs}(const void* x, const void* g, void* partial, void* dw, void* tickets,
    int b, int h, int wd, int c, int dil, long long sxb, long long sxh, long long sxw, long long sxc, long long sgb,
    long long sgh, long long sgw, long long sgc, void* stream) {{
  const Strides sx{{sxb, sxh, sxw, sxc}}, sg{{sgb, sgh, sgw, sgc}};
  return launch_dw<bf16, Tiles<{cpt}, {xt}, {bps}, {runs}>>(x, g, static_cast<float*>(partial),
      static_cast<float*>(dw), static_cast<unsigned*>(tickets), b, h, wd, c, dil, sx, sg,
      static_cast<cudaStream_t>(stream));
}}
"""), "k6": ("diff_attention_tc.cuh", """
// q1, k1, q2, k2 share the strides sq (split views of one projection layout)
template <class C>
static int run(const void* q1, const void* k1, const void* q2, const void* k2, const void* v, const void* dout,
               const float* lam, const float* lse1, const float* lse2, float* delta1, float* delta2, void* dq1,
               float* dk1, void* dq2, float* dk2, float* dv, int B, int H, int N, int D, int DV, long long sqb,
               long long sqh, long long sqn, long long svb, long long svh, long long svn, long long sob,
               long long soh, long long son, void* stream) {
  auto in = [&](const void* x, long long sb, long long sh, long long sn) { return tc::operand(x, sb, sh, sn, B, H); };
  auto out = [&](void* x) { return tc::out_rows(x, (long long)H * N * D, (long long)N * D, D); };
  const tc::DiffBwdArgs a{{in(q1, sqb, sqh, sqn), in(q2, sqb, sqh, sqn)}, {in(k1, sqb, sqh, sqn), in(k2, sqb, sqh, sqn)},
                          in(v, svb, svh, svn), in(dout, sob, soh, son), lam, {lse1, lse2}, {delta1, delta2},
                          {out(dq1), out(dq2)}, {}, nullptr, H, N, N, D, DV, 0, {dk1, dk2}, dv};
  return tc::diff_bwd_one_launch<C>(a, B, static_cast<cudaStream_t>(stream));
}
""", """extern "C" int k6_{nw}_{bs}(const void* q1, const void* k1, const void* q2, const void* k2, const void* v,
    const void* dout, const float* lam, const float* lse1, const float* lse2, float* delta1, float* delta2, void* dq1,
    float* dk1, void* dq2, float* dk2, float* dv, int B, int H, int N, int D, int DV, long long sqb, long long sqh,
    long long sqn, long long svb, long long svh, long long svn, long long sob, long long soh, long long son,
    void* stream) {{
  return run<tc::Tiles<{nw}, {bs}>>(q1, k1, q2, k2, v, dout, lam, lse1, lse2, delta1, delta2, dq1, dk1, dq2, dk2, dv,
                                    B, H, N, D, DV, sqb, sqh, sqn, svb, svh, svn, sob, soh, son, stream);
}}
""")}
_ARGTYPES = {"k8": [binding.P] * 9 + [binding.I] * 5 + [binding.P],
             "k12": [binding.I] * 2 + [binding.P] * 3 + [binding.I] * 4 + [binding.L] * 8 + [binding.P],
             "k6": [binding.P] * 16 + [binding.I] * 5 + [binding.L] * 9 + [binding.P],
             "k12bwd": [binding.I] * 2 + [binding.P] * 4 + [binding.I] * 4 + [binding.L] * 8 + [binding.I, binding.P],
             "k11": [binding.I] + [binding.P] * 3 + [binding.I] * 4 + [binding.L] * 8 + [binding.P],
             "k11dw": [binding.P] * 5 + [binding.I] * 5 + [binding.L] * 8 + [binding.P],
             "k11dw_plan": [binding.I] * 5 + [binding.L] * 2 + [binding.P]}
_KERNEL_SYMBOL = {"k8": "attention_bwd_fused_tc_kernel", "k6": "diff_bwd_one_tc_kernel", "k12": "conv_fwd_tc_kernel",
                  "k12bwd": "conv_dw_tc_kernel", "k11": "dw3x3_", "k11dw": "dw3x3_dw_"}
_FIELDS = {"k12": ("nw", "mb", "kc", "st"), "k12bwd": ("m32", "m64", "th", "bps"), "k11": ("ov", "runs", "xt"),
           "k11dw": ("cpt", "xt", "bps", "runs")}


def compile_variants(kernel: str, out_dir: Path):
    header, body, entry = _SOURCE[kernel]
    src = out_dir / f"{kernel}_tilings.cu"
    prelude = f'#include "{header}"\n' + ("" if header.endswith(".cu") else "namespace tc = cenet::tc;\n")
    src.write_text(prelude + body + "".join(entry.format(**_fields(kernel, t)) for t in TILINGS[kernel]))
    lib = out_dir / f"lib{kernel}_tilings.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", f"-I{build.CSRC}", "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    # ptxas reports per kernel instance: keep the lines of the timed kernel
    report = [line for line in proc.stderr.splitlines() if "registers" in line or "spill" in line
              or _KERNEL_SYMBOL[kernel] in line]
    return ctypes.CDLL(str(lib)), report


def _fields(kernel, tiling):
    return dict(zip(_FIELDS.get(kernel, ("nw", "bs")), tiling))


def _name(kernel, tiling):
    return kernel + "_" + "_".join(str(v) for v in tiling)


def time_ms(fn, reps=20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k8_calls(lib, dev):
    """K8's variants on dec1's inputs: {tiling: call}, the wrapper's (dq, dk, dv),
    and per tiling a function giving its (dq, dk, dv) after a call."""
    b, h, n, d = 8, 1, 3136, 64
    gen = torch.Generator(device=dev).manual_seed(0)
    q = (torch.randn(b, h, n, d, generator=gen, device=dev) * d**-0.5).bfloat16()
    k, v, do = (torch.randn(b, h, n, d, generator=gen, device=dev).bfloat16() for _ in range(3))
    o, lse = K.attention_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    want = K.attention_bwd_fused(q, k, v, o, lse, do)
    calls = {}
    for nw, bs in TILINGS["k8"]:
        fn = getattr(lib, _name("k8", (nw, bs)))
        fn.argtypes, fn.restype = _ARGTYPES["k8"], binding.I
        dq = torch.zeros(b, h, n, d, device=dev)
        dk, dv = torch.empty_like(k), torch.empty_like(v)

        def call(fn=fn, dq=dq, dk=dk, dv=dv):
            dq.zero_()
            binding.raise_on("k8 tiling", fn(*binding.ptrs(q, k, v, do, lse, delta, dq, dk, dv), b, h, n, n, d,
                                             binding.stream()))
            return dq.bfloat16(), dk, dv

        calls[(nw, bs)] = call
    # (gradients one block writes, gradients summed with atomics)
    return calls, want, ("dk", "dv"), ("dq",), ("dq", "dk", "dv")


def k6_calls(lib, dev):
    """K6's variants on DSEB1's inputs (split head views of (B, N, 2h, d)
    projections, a strided dO), as ``k8_calls``."""
    b, h, n, d, dv_ = 8, 8, 3136, 8, 16
    gen = torch.Generator(device=dev).manual_seed(0)
    q = (torch.randn(b, n, 2 * h, d, generator=gen, device=dev) * d**-0.5).bfloat16().transpose(1, 2)
    k = torch.randn(b, n, 2 * h, d, generator=gen, device=dev).bfloat16().transpose(1, 2)
    v = torch.randn(b, n, h, dv_, generator=gen, device=dev).bfloat16().transpose(1, 2)
    do = torch.randn(b, n, h, dv_, generator=gen, device=dev).bfloat16().transpose(1, 2)
    lam = torch.tensor(0.2, device=dev)
    groups = q[:, 0::2], k[:, 0::2], q[:, 1::2], k[:, 1::2]
    _, lse1, lse2 = K.diff_attention_fwd(*groups, v, lam)
    want = K.diff_attention_bwd(*groups, v, lam, lse1, lse2, do)
    calls = {}
    for nw, bs in TILINGS["k6"]:
        fn = getattr(lib, _name("k6", (nw, bs)))
        fn.argtypes, fn.restype = _ARGTYPES["k6"], binding.I
        d1, d2 = (torch.empty(b, h, n, device=dev) for _ in range(2))
        dq1, dq2 = torch.empty(b, h, n, d, device=dev).bfloat16(), torch.empty(b, h, n, d, device=dev).bfloat16()
        acc = [torch.zeros(b, h, n, c, device=dev) for c in (d, d, dv_)]

        def call(fn=fn, d1=d1, d2=d2, dq1=dq1, dq2=dq2, acc=acc):
            for a in acc:
                a.zero_()
            binding.raise_on("k6 tiling", fn(*binding.ptrs(*groups, v, do, lam, lse1, lse2, d1, d2, dq1, acc[0], dq2,
                                                            acc[1], acc[2]), b, h, n, d, dv_,
                                             *binding.strides(groups[0]), *binding.strides(v), *binding.strides(do),
                                             binding.stream()))
            return dq1, acc[0].bfloat16(), dq2, acc[1].bfloat16(), acc[2].bfloat16(), -d2.sum()

        calls[(nw, bs)] = call
    return calls, want, ("dq1", "dq2", "dlam"), ("dk1", "dk2", "dv"), ("dq1", "dk1", "dq2", "dk2", "dv", "dlam")


def k12_bench(lib, dev):
    """K12's forward tilings at each OutHead shape: each held to the wrapper's
    output to the bit, timed in turns. Prints one JSON line per (site, tiling)."""
    from cenet_tpu_torch.ops import smallc_conv as SC

    gen = torch.Generator(device=dev).manual_seed(0)
    for site, (b, h, wd, cin), k, cout in K12_SITES:
        x = torch.randn(b, cin, h, wd, generator=gen, device=dev).bfloat16().permute(0, 2, 3, 1)
        w = (0.1 * torch.randn(k, k, cin, cout, generator=gen, device=dev)).bfloat16()
        want = SC.conv_small_c_fwd(x, w, k // 2)
        calls, outs = {}, {}
        for t in TILINGS["k12"]:
            fn = getattr(lib, _name("k12", t))
            fn.argtypes, fn.restype = _ARGTYPES["k12"], binding.I
            out = SC._out_like(x, cout)

            def call(fn=fn, out=out):
                binding.raise_on("k12 tiling", fn(k, cin, *binding.ptrs(x, w, out), b, h, wd, cout,
                                                  *binding.strides(x, 4), *binding.strides(out, 4), binding.stream()))
                return out

            calls[t], outs[t] = call, call().clone()
        torch.cuda.synchronize()
        times = _in_turns(calls)
        for t, got in outs.items():
            row = {"kernel": "k12", "site": site, **_fields("k12", t), "ms": times[t],
                   "equal_to_wrapper": bool(torch.equal(got, want))}
            print(json.dumps(row), flush=True)
            if not row["equal_to_wrapper"]:
                raise SystemExit(f"k12 tiling {t} disagrees with the wrapper at {site}: {row}")


def _in_turns(calls):
    """Each call timed twice, in turns (a, b, …, b, a)."""
    times = {t: [] for t in calls}
    for t in [*calls, *reversed(list(calls))]:
        times[t].append(time_ms(calls[t]))
    return times


def k12bwd_bench(lib, dev):
    """K12's bf16 dw tilings at each OutHead shape at the training batch of 8 on
    channels-last x and g (the wrapper copies the model's NCHW views so): each
    held to the wrapper's dw within 1e-4 of its largest element, timed in turns
    with the ordered sum of the partials. Prints one JSON line per (site,
    tiling)."""
    from cenet_tpu_torch.ops import smallc_conv as SC

    gen = torch.Generator(device=dev).manual_seed(0)
    for site, (_, h, wd, cin), k, cout in K12_SITES:
        b = 8
        x = torch.randn(b, cin, h, wd, generator=gen, device=dev).bfloat16().permute(0, 2, 3, 1)
        g = torch.randn(b, cout, h, wd, generator=gen, device=dev).bfloat16().permute(0, 2, 3, 1)
        w = 0.1 * torch.randn(k, k, cin, cout, generator=gen, device=dev)  # fp32: dw comes back in fp32
        want = SC.conv_small_c_bwd(x, w, g, k // 2)[1]
        x, g = x.contiguous(), g.contiguous()
        calls, outs, parts_of = {}, {}, {}
        for t in TILINGS["k12bwd"]:
            m32, m64, th, bps = t
            nt = 32 if cout <= 32 else 64
            m_blocks = -(-k * k * cin // 16)
            per_part = -(-m_blocks // (8 * (m32 if nt == 32 else m64))) * -(-cout // nt)
            tiles = b * -(-h // th) * -(-wd // 16)
            parts = max(1, min(tiles, -(-bps * 132 // per_part)))
            fn = getattr(lib, _name("k12bwd", t))
            fn.argtypes, fn.restype = _ARGTYPES["k12bwd"], binding.I
            partial = torch.empty((parts, k, k, cin, cout), device=dev)
            dw = torch.empty((k, k, cin, cout), device=dev)

            def call(fn=fn, partial=partial, dw=dw, parts=parts):
                binding.raise_on("k12bwd tiling", fn(k, cin, *binding.ptrs(x, g, partial, dw), b, h, wd, cout,
                                                     *binding.strides(x, 4), *binding.strides(g, 4), parts,
                                                     binding.stream()))
                return dw

            calls[t], outs[t], parts_of[t] = call, call().clone(), parts
        torch.cuda.synchronize()
        times = _in_turns(calls)
        for t, got in outs.items():
            err, lim = float((got - want).abs().max()), 1e-4 * float(want.abs().max())
            row = {"kernel": "k12bwd", "site": site, "batch": b, **_fields("k12bwd", t), "parts": parts_of[t],
                   "ms": times[t], "max_abs_vs_wrapper": err, "limit": lim,
                   "equal_to_wrapper": bool(torch.equal(got, want))}
            print(json.dumps(row), flush=True)
            if err > lim:
                raise SystemExit(f"k12bwd tiling {t} disagrees with the wrapper at {site}: {row}")


def k11_bench(lib, dev):
    """K11's forward tilings in bf16 at the chunk's largest sites (dilation 1),
    each held to the wrapper's output to the bit and timed in turns. Prints one
    JSON line per (site, tiling)."""
    from cenet_tpu_torch.ops import depthwise as DWK

    gen = torch.Generator(device=dev).manual_seed(0)
    for site, (b, c, h, wd), channels_last in K11_SITES:
        x = torch.randn(b, c, h, wd, generator=gen, device=dev).bfloat16().permute(0, 2, 3, 1)
        x = x.contiguous() if channels_last else x
        taps = torch.randn(3, 3, c, generator=gen, device=dev)
        want = DWK.depthwise_fwd(x, taps, 1)
        calls, outs = {}, {}
        for t in TILINGS["k11"]:
            fn = getattr(lib, _name("k11", t))
            fn.argtypes, fn.restype = _ARGTYPES["k11"], binding.I
            out = torch.empty_like(x)

            def call(fn=fn, out=out):
                binding.raise_on("k11 tiling", fn(1, *binding.ptrs(x, taps, out), b, h, wd, c, *binding.strides(x, 4),
                                                  *binding.strides(out, 4), binding.stream()))
                return out

            calls[t], outs[t] = call, call().clone()
        torch.cuda.synchronize()
        times = _in_turns(calls)
        for t, got in outs.items():
            row = {"kernel": "k11", "site": site, "shape_nchw": [b, c, h, wd], "channels_last": channels_last,
                   **_fields("k11", t), "ms": times[t], "equal_to_wrapper": bool(torch.equal(got, want))}
            print(json.dumps(row), flush=True)
            if not row["equal_to_wrapper"]:
                raise SystemExit(f"k11 tiling {t} disagrees with the wrapper at {site}: {row}")


def _k11dw_input(shape, layout, gen, dev):
    b, h, wd, c = shape
    if layout == "cl":
        return torch.randn(b, h, wd, c, generator=gen, device=dev).bfloat16()
    if layout == "nchw":
        return torch.randn(b, c, h, wd, generator=gen, device=dev).bfloat16().permute(0, 2, 3, 1)
    return torch.randn(b, 64, h, wd, generator=gen, device=dev).bfloat16().permute(0, 2, 3, 1)[..., 20:20 + c]


def k11dw_bench(lib, dev):
    """K11 dw's tilings in bf16 at ``K11DW_SITES``: each on the cut ``dw_plan``
    makes for it, held to the wrapper's dw within 1e-4 of its largest element,
    timed in turns by CUDA events and by device time (``graph_ms`` on
    ``rotated`` inputs). Prints one JSON line per (site, tiling)."""
    from cenet_tpu_torch.ops import depthwise as DWK

    gen = torch.Generator(device=dev).manual_seed(0)
    for site, shape, dil, xl, gl in K11DW_SITES:
        x, g = _k11dw_input(shape, xl, gen, dev), _k11dw_input(shape, gl, gen, dev)
        want = DWK.depthwise_dw(x, g, dil)
        sets = rotated((x, g))
        b, h, wd, c = shape
        calls, outs, plans = {}, {}, {}
        for t in TILINGS["k11dw"]:
            plan_fn = getattr(lib, _name("k11dw_plan", t))
            plan_fn.argtypes, plan_fn.restype = _ARGTYPES["k11dw_plan"], binding.I
            plan = (ctypes.c_int * 5)()
            if plan_fn(b, h, wd, c, dil, x.stride(3), g.stride(3), plan):
                raise SystemExit(f"k11dw tiling {t}: no cut fits {site}")
            fn = getattr(lib, _name("k11dw", t))
            fn.argtypes, fn.restype = _ARGTYPES["k11dw"], binding.I
            dw = torch.empty((3, 3, c), device=dev)
            partial = torch.empty((plan[2], 9, c), device=dev)
            tickets = torch.zeros(max(plan[1], 1024), dtype=torch.int32, device=dev)

            def call(x=x, g=g, fn=fn, dw=dw, partial=partial, tickets=tickets):
                binding.raise_on("k11dw tiling", fn(*binding.ptrs(x, g, partial, dw, tickets), b, h, wd, c, dil,
                                                    *binding.strides(x, 4), *binding.strides(g, 4), binding.stream()))
                return dw

            calls[t], outs[t] = call, call().clone()
            plans[t] = dict(zip(("route", "groups", "parts", "log_block", "per"), plan))
        torch.cuda.synchronize()
        times = _in_turns(calls)
        dev_times = {t: graph_ms(call, sets) for t, call in calls.items()}
        for t, got in outs.items():
            err, lim = float((got - want).abs().max()), 1e-4 * float(want.abs().max())
            row = {"kernel": "k11dw", "site": site, "shape_nhwc": list(shape), "dilation": dil, "x_layout": xl,
                   "g_layout": gl, **_fields("k11dw", t), "plan": plans[t], "ms": times[t],
                   "device_ms": dev_times[t], "max_abs_vs_wrapper": err, "limit": lim,
                   "equal_to_wrapper": bool(torch.equal(got, want))}
            print(json.dumps(row), flush=True)
            if err > lim:
                raise SystemExit(f"k11dw tiling {t} disagrees with the wrapper at {site}: {row}")
        del sets


def bench(kernel: str, dev):
    build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as tmp:
        lib, report = compile_variants(kernel, Path(tmp))
    print("\n".join(report), file=sys.stderr)
    if kernel in ("k12", "k12bwd", "k11", "k11dw"):
        return {"k12": k12_bench, "k12bwd": k12bwd_bench, "k11": k11_bench, "k11dw": k11dw_bench}[kernel](lib, dev)
    calls, want, exact, summed, names = (k6_calls if kernel == "k6" else k8_calls)(lib, dev)
    outs = {t: [x.clone() for x in call()] for t, call in calls.items()}
    torch.cuda.synchronize()
    tilings = TILINGS[kernel]
    times = {t: [] for t in tilings}
    for t in [*tilings, *reversed(tilings)]:
        times[t].append(time_ms(calls[t]))
    for (nw, bs), got in outs.items():
        by_name = dict(zip(names, got))
        ref = dict(zip(names, want))
        equal = {g: bool(torch.equal(by_name[g], ref[g])) for g in exact}
        errs = {g: float((by_name[g].float() - ref[g].float()).abs().max()) for g in summed}
        limits = {g: 2.0**-8 * float(ref[g].float().abs().max()) for g in summed}
        row = {"kernel": kernel, "warps": nw, "streamed_rows": bs, "block_rows": 16 * nw, "ms": times[(nw, bs)],
               "equal_to_wrapper": equal, "max_abs_vs_wrapper": errs, "limits": limits}
        print(json.dumps(row), flush=True)
        if not all(equal.values()) or any(errs[g] > limits[g] for g in summed):
            raise SystemExit(f"{kernel} tiling {nw} x {bs} disagrees with the wrapper: {row}")


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kernels = sys.argv[1:] or sorted(TILINGS)
    for kernel in kernels:
        if kernel not in TILINGS:
            raise SystemExit(f"unknown kernel {kernel!r}: choose from {sorted(TILINGS)}")
        bench(kernel, torch.device("cuda"))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
