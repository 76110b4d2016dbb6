"""Time K8's tensor-core kernel (``attention_bwd_fused_tc_kernel``) under each
candidate block tiling at the dec1 Nonlocal site of a training batch.

    python3 -m cenet_tpu_torch.tools.time_tilings

Compiles one small source that includes ``csrc/attention_tc.cuh`` and exposes
``bwd_fused_launch`` under each tiling of ``TILINGS`` (``nvcc -Xptxas -v``
prints each instance's registers and spills), then, on bf16 inputs of
B = 8, H = 1, N = M = 3136, d = dv = 64: checks that every tiling gives the
production wrapper's dk and dv to the bit and its dq within 2^-8 of max |dq|,
and times the tilings in turns (a, b, …, b, a) with CUDA events. Prints one
JSON line per tiling and the card's name and power limit. Needs one CUDA
device and ``nvcc``.
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

# (warps, streamed query rows): blocks of 16 * warps keys
TILINGS = [(4, 32), (8, 32)]

_SOURCE = """
#include "attention_tc.cuh"
namespace tc = cenet::tc;
template <class C>
static int run(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
               float* dq, void* dk, void* dv, int B, int H, int N, int M, int D, void* stream) {
  const long long sb = (long long)H * N * D, sh = (long long)N * D;
  const tc::BwdArgs a{tc::operand(q, sb, sh, D, B, H), tc::operand(k, sb, sh, D, B, H), tc::operand(v, sb, sh, D, B, H),
                      tc::operand(dout, sb, sh, D, B, H), lse, delta, nullptr, static_cast<tc::bf16*>(dk),
                      static_cast<tc::bf16*>(dv), H, N, M, D, D, 0, tc::out_vec(dk, D), tc::out_vec(dv, D), dq};
  return tc::bwd_fused_launch<C>(a, B, static_cast<cudaStream_t>(stream));
}
"""
_ENTRY = """extern "C" int fused_{nw}_{bs}(const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, float* dq, void* dk, void* dv, int B, int H, int N, int M, int D, void* stream) {{
  return run<tc::Tiles<{nw}, {bs}>>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, N, M, D, stream);
}}
"""


def compile_variants(out_dir: Path):
    src = out_dir / "fused_tilings.cu"
    src.write_text(_SOURCE + "".join(_ENTRY.format(nw=nw, bs=bs) for nw, bs in TILINGS))
    lib = out_dir / "libfused_tilings.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", f"-I{build.CSRC}", "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    # ptxas reports per kernel instance: keep the lines of the fused kernels
    report = [line for line in proc.stderr.splitlines() if "registers" in line or "spill" in line
              or "attention_bwd_fused_tc_kernel" in line]
    return ctypes.CDLL(str(lib)), report


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


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    b, h, n, d = 8, 1, 3136, 64
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q = (torch.randn(b, h, n, d, generator=gen, device=dev) * d**-0.5).bfloat16()
    k, v, do = (torch.randn(b, h, n, d, generator=gen, device=dev).bfloat16() for _ in range(3))
    o, lse = K.attention_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    want = K.attention_bwd_fused(q, k, v, o, lse, do)
    build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as tmp:
        lib, report = compile_variants(Path(tmp))
    print("\n".join(report), file=sys.stderr)
    fns, outs = {}, {}
    for nw, bs in TILINGS:
        fn = getattr(lib, f"fused_{nw}_{bs}")
        fn.argtypes, fn.restype = [binding.P] * 9 + [binding.I] * 5 + [binding.P], binding.I
        dq = torch.zeros(b, h, n, d, device=dev)
        dk, dv = torch.empty_like(k), torch.empty_like(v)

        def call(fn=fn, dq=dq, dk=dk, dv=dv):
            dq.zero_()
            binding.raise_on("fused tiling", fn(*binding.ptrs(q, k, v, do, lse, delta, dq, dk, dv), b, h, n, n, d,
                                                binding.stream()))

        call()
        torch.cuda.synchronize()
        fns[(nw, bs)], outs[(nw, bs)] = call, (dq.bfloat16(), dk.clone(), dv.clone())
    times = {t: [] for t in TILINGS}
    for t in [*TILINGS, *reversed(TILINGS)]:
        times[t].append(time_ms(fns[t]))
    for (nw, bs), (dq, dk, dv) in outs.items():
        dq_err = float((dq.float() - want[0].float()).abs().max())
        row = {"warps": nw, "query_rows": bs, "key_rows": 16 * nw, "ms": times[(nw, bs)],
               "dk_dv_equal_wrapper": bool(torch.equal(dk, want[1]) and torch.equal(dv, want[2])),
               "dq_max_abs_vs_wrapper": dq_err, "dq_max_abs": float(want[0].float().abs().max())}
        print(json.dumps(row), flush=True)
        if not row["dk_dv_equal_wrapper"] or dq_err > 2.0**-8 * row["dq_max_abs"]:
            raise SystemExit(f"tiling {nw} x {bs} disagrees with the wrapper: {row}")
    print(smi, flush=True)


if __name__ == "__main__":
    main()
