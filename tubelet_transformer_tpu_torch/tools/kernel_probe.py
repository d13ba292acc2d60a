"""Where the stage chain's time goes, and what ``mma.sync`` gives on the
card: two measurements that ``chip_smoke.py`` does not make.

1. Chain phases. ``csrc/stage.cu`` is compiled again with some of its three
   phases emptied (copies under ``build/kernel_probe/``; the work loops of
   the other phases run zero times, the grid barriers stay), and each copy
   is timed at the flagship's three identity tails, bf16: all phases, the
   barriers alone, conv1 alone, the depthwise alone, conv4 alone.
2. ``mma.sync`` peak. A kernel that only issues ``mma.sync.m16n8k16`` (bf16
   in, float32 sums, ``csrc/mma.cuh``) on registers, 8 warps a block, one
   or two blocks an SM, 4 or 8 independent accumulators a warp.

Times are CUDA-event medians of 15 runs of 10 launches, after 5 warm-ups.
Needs a CUDA card and nvcc; prints one line per measurement after the
card's name and power limit.

Usage: python -m tubelet_transformer_tpu_torch.tools.kernel_probe
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch

from tubelet_transformer_tpu_torch.ops.cuda import build

OUT = build.BUILD_DIR.parent / "kernel_probe"
# the flagship's identity tails (CSN-152, 256 px, batch 1): x shape, C_mid, K
TAILS = {"layer2": ((1, 16, 32, 32, 512), 128, 7),
         "layer3": ((1, 8, 16, 16, 1024), 256, 35),
         "layer4": ((1, 4, 16, 16, 2048), 512, 2)}
_LOOPS = {"conv1": "for (int i = blockIdx.x; i < g.tiles_a; i += gridDim.x)",
          "depthwise": "for (int i = blockIdx.x; i < g.items_b; "
                       "i += gridDim.x)",
          "conv4": "for (int i = blockIdx.x; i < g.tiles_c; i += gridDim.x)"}
_PEAK = r'''
#include "mma.cuh"
template <int kAcc>
__global__ void __launch_bounds__(256) peak(float* out, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x ^ 1u, 2u, 3u};
  float acc[kAcc][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      tuber_mma::mma_bf16(acc[i], a, blockIdx.x, it);
  float s = 0.f;
  for (int i = 0; i < kAcc; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  if (s == 1234.5f) out[threadIdx.x] = s;
}
extern "C" int mma_peak(void* out, int blocks, int accs, int iters) {
  if (accs == 4) peak<4><<<blocks, 256>>>(static_cast<float*>(out), iters);
  else peak<8><<<blocks, 256>>>(static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
'''


def _compile(name: str, source: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(source)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-I",
                    str(build.CSRC), "-o", str(so), str(cu)], check=True)
    return ctypes.CDLL(str(so))


def chain_variants() -> dict[str, str]:
    """stage.cu with all phases, and with only the barriers or one phase
    left: the work loops of the others bounded by 0."""
    base = (build.CSRC / "stage.cu").read_text()
    for loop in _LOOPS.values():
        if base.count(loop) != 1:
            raise RuntimeError(f"stage.cu changed: no single loop {loop!r}")

    def without(*phases):
        src = base
        for p in phases:
            src = src.replace(_LOOPS[p], _LOOPS[p].replace("i < g.",
                                                           "i < 0 * g."))
        return src

    return {"all phases": base, "barriers only": without(*_LOOPS),
            **{f"{p} only": without(*(q for q in _LOOPS if q != p))
               for p in _LOOPS}}


def time_ms(fn, warmup: int = 5, runs: int = 15, calls: int = 10) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _chain_args(shape, cm, k, gen):
    """bf16 operands whose stream stays O(1) over the blocks, the mid and
    mdw scratch and the output, on the card."""
    ci = shape[-1]

    def rand(*s, scale=1.0, mean=0.0):
        return torch.randn(*s, generator=gen) * scale + mean

    bf = torch.bfloat16
    x = rand(*shape).to("cuda", bf)
    w1 = rand(k, ci, cm, scale=ci ** -.5).to("cuda", bf)
    wd = rand(k, 27, cm, scale=.2).to("cuda", bf)
    w4 = rand(k, cm, ci, scale=cm ** -.5).to("cuda", bf)
    affine = [rand(k, c, scale=.1, mean=m).cuda()
              for c, m in ((cm, 1.), (cm, 0.), (cm, 1.), (cm, 0.), (ci, .2),
                           (ci, 0.))]
    scratch = torch.empty((2, *shape[:4], cm), dtype=bf, device="cuda")
    return [x, w1, wd, w4, *affine, scratch[0], scratch[1],
            torch.empty_like(x)]


def probe_chain() -> None:
    libs = {name: _compile(f"stage_{i}", src)
            for i, (name, src) in enumerate(chain_variants().items())}
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for tail, (shape, cm, k) in TAILS.items():
        ptrs = [t.data_ptr() for t in _chain_args(shape, cm, k, gen)]
        b, t, h, w, ci = shape
        times = {}
        for name, lib in libs.items():
            fn = lib.tuber_chain_bf16
            fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]

            def call():
                err = fn(*ptrs, b, t, h, w, ci, cm, k, stream)
                if err:
                    raise RuntimeError(f"chain launch: cudaError {err}")

            times[name] = time_ms(call)
        bar = times["barriers only"]
        print(f"[chain phases] {tail} {shape} Cm={cm} K={k}: "
              + "; ".join(f"{n} {ms:.4f} ms" for n, ms in times.items())
              + f"; per block of the chain: barriers {bar / k * 1e3:.2f} us, "
              + ", ".join(f"{p} {(times[f'{p} only'] - bar) / k * 1e3:.2f} us"
                          for p in _LOOPS), flush=True)


def probe_mma() -> None:
    lib = _compile("mma_peak", _PEAK)
    lib.mma_peak.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(256, device="cuda")
    iters = 4000
    for per_sm in (1, 2):
        for accs in (4, 8):
            def call():
                if lib.mma_peak(out.data_ptr(), per_sm * sms, accs, iters):
                    raise RuntimeError("mma_peak launch failed")
            ms = time_ms(call, runs=5, calls=2)
            flop = 2 * 16 * 8 * 16 * accs * iters * 8 * per_sm * sms
            print(f"[mma.sync peak] {per_sm} block(s) of 8 warps an SM, "
                  f"{accs} accumulators a warp: {flop / ms / 1e9:.1f} "
                  f"TFLOP/s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    probe_chain()
    probe_mma()
    return 0


if __name__ == "__main__":
    sys.exit(main())
