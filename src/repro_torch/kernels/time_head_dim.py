"""Device time of the flash forward at head dim 80, against the layout it
did not take.

    python3 src/repro_torch/kernels/time_head_dim.py

A lane of the forward holds D / 8 = 10 accumulator columns at head dim 80
(hubert-xlarge's 16 heads of 80), laid out as two runs of 4 and a tail of
2 (`csrc/flash_attention.cu`, `col`).  The other route is to stage each
80-wide row zero-padded to 96 columns in shared memory, run the kernel at
96 (12 columns a lane, three runs of 4) and write 80 columns back.  This
script writes that variant under ``build/`` from the same source, by text
substitution, builds both with ``nvcc``, checks at six shapes (fp32 and
bf16, causal and not, kv_len with a 0) that the two give the plain
version's values and the same bits as each other under every plan
`plans_at(80)` admits, then times both under each plan at hubert's
forward (4 x 500 frames) and at 1 x 500 and 4 x 1500 (CUDA-graph
replays, in turns: kept, padded, padded, kept), beside the kernel at head
dims 64 and 128 on the same shapes and torch's scaled_dot_product_attention
(TF32 off, grouped, all pairs live).  Prints one JSON line; exits 1 if a
check fails.  Needs an NVIDIA GPU.
"""
from __future__ import annotations

import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[2]
# (batch, S, H, KV, kv_len or None, causal) of the bitwise checks
CHECKS = [(4, 500, 16, 16, None, False), (2, 100, 8, 2, [100, 0], True),
          (1, 64, 4, 1, [40], False), (3, 130, 4, 4, [130, 60, 1], True),
          (2, 320, 16, 8, None, True), (1, 9, 16, 16, None, False)]
# hubert-xlarge's encoder attention: (batch, frames), 16 / 16 heads
TIMED = {"hubert_4x500": (4, 500), "hubert_1x500": (1, 500),
         "hubert_4x1500": (4, 1500)}
# the edits that turn flash_attention.cu into the padded variant
PAD_EDITS = [
    ('#include "attention_common.cuh"\n#include "gemm_common.cuh"',
     '#include "{csrc}/attention_common.cuh"\n'
     '#include "{csrc}/gemm_common.cuh"'),
    ("Strides vst, int causal) {", "Strides vst, int causal, int dreal) {"),
    ("const bool in = t0 + c < Skv;",
     "const bool in = t0 + c < Skv && e < dreal;"),
    ("const bool in = r < nrows;", "const bool in = r < nrows && e < dreal;"),
    ("* H + h) * D;", "* H + h) * dreal;"),
    ("      store4(orow + col<NC, LPR>(j, 4 * c), w);",
     "      if (col<NC, LPR>(j, 4 * c) < dreal)\n"
     "        store4(orow + col<NC, LPR>(j, 4 * c), w);"),
    ("      attn::store(orow + col<NC, LPR>(j, e),",
     "      if (col<NC, LPR>(j, e) < dreal)\n"
     "        attn::store(orow + col<NC, LPR>(j, e),"),
    ("  int causal;\n  cudaStream_t stream;\n};",
     "  int causal;\n  cudaStream_t stream;\n  int dreal;\n};"),
    ("      a.causal);", "      a.causal, a.dreal);"),
    ("return run_plan<T, 80>(plan, a);", "return run_plan<T, 96>(plan, a);"),
    ("{}, causal, static_cast<cudaStream_t>(stream)};",
     "{}, causal, static_cast<cudaStream_t>(stream), D};"),
]


def build_padded(build, fa):
    """Write, build and bind the padded variant; returns its forward as a
    function of (q, k, v, kv_len, causal, plan) and its ptxas report."""
    csrc = build.CSRC
    text = (csrc / "flash_attention.cu").read_text()
    for old, new in PAD_EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"flash_attention.cu changed: {old!r}")
        text = text.replace(old, new.replace("{csrc}", str(csrc)))
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "flash_attention_pad96.cu"
    lib = build.BUILD_DIR / "libflash_attention_pad96.so"
    src.write_text(text)
    done = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    fn = ctypes.CDLL(str(lib)).flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [fa.STRIDES] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def fwd(q, k, v, kv_len, causal, plan):
        import torch
        b, sq, skv, h, kvh, d, strides = fa.cuda_args(q, k, v, kv_len)
        o = torch.empty_like(q)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if kv_len is None else kv_len.data_ptr(), o.data_ptr(),
                b, sq, skv, h, kvh, d, strides, int(causal),
                fa.DTYPES[q.dtype], fa.PLANS.index(tuple(plan)),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"padded launch failed: {rc}")
        return o

    report = [ln.strip() for ln in (done.stdout + done.stderr).splitlines()
              if "registers" in ln or "spill" in ln]
    return fwd, report


def graph_ms(fn, reps: int = 20, repeats: int = 5) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main() -> int:
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("time_head_dim: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    build.build_all(("flash_attention",))
    padded, report = build_padded(build, fa)

    def qkv(b, s, h, kv, d, dtype):
        q = torch.randn(b, s, h, d, generator=gen, device=dev) / math.sqrt(d)
        k = torch.randn(b, s, kv, d, generator=gen, device=dev)
        v = torch.randn(b, s, kv, d, generator=gen, device=dev)
        return q.to(dtype), k.to(dtype), v.to(dtype)

    out = {"smi": smi, "device": torch.cuda.get_device_name(0),
           "padded_ptxas": report, "checks": [], "timings": {}}
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, h, kv, lens, causal in CHECKS:
            q, k, v = qkv(b, s, h, kv, 80, dtype)
            kvl = (None if lens is None else
                   torch.tensor(lens, dtype=torch.int32, device=dev))
            got = fa.flash_attention_fwd(q, k, v, kvl, causal=causal)
            want = fa.flash_attention_plain(q, k, v, kvl, causal=causal)
            err = float((got.double() - want.double()).abs().max()
                        / want.double().abs().max())
            bits = all(torch.equal(f(p), got) for p in fa.plans_at(80)
                       for f in (lambda p: fa.flash_attention_fwd(
                           q, k, v, kvl, causal=causal, plan=p),
                           lambda p: padded(q, k, v, kvl, causal, p)))
            ok &= bits and err <= (1e-5 if dtype == torch.float32 else 5e-2)
            out["checks"].append({"shape": [b, s, h, kv, lens, causal],
                                  "dtype": str(dtype), "relmax": err,
                                  "bitwise": bits})
    for dtype in (torch.float32, torch.bfloat16):
        for name, (b, s) in TIMED.items():
            q, k, v = qkv(b, s, 16, 16, 80, dtype)
            row = {"pick": list(fa.plan_for(b, s, 16, 16, 80))}
            for p in fa.plans_at(80):
                def kept():
                    return fa.flash_attention_fwd(q, k, v, causal=False,
                                                  plan=p)

                def pad():
                    return padded(q, k, v, None, False, p)

                t = [graph_ms(f) for f in (kept, pad, pad, kept)]
                row[str(tuple(p))] = {"kept_ms": [t[0], t[3]],
                                      "padded_ms": [t[1], t[2]]}
            row["sdpa_ms"] = graph_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    scale=1.0, enable_gqa=True))
            for d in (64, 128):
                qd, kd, vd = qkv(b, s, 16, 16, d, dtype)
                row[f"d{d}_ms"] = graph_ms(lambda: fa.flash_attention_fwd(
                    qd, kd, vd, causal=False))
            out["timings"][f"{name}_{str(dtype)[6:]}"] = row
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
