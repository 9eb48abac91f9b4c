"""Device time of the attention kernels at qwen2-0.5b's shapes.

    python3 src/repro_torch/kernels/time_attention.py [--bwd] [--src DIR]
                                                      [--label L]

Builds the kernels from the package under `--src` (default: this
checkout's ``src``) and prints one JSON line.  Pointing `--src` at the
``src`` of another checkout times that version's kernels on the same
inputs, so two versions can be compared within one run on one card.
Needs an NVIDIA GPU.

Without `--bwd`: the median device time in ms of `flash_attention` and
`flash_decode` over CUDA-graph replays, at a 64-token prefill chunk (batch
1 and 4), a 512-token prompt, and one decode row against 1024 keys at
batch 1 and 8 (the decode kernel's partials alone, and the whole op:
partials and merge, one launch where the kernel merges, else the
partials and `combine`); the forward under every plan (`flash_attention.PLANS`; a
version without plans is timed under its one launch), also as the
training launch (with lse) at `FWD_SHAPES` (the training shape in fp32
and bf16, 2 x 2048, head dim 128, and two sequences around `plan_for`'s
thresholds), against torch's scaled_dot_product_attention forward (TF32 off):
with the boolean mask of the live pairs and grouped heads, and, where
the mask is plain causal, with ``is_causal=True`` on K / V repeated to
the H heads, the repeat timed with it; the faster is the library time.
Per shape it names the plan `plan_for` picks, the fastest plan and the
pick's time over the fastest's; `worst_ratio` is the largest of those.

With `--bwd`: the backward at the training shape (8 x 512, 14 query heads
over 2 kv-heads of 64, causal) in fp32 and bf16, at one long causal
sequence (2 x 2048) and at head dim 128, all with q already scaled: dK /
dV, and dQ and the whole op (Delta and both kernels) under every dQ plan
(`flash_attention.BWD_PLANS`; a version without plans is timed under its
one launch), against torch's scaled_dot_product_attention backward
(TF32 off; autograd's dQ, dK and dV at once, by CUDA events) twice: with
the boolean mask of the live pairs and grouped heads, as the train step's
kernels line times it, and with ``is_causal=True`` on K / V repeated to
the H heads (the repeat and the group sum of dK / dV timed with it).  The
faster is the library time.  Besides those four shapes it times the
shapes at which `bwd_plan_for` picks 16-row dQ blocks, or just misses
them (BWD_SHAPES).  Per shape it names the plan `bwd_plan_for` picks,
the fastest plan and the pick's op time over the fastest's;
`worst_ratio` is the largest of those.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

# (batch, Sq, Skv, kv_len per sequence, causal) with 14 query heads over 2
# kv-heads of 64, as qwen2-0.5b dispatches them
SHAPES = {"prefill_chunk": (1, 64, 1024, [576], True),
          "prefill_chunk_b4": (4, 64, 1024, [576, 300, 900, 64], True),
          "prompt_512": (1, 512, 512, [512], True),
          "decode_b1": (1, 1, 1024, [1024], False),
          "decode_b8": (8, 1, 1024, [1024] * 8, False)}
# (batch, S, H, KV, D, dtype) of the causal self-attention backward
# then chip_smoke.py's lm_train_restart step (reduced qwen2-0.5b: batch
# 2 x 64, 4 / 2 heads of 32) and three of its check_attn_bwd cases (batch
# 2), where the 64-row dQ grid has 8 to 32 blocks, and causal sequences
# whose 64-row grids have 56, 70, 112, 140, 224 and 448 blocks, around
# bwd_plan_for's threshold
BWD_SHAPES = {"train_fp32": (8, 512, 14, 2, 64, "float32"),
              "train_bf16": (8, 512, 14, 2, 64, "bfloat16"),
              "long_2048_fp32": (2, 2048, 14, 2, 64, "float32"),
              "d128_fp32": (8, 512, 14, 2, 128, "float32"),
              "restart_2x64_fp32": (2, 64, 4, 2, 32, "float32"),
              "grid_2x64_fp32": (2, 64, 14, 2, 64, "float32"),
              "grid_2x100_g8_bf16": (2, 100, 8, 1, 64, "bfloat16"),
              "grid_2x64_mha_d128_fp32": (2, 64, 16, 16, 128, "float32"),
              "edge_1x256_fp32": (1, 256, 14, 2, 64, "float32"),
              "edge_1x320_fp32": (1, 320, 14, 2, 64, "float32"),
              "edge_1x512_fp32": (1, 512, 14, 2, 64, "float32"),
              "edge_1x640_fp32": (1, 640, 14, 2, 64, "float32"),
              "edge_2x512_fp32": (2, 512, 14, 2, 64, "float32"),
              "edge_4x512_fp32": (4, 512, 14, 2, 64, "float32")}


# the forward's training launches: the backward's first four shapes, then
# causal sequences whose 64-row grids have 140 and 224 blocks and whose
# 128-row grids 70 and 112, around plan_for's thresholds
FWD_SHAPES = {**dict(list(BWD_SHAPES.items())[:4]),
              "edge_1x640_fp32": (1, 640, 14, 2, 64, "float32"),
              "edge_1x1024_fp32": (1, 1024, 14, 2, 64, "float32")}


def graph_ms(fn, reps: int = 20, repeats: int = 5) -> float:
    """Median device ms of one call: `reps` calls captured in a CUDA graph,
    replayed `repeats` times between CUDA events."""
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


def event_ms(fn, reps: int = 5, repeats: int = 3) -> float:
    """Median over `repeats` of the mean ms of `reps` back-to-back calls
    between CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def sdpa_bwd_ms(q, k, v, do, live, causal: bool = True) -> dict:
    """ms of torch's scaled_dot_product_attention backward (dQ, dK and dV
    at once) for q (B, Sq, H, D), k / v (B, Skv, KV, D), dO like q, q
    already scaled: ``mask`` with the (B, Sq, Skv) bool `live` and grouped
    heads; when `causal` says that `live` is the plain causal mask (Sq ==
    Skv, no kv_len), ``causal`` with ``is_causal=True`` on K / V repeated
    to the H heads, the repeat and the sum of dK / dV over each group of
    heads timed with it, so that both compute the same function; when
    every pair is live and not `causal`, ``unmasked`` with no mask and
    grouped heads; ``library`` the fastest."""
    import torch
    import torch.nn.functional as F
    g = q.shape[2] // k.shape[2]
    dot = do.transpose(1, 2)
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=live[:, None],
                                         scale=1.0, enable_gqa=True)
    res = {"mask": event_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))}
    del out
    if causal:
        # autograd sums the repeated heads' dK / dV back to the kv-heads
        out = F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(g, dim=1),
            vt.repeat_interleave(g, dim=1), is_causal=True, scale=1.0)

        def causal_bwd():
            kt.repeat_interleave(g, dim=1), vt.repeat_interleave(g, dim=1)
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)

        res["causal"] = event_ms(causal_bwd)
    elif bool(live.all()):
        out = F.scaled_dot_product_attention(qt, kt, vt, scale=1.0,
                                             enable_gqa=True)
        res["unmasked"] = event_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True))
    res["library"] = min(res.values())
    return res


def sdpa_fwd_ms(q, k, v, live, causal: bool) -> dict:
    """ms of torch's scaled_dot_product_attention forward for q
    (B, Sq, H, D), k / v (B, Skv, KV, D), q already scaled: ``mask`` with
    the (B, Sq, Skv) bool `live` and grouped heads and, when `causal` says
    that `live` is the plain causal mask (Sq == Skv, no kv_len),
    ``causal`` with ``is_causal=True`` on K / V repeated to the H heads,
    the repeat timed with it; ``library`` the faster."""
    import torch.nn.functional as F
    g = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    res = {"mask": graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=live[:, None], scale=1.0, enable_gqa=True))}
    if causal:
        res["causal"] = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(g, dim=1),
            vt.repeat_interleave(g, dim=1), is_causal=True, scale=1.0))
    res["library"] = min(res.values())
    return res


def time_forward(gen, dev) -> dict:
    """The forward and decode kernels at SHAPES, the forward under every
    plan, and the training launch at the first four BWD_SHAPES."""
    import torch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.ref import attention_mask
    build.build_all(("flash_attention", "flash_decode"))
    plans = getattr(fa, "PLANS", (None,))
    out, worst = {}, 0.0

    def by_plan(b, sq, h, kv, fn):
        """Every plan's ms of fn(plan kwargs), and the pick's ratio."""
        times = {}
        for plan in plans:
            kw = {} if plan is None else {"plan": plan}
            times["default" if plan is None else str(tuple(plan))] = graph_ms(
                lambda kw=kw: fn(**kw))
        row = {"plans": times}
        if plans[0] is not None:
            pick = str(tuple(fa.plan_for(b, sq, h, kv)))
            fastest = min(times, key=times.get)
            row.update(pick=pick, fastest=fastest,
                       ratio=times[pick] / times[fastest])
        row["ms"] = times[row.get("pick", "default")]
        return row

    for name, (b, sq, skv, lens, causal) in SHAPES.items():
        q = torch.randn(b, sq, 14, 64, generator=gen, device=dev) / 8
        k = torch.randn(b, skv, 2, 64, generator=gen, device=dev)
        v = torch.randn(b, skv, 2, 64, generator=gen, device=dev)
        kvl = torch.tensor(lens, dtype=torch.int32, device=dev)
        if ops.use_decode_formulation(sq, skv):
            ns, span = ops.decode_splits(skv, k.shape[2])
            kw = dict(causal=causal, n_splits=ns, span=span)

            def op(kw=kw):  # partials and merge, as ops.attention_decode
                if hasattr(fd, "flash_decode"):  # the merging launch
                    return fd.flash_decode(q, k, v, kvl, **kw)[0]
                return fd.combine(*fd.flash_decode_partials(q, k, v, kvl,
                                                            **kw))

            out[name] = {"partials_ms": graph_ms(
                lambda: fd.flash_decode_partials(q, k, v, kvl, **kw)),
                "op_ms": graph_ms(op)}
            continue
        row = by_plan(b, sq, 14, 2, lambda **kw: fa.flash_attention_fwd(
            q, k, v, kvl, causal=causal, **kw))
        live = attention_mask(b, sq, skv, causal=causal, kv_len=kvl,
                              device=dev).expand(b, sq, skv)
        sd = sdpa_fwd_ms(q, k, v, live, False)
        row.update(sdpa_mask_ms=sd["mask"], library_ms=sd["library"])
        worst = max(worst, row.get("ratio", 0.0))
        out[name] = row
    for name, (b, s, h, kv, d, dt) in FWD_SHAPES.items():
        dtype = getattr(torch, dt)
        q = (torch.randn(b, s, h, d, generator=gen, device=dev)
             / d ** 0.5).to(dtype)
        k = torch.randn(b, s, kv, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, s, kv, d, generator=gen, device=dev).to(dtype)
        row = by_plan(b, s, h, kv, lambda **kw: fa.flash_attention_fwd(
            q, k, v, None, return_lse=True, **kw))
        live = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        sd = sdpa_fwd_ms(q, k, v, live.expand(b, s, s), True)
        row.update(shape=[b, s, s, h, kv, d], dtype=dt, lse=True,
                   sdpa_mask_ms=sd["mask"], sdpa_causal_ms=sd["causal"],
                   library_ms=sd["library"])
        worst = max(worst, row.get("ratio", 0.0))
        out[f"fwd_{name}"] = row
        del q, k, v
    out["worst_ratio"] = worst
    return out


def time_backward(gen, dev) -> dict:
    """The backward kernels, dQ under every plan, at BWD_SHAPES."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    build.build_all(("flash_attention", "flash_attention_bwd"))
    plans = getattr(fa, "BWD_PLANS", (None,))
    out, worst = {}, 0.0
    for name, (b, s, h, kv, d, dt) in BWD_SHAPES.items():
        dtype = getattr(torch, dt)
        q = (torch.randn(b, s, h, d, generator=gen, device=dev)
             / d ** 0.5).to(dtype)
        k = torch.randn(b, s, kv, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, s, kv, d, generator=gen, device=dev).to(dtype)
        do = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, None, return_lse=True)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        by_plan = {}
        dkv_ms = graph_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta))
        for plan in plans:
            kw = {} if plan is None else {"plan": plan}

            def whole(kw=kw):
                dl = (do.float() * o.float()).sum(-1).transpose(1, 2)
                dl = dl.contiguous()
                fa.flash_attention_bwd_dq(q, k, v, do, lse, dl, **kw)
                fa.flash_attention_bwd_dkv(q, k, v, do, lse, dl)

            by_plan["default" if plan is None else str(tuple(plan))] = {
                "dq_ms": graph_ms(lambda kw=kw: fa.flash_attention_bwd_dq(
                    q, k, v, do, lse, delta, **kw)),
                "op_ms": graph_ms(whole)}
        row = {"shape": [b, s, s, h, kv, d], "dtype": dt, "causal": True,
               "dkv_ms": dkv_ms, "plans": by_plan}
        if plans[0] is not None:
            pick = str(tuple(fa.bwd_plan_for(b, s, h, kv, d)))
            fastest = min(by_plan, key=lambda p: by_plan[p]["op_ms"])
            ratio = by_plan[pick]["op_ms"] / by_plan[fastest]["op_ms"]
            row.update(pick=pick, fastest=fastest, ratio=ratio)
            worst = max(worst, ratio)
        live = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        sd = sdpa_bwd_ms(q, k, v, do, live.expand(b, s, s))
        row.update(sdpa_mask_ms=sd["mask"], sdpa_causal_ms=sd["causal"],
                   library_ms=sd["library"])
        out[name] = row
        del q, k, v, do, o, lse, delta
    out["worst_ratio"] = worst
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(Path(__file__).resolve()
                                             .parents[2]))
    parser.add_argument("--label", default="")
    parser.add_argument("--bwd", action="store_true",
                        help="time the backward kernels")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_attention: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"label": args.label, "src": args.src, "smi": smi,
           "device": torch.cuda.get_device_name(0)}
    out.update(time_backward(gen, dev) if args.bwd
               else time_forward(gen, dev))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
