#!/usr/bin/env python3
"""Smoke run of the torch port (deeplearning4j_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit, no result line):

1. Header: the card's name and power limit (nvidia-smi), the torch and CUDA
   versions, and the TF32 settings, which the script fixes to OFF so the
   float32 tolerances below mean float32.
2. Build: every hand-written kernel from the checkout's sources
   (deeplearning4j_torch/ops/csrc), one nvcc per source, all started
   together.
3. Kernels against their plain PyTorch versions on the card, at the shapes
   AlexNet gives them and at edge shapes, with warm CUDA-event times of the
   kernel, the plain version and one PyTorch library call computing the same
   function, beside the least time the card could take (bytes over 3.35 TB/s
   or operations over 67 TFLOP/s float32, whichever is larger; the H100 SXM
   data-sheet peaks).
4. Serving: zoo AlexNet at full width (224x224x3, 1000 classes, random
   weights from its seed) behind a BATCHED ParallelInference (batch_limit
   32), 4 client threads x 8 requests of 1-8 images. Every answer is held to
   `net.output` on the same rows, to a forward whose LRN runs the plain
   version on the card, and (for the first request) to the CPU path, which
   the test suite holds to the JAX package. At random init the window term
   is a small part of k, so these whole-network comparisons barely see LRN;
   the kernel is held to its plain version inside those forwards, on the
   served activations, and on random inputs in phase 3. The launch counts are reset just
   before the clients start and read just after they finish: each kernel of
   the path must have launched, LRN twice per executed forward. Then one
   forward at bucket 32 is profiled: device time against wall time.
5. One JSON line with every kernel's numbers, then the result line
   {"ok": true, "device": {...}}.

Needs one CUDA GPU; exits non-zero without one.
"""
import json
import subprocess
import sys
import threading
import time
from contextlib import contextmanager

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM data sheet, float32 outside tensor cores
LRN_K, LRN_ALPHA, LRN_BETA, LRN_N = 2.0, 1e-4, 0.75, 5  # AlexNet's LRN
LRN_RTOL, LRN_ATOL = 1e-5, 1e-6       # float32 kernel vs float32 plain
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-7   # float32 forwards, cuDNN's choice of algorithm per batch size


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters=20, warm=3):
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def lrn_bound_ms(numel, n):
    """Least time for LRN over `numel` float32 elements: read x and write y
    once (8 bytes), or 2n + 3 operations each (n squares, n - 1 adds, the
    scale, the offset, the power and the divide counted as one each)."""
    bytes_ms = 8.0 * numel / HBM_BYTES_PER_S * 1e3
    ops_ms = (2 * n + 3) * numel / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def phase_header(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log("tf32: cudnn.allow_tf32=False (cuDNN's default is True), "
        "cuda.matmul.allow_tf32=False")
    return card


def phase_build():
    from deeplearning4j_torch.ops import cuda_build
    t0 = time.perf_counter()
    libs = cuda_build.build(["lrn"])
    secs = time.perf_counter() - t0
    log(f"build: {len(libs)} kernel libraries in {secs:.2f} s")
    for name, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    return secs


def phase_lrn(torch, card):
    import torch.nn.functional as F
    from deeplearning4j_torch.ops import lrn as lrn_ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (label, shape, n, alpha, scale of x, timed)
    cases = [
        ("alexnet_lrn1_b128", (128, 55, 55, 64), LRN_N, LRN_ALPHA, 1.0, True),
        ("alexnet_lrn2_b128", (128, 14, 14, 192), LRN_N, LRN_ALPHA, 1.0, True),
        ("alexnet_lrn1_b32", (32, 55, 55, 64), LRN_N, LRN_ALPHA, 1.0, False),
        ("alexnet_lrn2_b32", (32, 14, 14, 192), LRN_N, LRN_ALPHA, 1.0, False),
        ("c3", (7, 5, 9, 3), LRN_N, 1e-2, 3.0, False),
        ("c1", (3, 7, 11, 1), LRN_N, 1e-2, 3.0, False),
        ("even_n4", (4, 9, 9, 64), 4, 1e-2, 3.0, False),
        ("rows_1013_n1", (1, 1, 1013, 96), 1, 1e-2, 3.0, False),
        ("c2048_large_smem", (2, 3, 5, 2048), 7, 1e-2, 3.0, False),
    ]
    rows, worst = [], 0.0
    for label, shape, n, alpha, scale, timed in cases:
        x = torch.randn(shape, device="cuda", generator=gen) * scale
        got = lrn_ops.lrn(x, LRN_K, alpha, LRN_BETA, n)
        torch.cuda.synchronize()
        want = lrn_ops.lrn_reference(x, LRN_K, alpha, LRN_BETA, n)
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=LRN_RTOL, atol=LRN_ATOL)
        worst = max(worst, err)
        row = {"case": label, "shape": list(shape), "n": n,
               "max_abs_err": err}
        if timed:
            lib = F.local_response_norm(
                x.permute(0, 3, 1, 2), n, alpha * n, LRN_BETA, LRN_K
            ).permute(0, 2, 3, 1)
            row["library_max_abs_err"] = (lib - want).abs().max().item()
            row["ms"] = cuda_time_ms(
                lambda: lrn_ops.lrn(x, LRN_K, alpha, LRN_BETA, n))
            row["plain_ms"] = cuda_time_ms(
                lambda: lrn_ops.lrn_reference(x, LRN_K, alpha, LRN_BETA, n))
            row["library_ms"] = cuda_time_ms(
                lambda: F.local_response_norm(x.permute(0, 3, 1, 2), n,
                                              alpha * n, LRN_BETA, LRN_K))
            row["bound_ms"], row["bound_by"] = lrn_bound_ms(x.numel(), n)
        rows.append(row)
        log(f"lrn {label}: {json.dumps(row)}  [{card}]")
        del x, got, want
    timed = [r for r in rows if "ms" in r]
    entry = {
        "name": "lrn_fwd", "route": "cuda",
        "source": "deeplearning4j_torch/ops/csrc/lrn.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:128",
        "launches": None,  # filled from the serving run
        "max_abs_err": worst,
        # one AlexNet forward's two LRN calls at batch 128
        "ms": sum(r["ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": sum(r["bound_ms"] for r in timed),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in timed)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in timed),
    }
    return entry


@contextmanager
def patched(obj, name, value):
    """Bind `obj.name` to `value` for the duration of the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextmanager
def checked_lrn(torch, stats):
    """Run every LRN of the network through the kernel and, on the same
    activations, through the plain version, holding one to the other at
    LRN_RTOL/LRN_ATOL. Records whether the layer's input already was a
    contiguous NHWC tensor (its `.contiguous()` then copies nothing), the
    largest error, and the largest effect of the window term (the distance
    from x * k^-beta, what LRN would give with the window dropped)."""
    from deeplearning4j_torch.nn.layers.convolution import LocalResponseNormalization
    from deeplearning4j_torch.ops import lrn as lrn_ops
    kernel, layer_forward = lrn_ops.lrn, LocalResponseNormalization.forward

    def lrn(x, k, alpha, beta, n):
        got = kernel(x, k, alpha, beta, n)
        want = lrn_ops.lrn_reference(x, k, alpha, beta, n)
        torch.testing.assert_close(got, want, rtol=LRN_RTOL, atol=LRN_ATOL)
        stats["calls"] += 1
        stats["max_abs_err"] = max(stats["max_abs_err"],
                                   (got - want).abs().max().item())
        stats["window_effect"] = max(stats["window_effect"], (
            want - x * k ** -beta).abs().max().item())
        return got

    def forward(self, params, x, **kw):
        stats["input_contiguous"].append(x.is_contiguous())
        return layer_forward(self, params, x, **kw)

    with patched(lrn_ops, "lrn", lrn), \
            patched(LocalResponseNormalization, "forward", forward):
        yield


def phase_serving(torch, card):
    from deeplearning4j_torch.models.zoo import AlexNet
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.ops import lrn as lrn_ops
    from deeplearning4j_torch.parallel.inference import (InferenceMode,
                                                          ParallelInference)
    t0 = time.perf_counter()
    net = AlexNet().init(device="cuda")
    log(f"serving: AlexNet 224x224x3/1000, {net.num_params()} params, "
        f"init {time.perf_counter() - t0:.2f} s")
    pi = ParallelInference(net, inference_mode=InferenceMode.BATCHED,
                           batch_limit=32)
    t0 = time.perf_counter()
    pi.warmup()
    log(f"serving: warmup of buckets {pi.warmed_buckets} in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(2026)
    clients, per_client = 4, 8
    reqs = [[rng.standard_normal((int(rng.integers(1, 9)), 224, 224, 3)
                                 ).astype(np.float32)
             for _ in range(per_client)] for _ in range(clients)]
    answers, lat, errors = {}, [], []
    lat_lock = threading.Lock()

    def client(c):
        try:
            for j, x in enumerate(reqs[c]):
                t = time.perf_counter()
                answers[(c, j)] = pi.output(x)
                with lat_lock:
                    lat.append(time.perf_counter() - t)
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    forwards0 = pi.total_forwards
    lrn_ops.launches = 0  # the main path's run starts here
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = {"lrn_fwd": lrn_ops.launches}  # ... and ends here
    forwards = pi.total_forwards - forwards0
    pi.shutdown()
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"serving clients failed: {errors!r}")
    if forwards < 1 or launches["lrn_fwd"] != 2 * forwards:
        raise RuntimeError(f"lrn launches {launches['lrn_fwd']} != 2 x "
                           f"{forwards} executed forwards")
    images = sum(x.shape[0] for xs in reqs for x in xs)
    log(f"serving: {forwards} forwards, batch sizes "
        f"{list(pi.executed_batch_sizes)[-forwards:]}, lrn launches "
        f"{launches['lrn_fwd']}")

    # correctness: every answer against direct output (its LRNs checked
    # against the plain version on the served activations) and against the
    # whole forward with LRN bound to the plain version
    max_direct = max_plain = 0.0
    lrn_stats = {"calls": 0, "max_abs_err": 0.0, "window_effect": 0.0,
                 "input_contiguous": []}
    for (c, j), out in answers.items():
        x = reqs[c][j]
        if out.shape != (x.shape[0], 1000) or not np.isfinite(out).all():
            raise RuntimeError(f"bad answer shape/values {out.shape}")
        np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)
        with checked_lrn(torch, lrn_stats):
            direct = net.output(x)
        with patched(lrn_ops, "lrn", lrn_ops.lrn_reference):
            plain = net.output(x)
        np.testing.assert_allclose(out, direct, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        np.testing.assert_allclose(out, plain, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        if not (np.array_equal(out.argmax(-1), direct.argmax(-1))
                and np.array_equal(out.argmax(-1), plain.argmax(-1))):
            raise RuntimeError(f"top-1 disagrees on request {(c, j)}")
        max_direct = max(max_direct, float(np.abs(out - direct).max()))
        max_plain = max(max_plain, float(np.abs(out - plain).max()))
    if lrn_stats["calls"] != 2 * len(answers):
        raise RuntimeError(f"checked {lrn_stats['calls']} LRN calls, expected "
                           f"2 x {len(answers)} forwards")
    # The check above is only as sharp as the window term is large: hold the
    # error to a hundredth of it, so a kernel that dropped the window fails.
    if not lrn_stats["max_abs_err"] < 0.01 * lrn_stats["window_effect"]:
        raise RuntimeError(f"LRN error {lrn_stats['max_abs_err']} is not under "
                           f"1% of the window's effect {lrn_stats['window_effect']}")
    lrn_stats["input_contiguous"] = all(lrn_stats["input_contiguous"])
    log(f"serving: LRN on the served activations: {json.dumps(lrn_stats)} "
        f"(rtol {LRN_RTOL}, atol {LRN_ATOL})")
    # the CPU path, which tests/test_torch_mln.py holds to the JAX package
    cpu_net = MultiLayerNetwork(net.conf)
    cpu_net.init(device="cpu")
    cpu_net.params_tree = tuple({k: v.cpu() for k, v in layer.items()}
                                for layer in net.params_tree)
    x0 = reqs[0][0]
    cpu_out = cpu_net.output(x0)
    np.testing.assert_allclose(answers[(0, 0)], cpu_out, rtol=SERVE_RTOL,
                               atol=SERVE_ATOL)
    max_cpu = float(np.abs(answers[(0, 0)] - cpu_out).max())
    lat_ms = np.asarray(lat) * 1e3
    result = {
        "requests": len(lat), "images": images, "forwards": forwards,
        "wall_s": wall, "images_per_s": images / wall,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "max_abs_err_vs_direct": max_direct,
        "max_abs_err_vs_plain_lrn": max_plain,
        "max_abs_err_vs_cpu": max_cpu,
        "lrn_in_forward": lrn_stats,
        "launches": launches, "card": card,
        "profile": profile_forward(
            torch, net, rng.standard_normal((32, 224, 224, 3)).astype(np.float32)),
    }
    log(f"serving: p50 {result['p50_ms']:.3f} ms p99 {result['p99_ms']:.3f} ms, "
        f"{result['images_per_s']:.1f} images/s  [{card}]")
    log(f"serving: max abs err vs direct {max_direct:.3e}, vs plain LRN "
        f"{max_plain:.3e}, vs CPU {max_cpu:.3e} (rtol {SERVE_RTOL}, atol {SERVE_ATOL})")
    return result


def profile_forward(torch, net, x):
    """One warm `net.output` at bucket size under torch.profiler: the
    device's summed kernel and copy time against the unprofiled wall time
    of the same call (median of 5), and the five largest device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(5):
        t = time.perf_counter()
        net.output(x)  # returns numpy: ends synchronized
        walls.append((time.perf_counter() - t) * 1e3)
    wall_ms = float(np.median(walls))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        net.output(x)
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    out = {"batch": int(x.shape[0]), "wall_ms": wall_ms,
           "device_busy_ms": busy_ms if dev else None,
           "device_idle_share": (1.0 - busy_ms / wall_ms) if dev else None,
           "top": [[e.key[:80], e.count, e.self_device_time_total / 1e3]
                   for e in top]}
    log(f"profile: {json.dumps(out)}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    card = phase_header(torch)
    phase_build()
    lrn_entry = phase_lrn(torch, card)
    serving = phase_serving(torch, card)
    lrn_entry["launches"] = serving["launches"]["lrn_fwd"]
    kernels = {"kernels": [lrn_entry]}
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
