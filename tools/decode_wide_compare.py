"""Times the decode kernel's arm for heads wider than 128 (K7w) of one
checkout of the port, with this checkout's chip_smoke.py as the harness, so
that two commits can be held side by side on one card in one call.

For each timed case of chip_smoke.DECODE_WIDE_CASES (the same inputs as
`phase_wide_kernels` draws, `decode_wide_inputs`): the kernel's answer
against its plain version (`check_decode`), its warm device time
(`device_ms`, calls back to back, the valid K and V in L2) and its cold one
(`cold_ms`, a rotation of input sets whose valid K and V exceed twice the
L2), and the bytes bound. Then one step of the wide decoder
(DECODE_WIDE_GEOMETRY, 8 rows) under the profiler (`profile_decode_step`):
device busy time, idle share, and the kernel's share of the busy time.

Run on the card, the checkouts in turns (parent, change, change, parent):

    python tools/decode_wide_compare.py --tree build/parent --label parent
    python tools/decode_wide_compare.py --tree . --label change

Prints one JSON line per case and one for the profile, and appends them,
with a header line naming the card, to --out (default
build/decode_wide_compare.jsonl).
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    p = argparse.ArgumentParser(prog="decode_wide_compare.py")
    p.add_argument("--tree", required=True, help="root of the checkout whose port is timed")
    p.add_argument("--label", required=True)
    p.add_argument("--out", default=str(HERE / "build" / "decode_wide_compare.jsonl"))
    args = p.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import importlib.util
    import numpy as np
    import torch
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)   # this checkout's harness, any tree's port
    spec.loader.exec_module(cs)
    from deeplearning4j_torch.ops import cuda_build
    from deeplearning4j_torch.ops import flash_attention as fa
    if not torch.cuda.is_available():
        print("decode_wide_compare: no CUDA device", file=sys.stderr)
        return 2
    if Path(fa.__file__).resolve().parents[2] != tree:
        raise RuntimeError(f"the port came from {fa.__file__}, not from {tree}")
    src = (tree / "deeplearning4j_torch/ops/csrc/decode_attention.cu").read_text()
    kernel = cs.K7W_KERNEL if cs.K7W_KERNEL in src else "decode_wide_kernel"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    t0 = time.perf_counter()
    cuda_build.build(["decode_attention"])
    lines = [{"label": args.label, "tree": str(tree), "card": card, "kernel": kernel,
              "build_s": time.perf_counter() - t0}]
    dev = torch.device("cuda")
    for label, b, t, h, d, dtype, layers, timed in cs.DECODE_WIDE_CASES:
        if not timed:
            continue
        q, k, v, lens = cs.decode_wide_inputs(torch, label, b, t, h, d, dtype, layers, dev)
        err = cs.check_decode(torch, fa, label, fa._launch_decode(q, k, v, lens), q, k, v,
                              lens)
        bound, _ = cs.decode_bound_ms(q, k, lens)
        sets = cs.rotation(torch, (q, k, v, lens),
                           cs.cold_copies(torch, int(bound * cs.HBM_BYTES_PER_S / 1e3), True))
        run = lambda q_, k_, v_, l_: fa._launch_decode(q_, k_, v_, l_)
        lines.append({"label": args.label, "case": label, "max_abs_err": err,
                      "ms": cs.device_ms(torch, lambda: run(q, k, v, lens)),
                      "ms_cold": cs.cold_ms(torch, run, sets), "bound_ms": bound,
                      "cold_sets": len(sets)})
        print(json.dumps(lines[-1]), flush=True)
        del q, k, v, lens, sets
        torch.cuda.empty_cache()
    g = cs.DECODE_WIDE_GEOMETRY
    eng, _, cache = cs.decode_engine(g, f"decode_wide_compare_{args.label}")
    try:
        prng = np.random.default_rng(24)
        n = g["clients"] * g["prompts_per_client"]
        prompts = [prng.integers(0, g["vocab"], size=ln).tolist()
                   for ln in prng.integers(g["prompt_lo"], g["prompt_hi"], size=n)]
        prof = cs.profile_decode_step(torch, eng, cache, prompts, g["max_decode_batch"],
                                      g["layers"], kernel=kernel)
    finally:
        eng.shutdown()
    lines.append({"label": args.label, "step_profile": {
        key: prof.get(key) for key in ("wall_ms", "unprofiled_wall_ms", "device_busy_ms",
                                       "device_idle_share", "counted_calls", "counted_ms",
                                       "kernel_share_of_busy")}})
    print(json.dumps(lines[-1]), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
