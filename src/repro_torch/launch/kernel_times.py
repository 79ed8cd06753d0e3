"""Time the served models' attention and RG-LRU kernels and the sweep kernel on the card.

At the shapes of the serving path (glm4-9b: q (2, 4096, 32, 128), k / v
(2, 4096, 2, 128), causal; recurrentgemma-9b: q (2, 4096, 16, 256), k / v
(2, 4096, 1, 256), window 2048; its RG-LRU scan: (2, 4096, 4096) float32),
on random inputs from a seeded generator on the card, and for ``spot_sweep``
on the inputs of ``chip_smoke.full_study()`` (the §VII study at full width),
each kernel is held against its plain version once (``chip_smoke.py``'s
tolerances; the RG-LRU scan and the sweep bit for bit) and its bare launch
is timed with CUDA events beside its bound and, for attention,
``scaled_dot_product_attention``.  One JSON line a kernel and shape, then the
card's name and power limit.

    python src/repro_torch/launch/kernel_times.py [--checkout DIR] [--reps N] [--kernels NAME ...]

``--checkout`` runs another checkout's kernels (its ``src/`` and
``chip_smoke.py``, e.g. an unpacked ``git archive`` of the parent commit), so
two versions can be compared in one call on one card: parent, change, change,
parent.  Run the file by its path (not with ``-m``), so that the package is
imported from that checkout.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

#: (label, kernel, q heads, kv heads, head dim, window) of the served layers
CASES = (
    ("glm4-9b", "flash_attention", 32, 2, 128, 0),
    ("recurrentgemma-9b", "flash_attention", 16, 1, 256, 2048),
    ("recurrentgemma-9b", "rglru_scan", None, None, None, None),
)
BATCH, SEQ, WIDTH = 2, 4096, 4096
KERNELS = ("flash_attention", "rglru_scan", "spot_sweep")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkout", type=Path, default=Path(__file__).resolve().parents[3])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--kernels", nargs="+", choices=KERNELS, default=KERNELS)
    args = parser.parse_args(argv)
    root = args.checkout.resolve()
    loaded = sys.modules.get("repro_torch")
    if loaded is not None and not Path(loaded.__file__).resolve().is_relative_to(root / "src"):
        raise SystemExit(f"repro_torch is already imported from {loaded.__file__}; run this file by its path")
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke_of_checkout", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.rglru_scan import kernel as rglru
    from repro_torch.kernels.rglru_scan import ref as rglru_ref
    from repro_torch.kernels.spot_sweep import kernel as sweep
    from repro_torch.kernels.spot_sweep import ref as sweep_ref

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for model, name, H, KV, D, window in CASES:
        if name not in args.kernels:
            continue
        if name == "flash_attention":
            q = torch.randn((BATCH, SEQ, H, D), generator=gen, device=dev).bfloat16()
            k, v = (torch.randn((BATCH, SEQ, KV, D), generator=gen, device=dev).bfloat16() for _ in range(2))
            kw = dict(causal=True, window=window, q_offset=0)
            job = flash.prepare(q, k, v, **kw)
            got = flash.launch(job)
            want = flash_ref.block_attention(q, k, v, q_block=1024, kv_block=1024, **kw)
            torch.cuda.synchronize()
            err = smoke.check_close(got, want, smoke.ATTN_TOL["bfloat16"], f"{model} attention")
            ms = smoke.time_ms(lambda: flash.launch(job), reps=args.reps)
            bound = smoke.attention_bound(q, k, True, window, 0)[0]
            library = smoke.sdpa_ms(q, k, v, True, window, 0)
            row = {"shape": [list(q.shape), list(k.shape)], "library_ms": library, "vs_library": ms / library}
        else:
            log_a = -torch.nn.functional.softplus(torch.randn((BATCH, SEQ, WIDTH), generator=gen, device=dev))
            gx = torch.randn((BATCH, SEQ, WIDTH), generator=gen, device=dev)
            job = rglru.prepare(log_a, gx)
            got = rglru.launch(job)
            want = rglru_ref.rglru_scan(log_a, gx)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError("rglru_scan differs from its plain version")
            err = 0.0
            ms = smoke.time_ms(lambda: rglru.launch(job), reps=args.reps)
            bound = smoke.scan_bound("rglru_scan", (log_a, gx))[0]
            row = {"shape": list(log_a.shape)}
        print(json.dumps({"kernel": name, "model": model, "checkout": str(root), "max_abs_err": err, "ms": ms,
                          "bound_ms": bound, "bound_share": bound / ms, **row}), flush=True)
        del got, want, job
    if "spot_sweep" in args.kernels:
        sweep_args = smoke.sweep_args(smoke.full_study(), dev)
        job = sweep.prepare(*sweep_args)
        got = sweep.launch(job)
        want = sweep_ref.sweep_plain(*sweep_args)
        torch.cuda.synchronize()
        err = smoke.compare_outputs(got, want, "full width sweep")  # bit for bit, or raises
        ms = smoke.time_ms(lambda: sweep.launch(job), reps=args.reps)
        bound = smoke.sweep_bound(sweep_args, got)[0]
        print(json.dumps({"kernel": "spot_sweep", "model": "full-width study", "checkout": str(root),
                          "max_abs_err": err, "ms": ms, "bound_ms": bound, "bound_share": bound / ms,
                          "shape": [len(sweep_args[0]), *sweep_args[1].shape]}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
