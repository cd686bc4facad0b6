#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one GPU.

Run ``python3 chip_smoke.py`` from the root of a checkout on a machine with
an NVIDIA H100 and the CUDA toolkit. It builds the port's CUDA kernels from
``bigdl_tpu_torch/kernels/csrc``, then:

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. prints the build time;
3. holds each kernel against its plain PyTorch version on the card
   (LayerNorm at (8·1024, 512) fp32/bf16; flash attention at (2, 8, T, 64)
   with T in {1024, 1000}, causal and not, fp32/bf16), and times the
   kernel, the plain version and the one PyTorch call that computes the
   same function (a yardstick only; the port never calls it);
4. runs the full-sequence forward of the served model,
   ``TransformerLM(32000, 512, 8, 6, 1024)`` with seeded random weights, on
   a (2, 512) batch through both kernels, against the same weights on the
   CPU with the plain LayerNorm and ``attention_impl="full"``;
5. serves 16 requests (prompt lengths 17..700, 32 new tokens each) from 4
   client threads through ``ServingEngine(lm, max_len=1024, slots=8)`` and
   holds every request's tokens against the port's solo
   ``greedy_generate``, then times one decode step of the slot grid on the
   card and on the host;
6. checks that phases 4 and 5 (the main path) launched both kernels, and
   prints the kernel table as one JSON line, the card line, and the result
   line ``{"ok": true, "device": {...}}`` last.

Any failed check exits non-zero without the result line, as does a machine
without CUDA or a directory without the package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

SEED = 1234
VOCAB, EMBED, HEADS, LAYERS, MAX_LEN = 32000, 512, 8, 6, 1024
SLOTS, N_REQUESTS, N_CLIENTS, NEW_TOKENS = 8, 16, 4, 32
PROMPT_LO, PROMPT_HI = 17, 700
NEAR_TIE = 1e-4          # top-2 log-prob gap under which a token may differ
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # fp32 non-tensor, bf16
SM_CLOCK_HZ = 1.98e9                            # H100 SXM boost clock


class CheckFailed(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise CheckFailed(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- timing
def time_ms(fn, reps: int = 20, trials: int = 5) -> tuple[float, float]:
    """(device ms, host ms) of one call of ``fn``. Device: the median over
    ``trials`` of CUDA events around ``reps`` back-to-back calls; a spin
    kernel (``torch.cuda._sleep``) holds the stream while the host enqueues
    them, so the calls run back to back and the events time the card rather
    than the host's launch rate. Host: the time to enqueue one call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(2 * max(enqueue_s, 1e-4) * SM_CLOCK_HZ)
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), enqueue_s * 1e3 / reps


def bound_ms(bytes_moved: float, flops: float, dtype_name: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def within(got, want, atol, rtol) -> bool:
    err = (got.float() - want.float()).abs()
    return bool((err <= atol + rtol * want.float().abs()).all())


# ------------------------------------------------------- phase 3: kernels
def check_layer_norm(kernels, card):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = [((8 * 1024, EMBED), torch.float32, 1e-5, 1e-5),
             ((8 * 1024, EMBED), torch.bfloat16, 2e-2, 0.0),
             ((2 * 512, EMBED), torch.float32, 1e-5, 1e-5)]   # main path
    rows = []
    for (n, h), dtype, atol, rtol in cases:
        x = torch.randn(n, h, generator=g, device=dev).to(dtype)
        gamma = 1 + 0.1 * torch.randn(h, generator=g, device=dev)
        beta = 0.1 * torch.randn(h, generator=g, device=dev)
        got = kernels.layer_norm_cuda(x, gamma, beta, 1e-5)
        want = kernels.layer_norm_reference(x, gamma, beta, 1e-5)
        torch.cuda.synchronize()
        err = max_err(got, want)
        ok = within(got, want, atol, rtol)
        k_ms, _ = time_ms(
            lambda: kernels.layer_norm_cuda(x, gamma, beta, 1e-5), 50)
        p_ms, _ = time_ms(
            lambda: kernels.layer_norm_reference(x, gamma, beta, 1e-5), 50)
        g_lib, b_lib = gamma.to(dtype), beta.to(dtype)
        l_ms, _ = time_ms(lambda: torch.nn.functional.layer_norm(
            x, (h,), g_lib, b_lib, 1e-5), 50)
        item = x.element_size()
        b_ms, b_by = bound_ms(2 * n * h * item + 2 * h * 4, 8.0 * n * h,
                              str(dtype).split(".")[-1])
        log(f"  layer_norm ({n}, {h}) {str(dtype)[6:]}: max|err| {err:.3e} "
            f"(atol {atol}, rtol {rtol}) {'ok' if ok else 'FAIL'}; kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"F.layer_norm {l_ms:.4f} ms, bound {b_ms:.4f} ms [{card}]")
        if not ok:
            raise CheckFailed(f"layer_norm ({n}, {h}) {dtype} disagrees with "
                              f"its plain version: max|err| {err}")
        rows.append(dict(shape=[n, h], dtype=str(dtype)[6:], err=err,
                         ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


def check_flash(kernels, card):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases = []
    for t in (1024, 1000):
        for causal in (True, False):
            for dtype, atol, rtol in ((torch.float32, 2e-4, 2e-4),
                                      (torch.bfloat16, 2e-2, 0.0)):
                cases.append(((2, HEADS, t, 64), causal, dtype, atol, rtol))
    cases.append(((2, HEADS, 512, 64), True, torch.float32, 2e-4, 2e-4))
    rows = []
    for (b, h, t, d), causal, dtype, atol, rtol in cases:
        q, k, v = (torch.randn(b * h, t, d, generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        o, lse = kernels.flash_attention_cuda(q, k, v, causal)
        o_ref, lse_ref = kernels.flash_attention_reference(q, k, v, causal)
        torch.cuda.synchronize()
        err = max(max_err(o, o_ref), max_err(lse, lse_ref))
        ok = (within(o, o_ref, atol, rtol)
              and within(lse, lse_ref, atol, rtol))
        k_ms, _ = time_ms(
            lambda: kernels.flash_attention_cuda(q, k, v, causal))
        p_ms, _ = time_ms(lambda: kernels.flash_attention_reference(
            q, k, v, causal))
        q4, k4, v4 = (x.view(b, h, t, d) for x in (q, k, v))
        l_ms, _ = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal))
        pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
        item = q.element_size()
        b_ms, b_by = bound_ms(4 * b * h * t * d * item + b * h * t * 4,
                              4.0 * d * pairs, str(dtype).split(".")[-1])
        log(f"  flash ({b}, {h}, {t}, {d}) causal={causal} {str(dtype)[6:]}:"
            f" max|err| {err:.3e} (atol {atol}, rtol {rtol}) "
            f"{'ok' if ok else 'FAIL'}; kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, sdpa {l_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms [{card}]")
        if not ok:
            raise CheckFailed(f"flash ({b},{h},{t},{d}) causal={causal} "
                              f"{dtype} disagrees with its plain version: "
                              f"max|err| {err}")
        rows.append(dict(shape=[b, h, t, d], causal=causal,
                         dtype=str(dtype)[6:], err=err, ms=k_ms,
                         plain_ms=p_ms, library_ms=l_ms,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


# ------------------------------------------------------- phases 4 and 5
def build_lm(TransformerLM, attention_impl, device):
    return TransformerLM(VOCAB, EMBED, HEADS, LAYERS, MAX_LEN,
                         attention_impl=attention_impl,
                         generator=torch.Generator().manual_seed(SEED),
                         device=device).evaluate()


def full_forward(lm, TransformerLM):
    g = torch.Generator().manual_seed(SEED + 2)
    ids = torch.randint(0, VOCAB, (2, 512), generator=g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        lp = lm(ids.cuda())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if tuple(lp.shape) != (2, 512, VOCAB) or not bool(lp.isfinite().all()):
        raise CheckFailed(f"full forward gave shape {tuple(lp.shape)} or "
                          f"non-finite log-probs")
    ref = build_lm(TransformerLM, "full", "cpu")
    with torch.no_grad():
        lp_ref = ref(ids)
    err = max_err(lp.cpu(), lp_ref)
    log(f"  full forward (2, 512): {wall * 1e3:.1f} ms (first call); "
        f"max|log-prob err| vs CPU plain model {err:.3e} (atol 1e-3)")
    if err > 1e-3:
        raise CheckFailed(f"full forward disagrees with the plain model: "
                          f"{err}")
    return err


def serve(lm, ServingEngine):
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(PROMPT_LO, PROMPT_HI + 1, N_REQUESTS)
    prompts = [rng.integers(0, VOCAB, int(n)).astype(np.int32)
               for n in lengths]
    engine = ServingEngine(lm, max_len=MAX_LEN, slots=SLOTS)
    handles = [None] * N_REQUESTS
    errors = []

    def client(c):
        try:
            for i in range(c, N_REQUESTS, N_CLIENTS):
                handles[i] = engine.submit(prompts[i], NEW_TOKENS,
                                           request_id=i)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(c,))
               for c in range(N_CLIENTS)]
    for th in clients:
        th.start()
    for th in clients:
        th.join(120)
    try:
        if errors or any(h is None for h in handles):
            raise CheckFailed(f"submit failed: {errors}")
        results = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        stats = engine.stats()
    finally:
        engine.shutdown()
    return prompts, results, wall, stats


def decode_step_ms(lm, install_decode_cache, card):
    """Device and host time of one cached decode step of the model over
    the full slot grid, the work of one engine tick without its host
    transfers."""
    state = install_decode_cache(lm, SLOTS, MAX_LEN)
    tok = torch.zeros((SLOTS, 1), dtype=torch.long, device="cuda")
    with torch.no_grad():
        dev_ms, host_ms = time_ms(lambda: lm.run(tok, state), reps=2)
    log(f"  decode step ({SLOTS} slots, cache {MAX_LEN}): device "
        f"{dev_ms:.3f} ms, host enqueue {host_ms:.3f} ms; device busy "
        f"{dev_ms / host_ms:.1%} of the host's time [{card}]")


def near_tie_gap(lm, seq) -> float:
    """Top-2 log-prob gap of the model's next-token distribution after
    ``seq`` (the full-sequence forward)."""
    with torch.no_grad():
        lp = lm(torch.as_tensor(np.asarray(seq), dtype=torch.long)[None]
                .cuda())[0, -1]
    top = lp.topk(2).values
    return float(top[0] - top[1])


def check_served_tokens(lm, greedy_generate, prompts, results):
    for i, (p, r) in enumerate(zip(prompts, results)):
        if r.n_generated != NEW_TOKENS:
            raise CheckFailed(f"request {i} generated {r.n_generated} tokens")
        ref = greedy_generate(lm, p[None], NEW_TOKENS)[0].cpu().numpy()
        diff = np.nonzero(ref != r.tokens)[0]
        if diff.size == 0:
            continue
        j = int(diff[0])
        gap = near_tie_gap(lm, ref[:j])
        log(f"  request {i}: token {j - len(p)} differs from solo "
            f"greedy_generate; reference top-2 gap there {gap:.3e}")
        if gap >= NEAR_TIE:
            raise CheckFailed(f"request {i} tokens differ from solo "
                              f"greedy_generate at a gap of {gap}")
    # the first served token is the argmax of the full-sequence forward
    p, r = prompts[0], results[0]
    with torch.no_grad():
        lp = lm(torch.as_tensor(p, dtype=torch.long)[None].cuda())[0, -1]
    first = int(lp.argmax())
    if first != int(r.generated[0]):
        gap = near_tie_gap(lm, p)
        log(f"  request 0 first token {int(r.generated[0])} vs full-forward "
            f"argmax {first}; top-2 gap {gap:.3e}")
        if gap >= NEAR_TIE:
            raise CheckFailed("first served token differs from the "
                              "full-sequence forward's argmax")


# -------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "GPU only", file=sys.stderr)
        return 2
    try:
        import bigdl_tpu_torch
        from bigdl_tpu_torch import kernels
        from bigdl_tpu_torch.kernels import _cuda
        from bigdl_tpu_torch.models.transformerlm import TransformerLM
        from bigdl_tpu_torch.nn import greedy_generate, install_decode_cache
        from bigdl_tpu_torch.serving import ServingEngine
    except ImportError as e:
        print(f"chip_smoke: the bigdl_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    if Path(bigdl_tpu_torch.__file__).resolve().parent.parent != here:
        print(f"chip_smoke: bigdl_tpu_torch was imported from "
              f"{bigdl_tpu_torch.__file__}, not from this checkout ({here})",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")

    log("phase 2: build")
    lib = _cuda.library()
    log(f"  built {lib.path} in {lib.build_seconds:.1f} s")

    log("phase 3: kernels against their plain versions")
    ln_rows = check_layer_norm(kernels, card)
    fa_rows = check_flash(kernels, card)

    log("phase 4: full-sequence forward, full width")
    lm = build_lm(TransformerLM, "auto", "cuda")
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"  TransformerLM({VOCAB}, {EMBED}, {HEADS}, {LAYERS}, {MAX_LEN}): "
        f"{n_params} parameters")
    # the main path is phases 4 and 5: counted from here ...
    kernels.reset_launch_counts()
    full_forward(lm, TransformerLM)
    fwd_counts = kernels.launch_counts()

    log("phase 5: serving")
    prompts, results, wall, stats = serve(lm, ServingEngine)
    launches = kernels.launch_counts()     # ... to here
    ttft = np.array([r.ttft_s for r in results]) * 1e3
    generated = sum(r.n_generated for r in results)
    log(f"  {len(results)} requests, {generated} tokens in {wall:.3f} s "
        f"({generated / wall:.1f} tokens/s with prefill); decode "
        f"{stats['decode_tokens'] / stats['decode_seconds']:.1f} tokens/s "
        f"over {stats['decode_ticks']} ticks; TTFT p50 "
        f"{np.percentile(ttft, 50):.1f} ms, p99 {np.percentile(ttft, 99):.1f}"
        f" ms [{card}]")
    log(f"  engine stats: {stats}")
    log(f"  launches: full forward {fwd_counts}, serving "
        f"{ {k: launches[k] - fwd_counts[k] for k in launches} }")
    for name, n in launches.items():
        if n == 0:
            raise CheckFailed(f"the main path never launched {name}")
    check_served_tokens(lm, greedy_generate, prompts, results)
    log("  served tokens match solo greedy_generate")
    decode_step_ms(lm, install_decode_cache, card)

    ln, fa = ln_rows[-1], fa_rows[-1]     # the main path's shapes
    table = {"kernels": [
        {"name": "layer_norm_fwd", "route": "cuda",
         "source": "bigdl_tpu_torch/kernels/csrc/layernorm.cu",
         "replaces": "bigdl_tpu/kernels/layernorm.py:31",
         "launches": launches["layer_norm_fwd"], "shape": ln["shape"],
         "dtype": ln["dtype"], "max_abs_err": ln["err"], "ms": ln["ms"],
         "plain_ms": ln["plain_ms"], "bound_ms": ln["bound_ms"],
         "bound_by": ln["bound_by"], "library_ms": ln["library_ms"]},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "bigdl_tpu_torch/kernels/csrc/flash_attention.cu",
         "replaces": "bigdl_tpu/kernels/flash_attention.py:54",
         "launches": launches["flash_attention_fwd"], "shape": fa["shape"],
         "dtype": fa["dtype"], "max_abs_err": fa["err"], "ms": fa["ms"],
         "plain_ms": fa["plain_ms"], "bound_ms": fa["bound_ms"],
         "bound_by": fa["bound_by"], "library_ms": fa["library_ms"]},
    ]}
    print(json.dumps(table), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
