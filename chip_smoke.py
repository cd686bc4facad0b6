#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one GPU.

Run ``python3 chip_smoke.py`` from the root of a checkout on a machine with
an NVIDIA H100 and the CUDA toolkit. It builds the port's CUDA kernels from
``bigdl_tpu_torch/kernels/csrc``, then:

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. prints the build time and, for every instance of the three flash
   kernels (forward, dq, dk/dv), its registers and spills (``ptxas -v``),
   threads, dynamic shared memory and the count of ``HGMMA`` (tensor-core)
   and ``UTMALDG`` (TMA) instructions in its SASS (``cuobjdump -sass``); a
   zero count or a spill fails;
3. times an empty kernel launched through the C interface (the launch
   floor), then holds each kernel against its plain PyTorch version on the
   card (the LayerNorm forward at every main-path shape: (8, 512),
   (700, 512), (2·512, 512), (16·512, 512) fp32 and bf16, (1024, 256), and
   the bf16 step's (16·512, 512) and (2·512, 512) with bf16 gamma and
   beta; the LayerNorm backward at (16·512, 512) fp32, bf16 and bf16 with
   bf16 gamma, (2·512, 512) fp32 and bf16 with bf16 gamma, with dgamma and
   dbeta bitwise equal across two calls; the flash forward
   and the two flash backward kernels at (2, 8, T, 64) with T in
   {1024, 1000}, causal
   and not, fp32/bf16, and the forward also at the main paths' causal
   (2·8, 512, 64) and (16·8, 512, 64) in fp32 and bf16, the backward at
   the training step's (16·8, 512, 64) causal in fp32 and bf16), and times
   the kernel, the plain version and the one PyTorch call that computes
   the same function (a yardstick only; the port never calls it). fp32
   flash rows carry two bounds: FMA (fp32 at 67 TFLOP/s) and 3xTF32 (the
   kernels' three TF32 products at 495 TFLOP/s);
4. runs the full-sequence forward of the served model,
   ``TransformerLM(32000, 512, 8, 6, 1024)`` with seeded random weights, on
   a (2, 512) batch through both forward kernels, against the same weights
   on the CPU with the plain LayerNorm and ``attention_impl="full"``;
5. serves 16 requests (prompt lengths 17..700, 32 new tokens each) from 4
   client threads through ``ServingEngine(lm, max_len=1024, slots=8)``,
   whose prefill, decode and assign programs run as captured CUDA graphs,
   twice on the same engine (the first round captures each program at its
   first use, the second replays only; each round's decode rate, tick,
   prefill and TTFT), and holds every request's tokens against the port's
   solo ``greedy_generate``; checks the engine's program ledger
   (``compiled_programs`` = buckets used + 2, within ``len(buckets) + 2``)
   and that every model call launched the LayerNorm forward 13 times; then
   times one decode step of the slot grid eagerly and as a replayed graph
   (device and host), with the replayed step's log-probs and launches held
   against the eager step's;
6. trains the repo's training configuration,
   ``TransformerLM(32000, 512, 8, 6, max_len=512)`` with ``lm_criterion()``:
   the loss and every parameter's gradient of one (2, 512) step against the
   same weights on the CPU (``attention_impl="full"``), then 17 steps of
   ``LocalOptimizer`` with ``SGD(0.01, momentum=0.9, dampening=0)`` at
   batch 16 × 512 on ``synthetic_ptb`` windows (the step a captured graph,
   replayed after its first step), every loss finite, with the step time
   and tokens/s and one profiled replayed step (device time by kernel name,
   the GEMMs' share, the device's busy share, ``cudaLaunchKernel`` and
   ``cudaGraphLaunch`` calls), and again with ``set_fuse_steps(8)``; each
   of the two runs is held against the same steps run eagerly on the card
   (losses, parameters, launches); then the same under the bf16
   mixed-precision policy (``Engine.init(compute_dtype=torch.bfloat16)``,
   the JAX training leg's default): one (2, 512) step's loss and master
   gradients against the port's plain bf16 step on the CPU, the two timed
   runs with their eager comparisons and a profiled step, with the bf16
   step time and tokens/s beside the fp32 ones, then 17 bf16 steps with
   the flat update and 17 with every block under ``Remat`` (their step
   times; remat's losses within 1e-4 relative of the plain run's);
7. checks that the serving path (phases 4 and 5) launched both forward
   kernels and each training run (the 17 steps, fp32 and bf16) all five,
   every launch in the run's dtype (bf16 operands and bf16 gamma and beta
   under the bf16 policy), the LayerNorm backward once for each LayerNorm
   (the forward kernels once a step without remat, twice in each block
   with it) and the plain backward never, and prints the kernel table as
   one JSON line (each kernel's row with its bf16 training instance), the
   card line, and the result line ``{"ok": true, "device": {...}}`` last.

Any failed check exits non-zero without the result line, as does a machine
without CUDA or a directory without the package.
"""

from __future__ import annotations

import itertools
import json
import math
import re
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
TRAIN_LEN, TRAIN_BATCH, TRAIN_STEPS = 512, 16, 8   # benchmark.py:55,164
# iterations of a timed run: one epoch of 8 batches, a second, and one
# more, so that set_fuse_steps(8) runs one window that holds the capture
# and a second of replays only
TRAIN_ITERS = 2 * TRAIN_STEPS + 1
FUSE = 8
DEVICE = "cuda"
SLOTS, N_REQUESTS, N_CLIENTS, NEW_TOKENS = 8, 16, 4, 32
PROMPT_LO, PROMPT_HI = 17, 700
NEAR_TIE = 1e-4          # top-2 log-prob gap under which a token may differ
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # fp32 non-tensor, bf16
TF32_FLOPS = 495e12                             # tensor cores, dense
SM_CLOCK_HZ = 1.98e9                            # H100 SXM boost clock
L2_BYTES = 50e6                                 # H100 SXM L2 cache


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


# ---------------------------------------------------------------- phase 2
FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_kernel")


def _instance(mangled: str) -> tuple:
    """(kernel, dtype, d, warpgroups) of a mangled flash kernel<T, D, NWG>."""
    m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(f|13__nv_bfloat16)"
                  r"Li(\d+)ELi(\d+)E", mangled)
    if m is None:
        raise CheckFailed(f"unexpected flash kernel name {mangled}")
    return (m.group(1), "float32" if m.group(2) == "f" else "bfloat16",
            int(m.group(3)), int(m.group(4)))


def _sections(lines, start):
    """(name, line) for each line inside a section of a flash kernel
    instance; `start` finds a section's name in its first line."""
    current = None
    for line in lines:
        m = re.search(start, line)
        if m:
            current = m.group(1) if re.search(
                "|".join(FLASH_KERNELS), m.group(1)) else None
        elif current is not None:
            yield current, line


def report_flash_build(lib, kernels, nvcc):
    """Registers and spills (ptxas -v), threads, dynamic shared memory and
    the SASS counts of tensor-core (HGMMA) and TMA (UTMALDG) instructions
    of every instance of the three flash kernels. Fails if an instance
    spills or has none of either instruction."""
    info = {}
    for name, line in _sections(lib.build_log.splitlines(),
                                r"Compiling entry function '(\S+)'"):
        row = info.setdefault(_instance(name), {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            row["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m.group(1))
    if not info:
        raise CheckFailed("the build log holds no ptxas report of the flash "
                          "kernels: was the library built with -Xptxas -v?")
    out = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                          str(lib.path)], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        raise CheckFailed(f"cuobjdump failed: {out.stderr.strip()[:500]}")
    for name, line in _sections(out.stdout.splitlines(),
                                r"Function : (\S+)"):
        row = info.setdefault(_instance(name), {})
        for op in ("HGMMA", "UTMALDG"):
            row[op] = row.get(op, 0) + (op in line)
    plans = {"flash_fwd_kernel": kernels.forward_launch_plan,
             "flash_bwd_dq_kernel": lambda *a: kernels.backward_launch_plan(
                 *a, dkv=False),
             "flash_bwd_dkv_kernel": lambda *a: kernels.backward_launch_plan(
                 *a, dkv=True)}
    for kernel, plan_fn in plans.items():
        for dtype in (torch.float32, torch.bfloat16):   # 1, then 2 WGs
            for d in (32, 64, 128):
                for bh in (1, 1 << 16):
                    plan = plan_fn(bh, 1024, d, dtype)
                    key = (kernel, str(dtype)[6:], d, plan["warpgroups"])
                    info.setdefault(key, {})["smem_bytes"] = \
                        plan["smem_bytes"]
                    info[key]["threads"] = plan["threads"]
    for key in sorted(info):
        row = info[key]
        log(f"  {key[0]} {key[1]} d={key[2]} warpgroups={key[3]}: "
            f"{row.get('registers')} registers, {row.get('spill_bytes')} "
            f"spill bytes, {row.get('threads')} threads, "
            f"{row.get('smem_bytes')} B dynamic shared; SASS "
            f"{row.get('HGMMA', 0)} HGMMA, {row.get('UTMALDG', 0)} UTMALDG")
        if not row.get("HGMMA") or not row.get("UTMALDG"):
            raise CheckFailed(f"{key} has no HGMMA or no UTMALDG instruction "
                              f"in its SASS")
        if row.get("spill_bytes") != 0:
            raise CheckFailed(f"{key} spills {row.get('spill_bytes')} bytes")
    return info


# ln_*<T, P, VEC, NV> and ln_bwd_reduce<P>: T is x's type, P gamma's
LN_INSTANCE = re.compile(r"(ln_(?:fwd|bwd)_(?:warp|loop)|ln_bwd_reduce)"
                         r"I((?:f|13__nv_bfloat16|S\d*_)+)"
                         r"(?:Li(\d+)ELi(\d+)E)?E")
LN_TYPE = re.compile(r"f|13__nv_bfloat16|S\d*_")
# the instances the main paths run, (kernel, x, gamma, vec, chunks): H = 512
# in 128-bit chunks, fp32 throughout or bf16 x with bf16 gamma (the bf16
# training step)
LN_MAIN_PATH = {("ln_fwd_warp", "float32", "float32", 4, 4),
                ("ln_bwd_warp", "float32", "float32", 4, 4),
                ("ln_bwd_reduce", None, "float32", None, None),
                ("ln_fwd_warp", "bfloat16", "bfloat16", 8, 2),
                ("ln_bwd_warp", "bfloat16", "bfloat16", 8, 2),
                ("ln_bwd_reduce", None, "bfloat16", None, None)}


def _ln_key(mangled: str):
    """(kernel, x dtype, gamma dtype, vec, chunks) of a LayerNorm instance,
    or None for another kernel. A substitution (S_) repeats bf16, the only
    class type among the arguments."""
    k = LN_INSTANCE.search(mangled)
    if k is None:
        return None
    types = ["float32" if t == "f" else "bfloat16"
             for t in LN_TYPE.findall(k.group(2))]
    x = None if k.group(1) == "ln_bwd_reduce" else types[0]
    return (k.group(1), x, types[-1],
            int(k.group(3)) if k.group(3) else None,
            int(k.group(4)) if k.group(4) else None)


def report_layer_norm_build(lib):
    """Registers and spills (ptxas -v) of every LayerNorm instance
    (kernel, x dtype, gamma dtype, values a chunk, chunks a thread). Fails
    if an instance of the main paths spills."""
    info = {}
    current = None
    for line in lib.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = _ln_key(m.group(1))
            continue
        if current is None:
            continue
        row = info.setdefault(current, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            row["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m.group(1))
    if not info:
        raise CheckFailed("the build log holds no ptxas report of the "
                          "LayerNorm kernels")
    for key in sorted(info, key=str):
        log(f"  {key[0]} x={key[1]} gamma={key[2]} vec={key[3]} "
            f"chunks={key[4]}: "
            f"{info[key].get('registers')} registers, "
            f"{info[key].get('spill_bytes')} spill bytes")
    for key in LN_MAIN_PATH:
        if info.get(key, {}).get("spill_bytes") != 0:
            raise CheckFailed(f"{key} spills or is missing: {info.get(key)}")
    return info


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


def rotating(fn, sets: int):
    """A call of ``fn(k)`` for k = 0, 1, ..., sets - 1, 0, 1, ... that keeps
    each result until its slot comes round again: the inputs rotate through
    ``sets`` buffers and the outputs through sets + 1. The ring is filled
    once here, so no call in a timing loop allocates new device memory."""
    ring = [fn(k) for k in range(sets)]
    step = itertools.count()

    def call():
        k = next(step) % sets
        ring[k] = fn(k)
    return call


def rotation(bytes_per_call: float) -> int:
    """Sets of buffers a timing loop rotates through so that one pass over
    them moves 4x the L2: each call then reads its inputs from, and writes
    its outputs to, device memory, as the bytes bound assumes. At most 256:
    a decode tick's (8, 512) then stays in L2, as on the serving path, where
    the op before it has just written its input."""
    return min(256, max(2, math.ceil(4 * L2_BYTES / bytes_per_call)))


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
def launch_floor_ms(lib) -> float:
    """Device time of an empty kernel launched through the C interface, as
    the kernels are: the floor under any of their times."""
    stream = torch.cuda.current_stream().cuda_stream
    ms, _ = time_ms(lambda: lib.bigdl_empty_launch(stream), 50)
    return ms


def check_layer_norm(kernels, card, floor_ms):
    """The forward at every shape the main paths give it: a decode tick
    (8, 512), the longest prefill (700, 512), the full forward (2·512, 512),
    training (16·512, 512) in fp32 and bf16, and the flagship width
    (1024, 256), with fp32 gamma and beta; and the bf16 training step's
    (16·512, 512) and (2·512, 512) with bf16 gamma and beta. The kernel,
    its plain version and ``F.layer_norm`` are timed over rotating inputs
    and outputs 4x the L2 (``rotation``)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((SLOTS, EMBED), f32, f32, 1e-5, 1e-5),
             ((PROMPT_HI, EMBED), f32, f32, 1e-5, 1e-5),
             ((2 * 512, EMBED), f32, f32, 1e-5, 1e-5),
             ((TRAIN_BATCH * TRAIN_LEN, EMBED), f32, f32, 1e-5, 1e-5),
             ((TRAIN_BATCH * TRAIN_LEN, EMBED), bf16, f32, 2e-2, 0.0),
             ((1024, 256), f32, f32, 1e-5, 1e-5),
             ((TRAIN_BATCH * TRAIN_LEN, EMBED), bf16, bf16, 2e-2, 0.0),
             ((2 * TRAIN_LEN, EMBED), bf16, bf16, 2e-2, 0.0)]
    rows = []
    for (n, h), dtype, pdtype, atol, rtol in cases:
        item = torch.finfo(dtype).bits // 8
        sets = rotation(2 * n * h * item)
        xs = torch.randn(sets, n, h, generator=g, device=dev).to(dtype)
        x = xs[0]
        gamma = (1 + 0.1 * torch.randn(h, generator=g, device=dev)).to(pdtype)
        beta = (0.1 * torch.randn(h, generator=g, device=dev)).to(pdtype)
        got = kernels.layer_norm_cuda(x, gamma, beta, 1e-5)
        want = kernels.layer_norm_reference(x, gamma, beta, 1e-5)
        torch.cuda.synchronize()
        err = max_err(got, want)
        ok = within(got, want, atol, rtol)
        k_ms, _ = time_ms(rotating(
            lambda k: kernels.layer_norm_cuda(xs[k], gamma, beta, 1e-5),
            sets), 50)
        p_ms, _ = time_ms(rotating(
            lambda k: kernels.layer_norm_reference(xs[k], gamma, beta, 1e-5),
            sets), 50)
        g_lib, b_lib = gamma.to(dtype), beta.to(dtype)
        l_ms, _ = time_ms(rotating(lambda k: torch.nn.functional.layer_norm(
            xs[k], (h,), g_lib, b_lib, 1e-5), sets), 50)
        ys = torch.empty_like(xs)
        c_ms, _ = time_ms(rotating(lambda k: ys[k].copy_(xs[k]), sets), 50)
        del ys
        p_item = torch.finfo(pdtype).bits // 8
        b_ms, b_by = bound_ms(2 * n * h * item + 2 * h * p_item, 8.0 * n * h,
                              str(dtype).split(".")[-1])
        log(f"  layer_norm ({n}, {h}) {str(dtype)[6:]}, gamma "
            f"{str(pdtype)[6:]}: max|err| {err:.3e} "
            f"(atol {atol}, rtol {rtol}) {'ok' if ok else 'FAIL'}; kernel "
            f"{k_ms:.5f} ms, plain {p_ms:.5f} ms, F.layer_norm {l_ms:.5f} "
            f"ms, bound {b_ms:.5f} ms ({b_by}, {b_ms / k_ms:.0%} of it), "
            f"copy of x {c_ms:.5f} ms, launch floor {floor_ms:.5f} ms; "
            f"{sets} rotating sets [{card}]")
        if not ok:
            raise CheckFailed(f"layer_norm ({n}, {h}) {dtype} disagrees with "
                              f"its plain version: max|err| {err}")
        rows.append(dict(shape=[n, h], dtype=str(dtype)[6:],
                         params=str(pdtype)[6:], err=err, ms=k_ms,
                         plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                         bound_by=b_by, copy_ms=c_ms))
    return rows


def check_layer_norm_bwd(kernels, card):
    """The backward kernel against ``layer_norm_backward`` at the training
    paths' shapes: the 8-step runs' (16·512, 512) in fp32, bf16 with fp32
    gamma and bf16 with bf16 gamma (the bf16 step), and the one-step
    checks' (2·512, 512) in fp32 and in bf16 with bf16 gamma. dx within
    rtol 1e-4 / atol 1e-5 (fp32) or 2e-2 (bf16); dgamma and dbeta, fp32
    sums over all N rows taken in another order than the plain version's,
    within rtol 1e-4 and atol 1e-5·(max|want| + 1), or, rounded to bf16
    gamma's dtype, within rtol 2^-7 (one bf16 ulp), and equal bit for bit
    across two calls. Library yardstick: the backward of ``F.layer_norm``,
    (forward + backward) - forward under autograd. All three are timed over
    rotating inputs and outputs 4x the L2 (``rotation``)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((TRAIN_BATCH * TRAIN_LEN, EMBED), bf16, f32),
             ((TRAIN_BATCH * TRAIN_LEN, EMBED), bf16, bf16),
             ((2 * TRAIN_LEN, EMBED), bf16, bf16),
             ((2 * TRAIN_LEN, EMBED), f32, f32),
             ((TRAIN_BATCH * TRAIN_LEN, EMBED), f32, f32)]
    rows = []
    for (n, h), dtype, pdtype in cases:
        item = torch.finfo(dtype).bits // 8
        p_item = torch.finfo(pdtype).bits // 8
        sets = rotation(3 * n * h * item)
        xs = torch.randn(sets, n, h, generator=g, device=dev).to(dtype)
        dys = torch.randn(sets, n, h, generator=g, device=dev).to(dtype)
        x, dy = xs[0], dys[0]
        gamma = (1 + 0.1 * torch.randn(h, generator=g, device=dev)).to(pdtype)
        got = kernels.layer_norm_bwd_cuda(x, gamma, dy, 1e-5)
        again = kernels.layer_norm_bwd_cuda(x, gamma, dy, 1e-5)
        want = kernels.layer_norm_backward(x, gamma, 1e-5, dy)
        torch.cuda.synchronize()
        errs = [max_err(a, b) for a, b in zip(got, want)]
        dx_tol = (1e-5, 1e-4) if dtype == torch.float32 else (2e-2, 0.0)
        sum_atol = [1e-5 * (float(b.float().abs().max()) + 1)
                    for b in want[1:]]
        sum_rtol = 1e-4 if pdtype == torch.float32 else 2 ** -7
        ok = (within(got[0], want[0], *dx_tol)
              and all(a.dtype == pdtype for a in got[1:])
              and all(within(a, b, t, sum_rtol)
                      for a, b, t in zip(got[1:], want[1:], sum_atol)))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        k_ms, _ = time_ms(rotating(
            lambda k: kernels.layer_norm_bwd_cuda(xs[k], gamma, dys[k], 1e-5),
            sets), 50)
        p_ms, _ = time_ms(rotating(
            lambda k: kernels.layer_norm_backward(xs[k], gamma, 1e-5, dys[k]),
            sets), 20)
        xr = [t.detach().requires_grad_() for t in xs.unbind(0)]
        gr, br = (t.detach().to(dtype).requires_grad_()
                  for t in (gamma, torch.zeros_like(gamma)))
        ln = torch.nn.functional.layer_norm
        fb_ms, _ = time_ms(rotating(lambda k: torch.autograd.grad(
            ln(xr[k], (h,), gr, br, 1e-5), (xr[k], gr, br), dys[k]),
            sets), 50)
        with torch.no_grad():
            f_ms, _ = time_ms(rotating(
                lambda k: ln(xr[k], (h,), gr, br, 1e-5), sets), 50)
        l_ms = fb_ms - f_ms
        name = str(dtype).split(".")[-1]
        b_ms, b_by = bound_ms(3 * n * h * item + 3 * h * p_item,
                              12.0 * n * h, name)
        log(f"  layer_norm bwd ({n}, {h}) {name}, gamma {str(pdtype)[6:]}: "
            f"max|err| dx {errs[0]:.3e} "
            f"dgamma {errs[1]:.3e} dbeta {errs[2]:.3e} (dx atol "
            f"{dx_tol[0]}, rtol {dx_tol[1]}; dgamma, dbeta atol "
            f"{sum_atol[0]:.2e}, {sum_atol[1]:.2e}, rtol {sum_rtol:.2e}) "
            f"{'ok' if ok else 'FAIL'}; two calls bitwise "
            f"{'equal' if bitwise else 'DIFFER'}; kernel {k_ms:.5f} ms, plain "
            f"{p_ms:.5f} ms, F.layer_norm backward {l_ms:.5f} ms, bound "
            f"{b_ms:.5f} ms ({b_by}, {b_ms / k_ms:.0%} of it); {sets} "
            f"rotating sets [{card}]")
        if not ok:
            raise CheckFailed(f"layer_norm bwd ({n}, {h}) {dtype} disagrees "
                              f"with its plain version: max|err| {errs}")
        if not bitwise:
            raise CheckFailed(f"layer_norm bwd ({n}, {h}) {dtype}: two calls "
                              f"differ")
        rows.append(dict(shape=[n, h], dtype=name, params=str(pdtype)[6:],
                         err=max(errs), ms=k_ms, plain_ms=p_ms,
                         library_ms=l_ms, bound_ms=b_ms, bound_by=b_by))
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
    # the main paths' shapes: serving's full forward and the training step
    for shape in ((2, HEADS, 512, 64), (TRAIN_BATCH, HEADS, TRAIN_LEN, 64)):
        cases.append((shape, True, torch.float32, 2e-4, 2e-4))
        cases.append((shape, True, torch.bfloat16, 2e-2, 0.0))
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
        moved = 4 * b * h * t * d * item + b * h * t * 4
        b_ms, b_by = bound_ms(moved, 4.0 * d * pairs,
                              str(dtype).split(".")[-1])
        plan = kernels.forward_launch_plan(b * h, t, d, dtype)
        bounds = f"bound {b_ms:.4f} ms ({b_by})"
        tf32_ms = None
        if dtype == torch.float32:   # the kernel's 3xTF32 work
            tf32_ms = max(moved / HBM_BYTES_PER_S,
                          3 * 4.0 * d * pairs / TF32_FLOPS) * 1e3
            bounds = (f"bounds {b_ms:.4f} ms (FMA, {b_by}), "
                      f"{tf32_ms:.4f} ms (3xTF32)")
        log(f"  flash ({b}, {h}, {t}, {d}) causal={causal} {str(dtype)[6:]}:"
            f" max|err| {err:.3e} (atol {atol}, rtol {rtol}) "
            f"{'ok' if ok else 'FAIL'}; kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, sdpa {l_ms:.4f} ms, {bounds}; "
            f"{plan['warpgroups']} consumer warpgroup(s), "
            f"{plan['smem_bytes']} B shared [{card}]")
        if not ok:
            raise CheckFailed(f"flash ({b},{h},{t},{d}) causal={causal} "
                              f"{dtype} disagrees with its plain version: "
                              f"max|err| {err}")
        rows.append(dict(shape=[b, h, t, d], causal=causal,
                         dtype=str(dtype)[6:], err=err, ms=k_ms,
                         plain_ms=p_ms, library_ms=l_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         bound_3xtf32_ms=tf32_ms, plan=plan))
    return rows


def find_row(rows, shape, dtype, params="float32"):
    """The causal row of ``shape`` and ``dtype`` (LayerNorm rows: with
    gamma in ``params``)."""
    return next(r for r in rows if r["shape"] == list(shape)
                and r["dtype"] == dtype and r.get("causal", True)
                and r.get("params", "float32") == params)


def sdpa_backend(q4, k4, v4, causal) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these
    operands (PyTorch's own dispatch query), or "unknown"."""
    try:
        from torch.nn.attention import SDPBackend
        idx = torch._fused_sdp_choice(q4, k4, v4, None, 0.0, causal)
        return SDPBackend(idx).name
    except Exception as e:  # noqa: BLE001 — a label only
        return f"unknown ({type(e).__name__})"


def check_flash_bwd(kernels, card):
    """dq and dk/dv kernels against the plain backward. Tolerance: fp32
    atol 2e-4·(max|want| + 1), rtol 2e-4 (sums over T keys or queries in
    another order); bf16 2e-2·(max|want| + 1), rtol 2e-2 (a few ulps of the
    bf16 result)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    cases = [((2, HEADS, t, 64), causal, dtype)
             for t in (1024, 1000) for causal in (True, False)
             for dtype in (torch.float32, torch.bfloat16)]
    # the training step's shape, in both dtypes; the fp32 one last
    cases.append(((TRAIN_BATCH, HEADS, TRAIN_LEN, 64), True, torch.bfloat16))
    cases.append(((TRAIN_BATCH, HEADS, TRAIN_LEN, 64), True, torch.float32))
    rows = []
    for (b, h, t, d), causal, dtype in cases:
        q, k, v, do = (torch.randn(b * h, t, d, generator=g, device=dev)
                       .to(dtype) for _ in range(4))
        o, lse = kernels.flash_attention_cuda(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1)
        dq = kernels.flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta,
                                                 causal)
        dk, dv = kernels.flash_attention_bwd_dkv_cuda(q, k, v, do, lse,
                                                      delta, causal)
        want = kernels.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                     causal)
        torch.cuda.synchronize()
        errs, ok = [], True
        tol = 2e-4 if dtype == torch.float32 else 2e-2
        for got, ref in zip((dq, dk, dv), want):
            scale = float(ref.float().abs().max()) + 1.0
            errs.append(max_err(got, ref))
            ok = ok and within(got, ref, tol * scale, tol)
        dq_ms, _ = time_ms(lambda: kernels.flash_attention_bwd_dq_cuda(
            q, k, v, do, lse, delta, causal))
        dkv_ms, _ = time_ms(lambda: kernels.flash_attention_bwd_dkv_cuda(
            q, k, v, do, lse, delta, causal))
        p_ms, _ = time_ms(lambda: kernels.flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal))
        # library yardstick: backward of scaled_dot_product_attention on
        # the same inputs, (forward + backward) - forward
        q4, k4, v4 = (x.view(b, h, t, d).detach().requires_grad_()
                      for x in (q, k, v))
        do4 = do.view(b, h, t, d)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        fb_ms, _ = time_ms(lambda: torch.autograd.grad(
            sdpa(q4, k4, v4, is_causal=causal), (q4, k4, v4), do4))
        with torch.no_grad():
            f_ms, _ = time_ms(lambda: sdpa(q4, k4, v4, is_causal=causal))
        l_ms = fb_ms - f_ms
        backend = sdpa_backend(q4, k4, v4, causal)
        pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
        item = q.element_size()
        read = 4 * b * h * t * d * item + 2 * b * h * t * 4
        name = str(dtype).split(".")[-1]
        dq_moved = read + b * h * t * d * item
        dkv_moved = read + 2 * b * h * t * d * item
        dq_b = bound_ms(dq_moved, 6.0 * d * pairs, name)
        dkv_b = bound_ms(dkv_moved, 8.0 * d * pairs, name)
        tf32 = [None, None]
        bounds = (f"bounds dq {dq_b[0]:.4f}, dkv {dkv_b[0]:.4f} ms "
                  f"({dq_b[1]})")
        if dtype == torch.float32:   # the kernels' 3xTF32 work
            tf32 = [max(moved / HBM_BYTES_PER_S,
                        3 * f * d * pairs / TF32_FLOPS) * 1e3
                    for moved, f in ((dq_moved, 6.0), (dkv_moved, 8.0))]
            bounds = (f"bounds FMA dq {dq_b[0]:.4f}, dkv {dkv_b[0]:.4f} ms; "
                      f"3xTF32 dq {tf32[0]:.4f}, dkv {tf32[1]:.4f} ms")
        plans = [kernels.backward_launch_plan(b * h, t, d, dtype, dkv)
                 for dkv in (False, True)]
        log(f"  flash bwd ({b}, {h}, {t}, {d}) causal={causal} {name}: "
            f"max|err| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
            f"(tol {tol}·(max|want|+1), rtol {tol}) "
            f"{'ok' if ok else 'FAIL'}; dq {dq_ms:.4f} ms, dkv "
            f"{dkv_ms:.4f} ms, {bounds}; plain dq+dk+dv {p_ms:.4f} ms, "
            f"sdpa backward {l_ms:.4f} ms ({backend}); consumer warpgroups "
            f"dq {plans[0]['warpgroups']}, dkv {plans[1]['warpgroups']} "
            f"[{card}]")
        if not ok:
            raise CheckFailed(f"flash bwd ({b},{h},{t},{d}) causal={causal} "
                              f"{dtype} disagrees with its plain version: "
                              f"max|err| {errs}")
        rows.append(dict(shape=[b, h, t, d], causal=causal, dtype=name,
                         err_dq=errs[0], err_dkv=max(errs[1:]), dq_ms=dq_ms,
                         dkv_ms=dkv_ms, plain_ms=p_ms, library_ms=l_ms,
                         library_backend=backend, dq_bound=dq_b,
                         dkv_bound=dkv_b, dq_bound_3xtf32_ms=tf32[0],
                         dkv_bound_3xtf32_ms=tf32[1], plans=plans))
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


def serve_round(engine, prompts):
    """Submit every prompt from N_CLIENTS threads at once; returns the
    results and the wall time until the last one."""
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
    if errors or any(h is None for h in handles):
        raise CheckFailed(f"submit failed: {errors}")
    results = [h.result(timeout=600) for h in handles]
    return results, time.perf_counter() - t0


def serve(lm, ServingEngine):
    """Two rounds of the same requests through one engine: the first
    captures each program at its first use (JAX compiles there), the
    second replays only. Returns the prompts and each round's results,
    wall time and engine stats (cumulative)."""
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(PROMPT_LO, PROMPT_HI + 1, N_REQUESTS)
    prompts = [rng.integers(0, VOCAB, int(n)).astype(np.int32)
               for n in lengths]
    engine = ServingEngine(lm, max_len=MAX_LEN, slots=SLOTS)
    rounds = []
    try:
        for _ in range(2):
            results, wall = serve_round(engine, prompts)
            rounds.append((results, wall, engine.stats()))
    finally:
        engine.shutdown()
    return prompts, rounds


def report_round(name, results, wall, stats, before, card):
    """One round's rates from its results and the engine's counters
    (``before``: the stats at the round's start)."""
    ttft = np.array([r.ttft_s for r in results]) * 1e3
    generated = sum(r.n_generated for r in results)
    ticks = stats["decode_ticks"] - before.get("decode_ticks", 0)
    tick_s = stats["decode_seconds"] - before.get("decode_seconds", 0.0)
    tokens = stats["decode_tokens"] - before.get("decode_tokens", 0)
    prefill_s = stats["prefill_seconds"] - before.get("prefill_seconds", 0.0)
    prefills = stats["prefills"] - before.get("prefills", 0)
    out = {"wall_s": wall, "tokens": generated,
           "decode_tokens_per_s": tokens / tick_s, "ticks": ticks,
           "tick_ms": tick_s / ticks * 1e3,
           "prefill_ms": prefill_s / prefills * 1e3,
           "ttft_p50_ms": float(np.percentile(ttft, 50)),
           "ttft_p99_ms": float(np.percentile(ttft, 99))}
    log(f"  {name}: {len(results)} requests, {generated} tokens in "
        f"{wall:.3f} s ({generated / wall:.1f} tokens/s with prefill); "
        f"decode {out['decode_tokens_per_s']:.1f} tokens/s over {ticks} "
        f"ticks, {out['tick_ms']:.3f} ms a tick (tokens in, the program, "
        f"results out); prefill {out['prefill_ms']:.2f} ms a request; TTFT "
        f"p50 {out['ttft_p50_ms']:.1f} ms, p99 {out['ttft_p99_ms']:.1f} ms "
        f"[{card}]")
    return out


def decode_step_ms(lm, install_decode_cache, card):
    """Device and host time of one cached decode step of the model over
    the full slot grid, the work of one engine tick without its host
    transfers, run eagerly."""
    state = install_decode_cache(lm, SLOTS, MAX_LEN)
    tok = torch.zeros((SLOTS, 1), dtype=torch.long, device="cuda")
    with torch.no_grad():
        dev_ms, host_ms = time_ms(lambda: lm.run(tok, state), reps=2)
    log(f"  decode step ({SLOTS} slots, cache {MAX_LEN}), eager: device "
        f"{dev_ms:.3f} ms, host enqueue {host_ms:.3f} ms; device busy "
        f"{dev_ms / host_ms:.1%} of the host's time [{card}]")
    return {"device_ms": dev_ms, "host_ms": host_ms}


def copy_tree(tree):
    return {k: copy_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def replayed_decode_step(lm, kernels, install_decode_cache, Program, card):
    """The same step as a captured program (``utils/programs.py``): its
    log-probs against the eager step on a copy of the same cache (a
    64-token prefix in every row, then two steps), the LayerNorm launches
    one replay counts against one eager step's, and the replay's device
    and host time. Fails unless the log-probs agree within 1e-5 and the
    counts are equal."""
    rng = np.random.default_rng(SEED + 6)
    prefix = torch.from_numpy(rng.integers(0, VOCAB, (SLOTS, 64))).cuda()
    tok = torch.from_numpy(rng.integers(0, VOCAB, (SLOTS, 1))).cuda()
    with torch.no_grad():
        state = install_decode_cache(lm, SLOTS, MAX_LEN)
        lm.run(prefix, state)
        ref_state = copy_tree(state)
        prog = Program(("decode_check", SLOTS, MAX_LEN),
                       lambda t: lm.run(t, state)[0], (tok.clone(),), "cuda")
        prog()                                # warm-up, then capture
        lm.run(tok, ref_state)
        kernels.reset_launch_counts()
        got = prog().clone()                  # the first replay
        replay_counts = kernels.launch_counts()
        kernels.reset_launch_counts()
        want = lm.run(tok, ref_state)[0]
        eager_counts = kernels.launch_counts()
        torch.cuda.synchronize()
        err = max_err(got, want)
        bitwise = bool(torch.equal(got, want))
        dev_ms, host_ms = time_ms(prog, reps=2)
    log(f"  decode step, replayed: device {dev_ms:.3f} ms, host "
        f"{host_ms:.3f} ms a replay (device-bound when the host is the "
        f"shorter); log-probs against the eager step max|err| "
        f"{err:.3e} (atol 1e-5), bitwise {bitwise}; launches a step "
        f"replayed {replay_counts['layer_norm_fwd']} LN forward, eager "
        f"{eager_counts['layer_norm_fwd']} [{card}]")
    if err > 1e-5 or replay_counts != eager_counts:
        raise CheckFailed(f"the replayed decode step departs from the eager "
                          f"one: max|err| {err}, launches {replay_counts} "
                          f"against {eager_counts}")
    return {"device_ms": dev_ms, "host_ms": host_ms, "max_abs_err": err,
            "bitwise": bitwise, "launches": replay_counts}


def check_programs(stats, prompts, buckets, pick_bucket, launches,
                   fwd_counts):
    """The engine's program ledger: one program per prefill bucket used,
    one decode, one assign, within ``len(buckets) + 2``; every model call
    of the run (a prefill or a tick, eager warm-up or replay) launched the
    LayerNorm forward 13 times, as an eager run does."""
    used = {pick_bucket(len(p), buckets) for p in prompts}
    n, bound = stats["compiled_programs"], stats["program_grid_bound"]
    calls = stats["prefills"] + stats["decode_ticks"]
    ln = launches["layer_norm_fwd"] - fwd_counts["layer_norm_fwd"]
    log(f"  programs: {n} compiled (bound {bound}; {len(used)} prefill "
        f"buckets used + decode + assign); LN forward launches {ln} over "
        f"{calls} model calls ({2 * LAYERS + 1} each eagerly: "
        f"{(2 * LAYERS + 1) * calls})")
    if n > bound or n != len(used) + 2:
        raise CheckFailed(f"the engine compiled {n} programs for "
                          f"{len(used)} buckets (bound {bound})")
    if ln != (2 * LAYERS + 1) * calls:
        raise CheckFailed(f"serving launched the LayerNorm forward {ln} "
                          f"times over {calls} model calls")
    return {"compiled_programs": n, "program_grid_bound": bound,
            "buckets_used": len(used)}


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


# ---------------------------------------------------------------- phase 6
def build_train_lm(TransformerLM, attention_impl, device, remat=False):
    return TransformerLM(VOCAB, EMBED, HEADS, LAYERS, TRAIN_LEN,
                         attention_impl=attention_impl, remat=remat,
                         generator=torch.Generator().manual_seed(SEED + 4),
                         device=device)


def check_train_step(TransformerLM, lm_criterion):
    """Loss and every parameter's gradient of one (2, 512) step on the card
    (all four kernels) against the same weights on the CPU with the plain
    LayerNorm and ``attention_impl="full"``. Tolerances: loss relative 1e-4;
    per parameter ``|g - g_ref| / |g_ref|`` (Frobenius norms) <= 1e-3."""
    rng = np.random.default_rng(SEED + 4)
    ids = torch.from_numpy(rng.integers(0, VOCAB, (2, TRAIN_LEN + 1)))
    x, y = ids[:, :-1], ids[:, 1:]
    crit = lm_criterion()
    runs = []
    for device, impl in ((DEVICE, "auto"), ("cpu", "full")):
        lm = build_train_lm(TransformerLM, impl, device)
        names, params = zip(*lm.named_parameters())
        loss = crit(lm(x.to(device)), y.to(device))
        grads = torch.autograd.grad(loss, params)
        runs.append((loss.item(), {n: g.detach().cpu()
                                   for n, g in zip(names, grads)}))
        del lm, loss, grads
    (loss, grads), (loss_ref, grads_ref) = runs
    rel_loss = abs(loss - loss_ref) / abs(loss_ref)
    rel = {n: float((grads[n] - g).norm() / g.norm().clamp(min=1e-30))
           for n, g in grads_ref.items()}
    worst = max(rel, key=rel.get)
    log(f"  one (2, {TRAIN_LEN}) step: loss {loss:.6f} vs CPU plain "
        f"{loss_ref:.6f} (relative {rel_loss:.2e}, limit 1e-4); gradients "
        f"of {len(rel)} parameters, worst relative error {rel[worst]:.2e} "
        f"({worst}, limit 1e-3)")
    if rel_loss > 1e-4 or rel[worst] > 1e-3:
        raise CheckFailed(f"training step disagrees with the CPU plain "
                          f"model: loss {rel_loss:.3e}, {worst} "
                          f"{rel[worst]:.3e}")
    return loss_ref, grads_ref


def rel_errors(grads, grads_ref) -> dict:
    return {n: float((grads[n] - g).norm() / g.norm().clamp(min=1e-30))
            for n, g in grads_ref.items()}


def check_train_step_bf16(TransformerLM, lm_criterion, fp32_ref):
    """The bf16 mixed-precision step (``Engine.init(compute_dtype=
    torch.bfloat16)``): the loss and every master gradient of one (2, 512)
    step on the card (all five kernels in bf16, bf16 gamma and beta)
    against the port's plain bf16 step on the CPU with the same weights
    (the same casts; plain LayerNorm, ``attention_impl="full"``), both
    through ``LocalOptimizer``'s loss-and-gradient path. Tolerances, sized
    for bf16 (8 significant bits, 2^-9 relative rounding, compounded over
    6 blocks and a 32000-way head): loss relative 1e-2; per parameter
    ``|g - g_ref| / |g_ref|`` (Frobenius) <= 5e-2. The CPU bf16 step's own
    distance from the fp32 step is printed beside them (not a check)."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import LocalOptimizer

    rng = np.random.default_rng(SEED + 4)
    ids = torch.from_numpy(rng.integers(0, VOCAB, (2, TRAIN_LEN + 1)))
    x, y = ids[:, :-1], ids[:, 1:]
    runs = []
    for device, impl in ((DEVICE, "auto"), ("cpu", "full")):
        lm = build_train_lm(TransformerLM, impl, device)
        opt = LocalOptimizer(lm, DataSet.array([]), lm_criterion(),
                             device=device)
        names, params = zip(*lm.named_parameters())
        loss, grads = opt._loss_and_grads(list(params), x.to(device),
                                          y.to(device))
        if any(g.dtype != torch.float32 for g in grads):
            raise CheckFailed("the bf16 step's master gradients are not fp32")
        runs.append((loss.item(), {n: g.detach().cpu()
                                   for n, g in zip(names, grads)}))
        del lm, opt, loss, grads
    (loss, grads), (loss_ref, grads_ref) = runs
    rel_loss = abs(loss - loss_ref) / abs(loss_ref)
    rel = rel_errors(grads, grads_ref)
    worst = max(rel, key=rel.get)
    policy = rel_errors(grads_ref, fp32_ref[1])
    p_worst = max(policy, key=policy.get)
    log(f"  one (2, {TRAIN_LEN}) bf16 step: loss {loss:.6f} vs CPU plain "
        f"bf16 {loss_ref:.6f} (relative {rel_loss:.2e}, limit 1e-2); "
        f"gradients of {len(rel)} parameters, worst relative error "
        f"{rel[worst]:.2e} ({worst}, limit 5e-2); CPU bf16 against CPU "
        f"fp32: loss {abs(loss_ref - fp32_ref[0]) / abs(fp32_ref[0]):.2e}, "
        f"worst gradient {policy[p_worst]:.2e} ({p_worst})")
    if rel_loss > 1e-2 or rel[worst] > 5e-2:
        raise CheckFailed(f"bf16 training step disagrees with the CPU plain "
                          f"bf16 step: loss {rel_loss:.3e}, {worst} "
                          f"{rel[worst]:.3e}")
    return {"rel_loss": rel_loss, "worst_grad_rel": rel[worst]}


# kernel kinds of a profiled step, by words in the kernel's name (first
# match wins): the port's five kernels, the library's matrix products, the
# rest (elementwise and reduction glue, softmax, copies)
KERNEL_KINDS = (("ported kernels", ("ln_fwd", "ln_bwd", "flash_")),
                ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")))


def profile_step(opt, batch, card):
    """Device time of one more training step by kernel name, from
    ``torch.profiler`` (reported only: the measurement, not a check)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inp, target = (torch.as_tensor(a).to(DEVICE)
                   for a in (batch.input, batch.target))
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            opt.train_step(inp, target)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]

        def dev_ms(e):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            return us / 1e3

        busy = sum(dev_ms(e) for e in events)
        calls = {name: sum(e.count for e in prof.key_averages()
                           if e.key == name)
                 for name in ("cudaLaunchKernel", "cudaGraphLaunch")}
        top = sorted(events, key=dev_ms, reverse=True)[:15]
        host = sorted((e for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU),
                      key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    except Exception as e:  # noqa: BLE001 — an observation, not a check
        log(f"  profiler: no device times ({type(e).__name__}: {e})")
        return None
    shares = {}
    for e in events:
        name = e.key.lower()
        kind = next((k for k, words in KERNEL_KINDS if any(
            w in name for w in words)), "other")
        shares[kind] = shares.get(kind, 0.0) + dev_ms(e)
    log(f"  profiled step: {wall_ms:.2f} ms wall, device busy {busy:.2f} ms "
        f"({busy / wall_ms:.1%}) over {len(events)} kernel names; by kind "
        f"{ {k: round(v, 3) for k, v in shares.items()} } ms; host calls "
        f"{calls} [{card}]")
    for e in top:
        log(f"    {dev_ms(e):9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    log("  host ops by self time (under the profiler, which adds to each):")
    for e in host:
        log(f"    {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:80]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "by_kind_ms": shares,
            "host_calls": calls,
            "top": [[e.key[:90], dev_ms(e), e.count] for e in top]}


def eager_reference(TransformerLM, lm_criterion, kernels, method, steps,
                    remat):
    """The same steps run eagerly on the card: a fresh model from the same
    seed, the trainer's step function called directly on each recorded
    batch with the host's step numbers, as the program would replay it.
    Returns the losses, the parameters and the launches of those steps."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import LocalOptimizer
    from bigdl_tpu_torch.optim.optim_method import hyper_tensor

    lm = build_train_lm(TransformerLM, "auto", DEVICE, remat=remat)
    opt = LocalOptimizer(lm, DataSet.array([]), lm_criterion(),
                         device=DEVICE).set_optim_method(method)
    named, scales, mask = opt._prepare_step()
    step = opt._make_step_fn(named, scales, mask)
    kernels.reset_launch_counts()
    losses = [float(step(inp, target, hyper_tensor(
        opt._method.hyper(k, opt._ostate), list(named.values()))))
        for k, (inp, target) in enumerate(steps)]
    torch.cuda.synchronize()
    return losses, {n: p.detach() for n, p in named.items()}, \
        kernels.launch_counts()


def train(TransformerLM, lm_criterion, kernels, card, bf16=False,
          flat=False, remat=False, fuse=1, profile=True, compare=False):
    """TRAIN_ITERS LocalOptimizer steps at batch 16 x 512 on synthetic_ptb
    windows, with ``set_fuse_steps(fuse)``: the step program is captured at
    the first step and replayed after it. In fp32 or (``bf16``) under the
    bf16 mixed-precision policy, with the per-leaf update or (``flat``)
    the flat update, and (``remat``) with every block under ``Remat``.
    Returns the launch counts of the run (in all, and by dtype) and its
    step time: the median between consecutive step ends after the first
    (fuse 1) or the wall of the second window, all replays, over its
    steps. With ``compare`` the same steps run eagerly
    (:func:`eager_reference`) and the replayed losses, parameters and
    launches are held against them; with ``profile`` one more replayed
    step's device time by kernel."""
    from bigdl_tpu_torch.dataset import (
        DataSet, Sample, SampleToMiniBatch, ptb_windows, synthetic_ptb,
    )
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    def method():
        return SGD(learningrate=0.01, momentum=0.9, dampening=0.0)

    RandomGenerator.set_seed(SEED)
    ids = synthetic_ptb(TRAIN_BATCH * TRAIN_STEPS * TRAIN_LEN + 1,
                        vocab_size=VOCAB)
    xs, ys = ptb_windows(ids, TRAIN_LEN)
    data = (DataSet.array(Sample(x, y) for x, y in zip(xs, ys))
            >> SampleToMiniBatch(TRAIN_BATCH))
    lm = build_train_lm(TransformerLM, "auto", DEVICE, remat=remat)
    opt = (LocalOptimizer(lm, data, lm_criterion(), device=DEVICE)
           .set_optim_method(method())
           .set_end_when(Trigger.max_iteration(TRAIN_ITERS))
           .set_flat_update(flat).set_fuse_steps(fuse))
    losses, marks, windows, seen = [], [], [], []
    run_steps = opt._run_steps

    def recorded(steps):
        out = run_steps(steps)
        marks.append(time.perf_counter())
        losses.extend(out)
        windows.append(len(steps))
        if compare:
            seen.extend((a.clone(), b.clone()) for a, b in steps)
        return out

    opt._run_steps = recorded
    # the plain LayerNorm backward must not run on the card
    from bigdl_tpu_torch.kernels import layernorm as ln_module
    plain_bwd, plain_calls = ln_module.layer_norm_backward, []

    def counted_plain_bwd(*args):
        plain_calls.append(1)
        return plain_bwd(*args)

    ln_module.layer_norm_backward = counted_plain_bwd
    torch.cuda.synchronize()
    try:
        # the training path: counted from here ...
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()     # ... to here
        by_dtype = kernels.launch_counts_by_dtype()
        if compare:
            ref = eager_reference(TransformerLM, lm_criterion, kernels,
                                  method(), seen, remat)
    finally:
        opt._run_steps = run_steps
        ln_module.layer_norm_backward = plain_bwd
    what = ("bf16 steps" if bf16 else "steps") + \
        (" with the flat update" if flat else "") + \
        (" with remat" if remat else "") + f", fuse {fuse}"
    if len(losses) != TRAIN_ITERS or not all(np.isfinite(losses)):
        raise CheckFailed(f"training gave losses {losses}")
    if fuse == 1:
        step_ms = float(statistics.median(np.diff(marks))) * 1e3
    else:
        if windows[:2] != [fuse, fuse]:
            raise CheckFailed(f"windows {windows}, not two of {fuse} first")
        step_ms = (marks[1] - marks[0]) / fuse * 1e3
    tokens = TRAIN_BATCH * TRAIN_LEN
    log(f"  {TRAIN_ITERS} {what} at ({TRAIN_BATCH}, {TRAIN_LEN}): windows "
        f"{windows}; losses {[round(v, 4) for v in losses]}; first window "
        f"(warm-up and capture) {(marks[0] - t0) * 1e3:.1f} ms, step "
        f"{step_ms:.2f} ms, {tokens / step_ms * 1e3:.0f} tokens/s; "
        f"{wall:.2f} s in all [{card}]")
    log(f"  launches on the training path ({what}): {by_dtype} "
        f"({ {k: v / TRAIN_ITERS for k, v in counts.items()} } a step)")
    for name, n in counts.items():
        if n == 0:
            raise CheckFailed(f"the training path never launched {name}")
    # LN: two a block, one final; under remat a block's forward kernels
    # run again when its backward recomputes it
    runs = 2 if remat else 1
    ln_per_run = (2 * LAYERS + 1) * TRAIN_ITERS
    ln_fwd = (2 * LAYERS * runs + 1) * TRAIN_ITERS
    flash_fwd = LAYERS * runs * TRAIN_ITERS
    if (counts["layer_norm_fwd"] != ln_fwd
            or counts["layer_norm_bwd"] != ln_per_run
            or counts["flash_attention_fwd"] != flash_fwd or plain_calls):
        raise CheckFailed(f"the training path ({what}) launched "
                          f"layer_norm_fwd {counts['layer_norm_fwd']}, "
                          f"layer_norm_bwd {counts['layer_norm_bwd']} and "
                          f"flash_attention_fwd "
                          f"{counts['flash_attention_fwd']} times (expected "
                          f"{ln_fwd}, {ln_per_run} and {flash_fwd}) and ran "
                          f"the plain backward {len(plain_calls)} times")
    # every launch in the run's dtypes: bf16 operands (and, for LayerNorm,
    # bf16 gamma and beta) under the bf16 policy, fp32 otherwise
    want = "bfloat16" if bf16 else "float32"
    for name, split in by_dtype.items():
        key = f"{want}/{want}" if name.startswith("layer_norm") else want
        if split != {key: counts[name]}:
            raise CheckFailed(f"the training path ({what}) launched {name} "
                              f"as {split}, not all as {key}")
    check = compare_eager(what, losses, lm, counts, ref, bf16) \
        if compare else None
    prof = (profile_step(opt, next(iter(data.data(train=True))), card)
            if profile else None)
    return counts, dict(losses=losses, step_ms=step_ms,
                        tokens_per_s=tokens / step_ms * 1e3,
                        first_window_ms=(marks[0] - t0) * 1e3, profile=prof,
                        by_dtype=by_dtype, windows=windows, eager=check)


def compare_eager(what, losses, lm, counts, ref, bf16):
    """The replayed run against the same steps run eagerly: every loss
    within the one-step check's loss tolerance (relative 1e-4, bf16 1e-2),
    every parameter within its gradient tolerance (relative Frobenius 1e-3,
    bf16 5e-2), and the same launches of every kernel. Reports the largest
    differences and whether everything is bitwise equal."""
    ref_losses, ref_params, ref_counts = ref
    loss_tol, param_tol = (1e-2, 5e-2) if bf16 else (1e-4, 1e-3)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    params = dict(lm.named_parameters())
    rel = {n: float((params[n].detach() - p).norm()
                    / p.norm().clamp(min=1e-30))
           for n, p in ref_params.items()}
    worst = max(rel, key=rel.get)
    abs_err = max(max_err(params[n].detach(), p)
                  for n, p in ref_params.items())
    bitwise = losses == ref_losses and all(
        torch.equal(params[n].detach(), p) for n, p in ref_params.items())
    log(f"  {what}, replayed against eager on the card: losses relative "
        f"{loss_rel:.2e} (limit {loss_tol}), parameters worst relative "
        f"{rel[worst]:.2e} ({worst}, limit {param_tol}), max|err| "
        f"{abs_err:.3e}; bitwise {bitwise}; launches a step "
        f"{ {k: v / TRAIN_ITERS for k, v in counts.items()} } replayed, "
        f"{ {k: v / TRAIN_ITERS for k, v in ref_counts.items()} } eager")
    if loss_rel > loss_tol or rel[worst] > param_tol:
        raise CheckFailed(f"{what}: the replayed steps depart from the eager "
                          f"ones: losses {loss_rel:.3e}, {worst} "
                          f"{rel[worst]:.3e}")
    if counts != ref_counts:
        raise CheckFailed(f"{what}: replayed launches {counts} against "
                          f"eager {ref_counts}")
    return {"loss_rel": loss_rel, "param_rel": rel[worst],
            "param_max_abs_err": abs_err, "bitwise": bitwise,
            "launches_per_step": {k: v / TRAIN_ITERS
                                  for k, v in counts.items()}}


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
        from bigdl_tpu_torch.models.transformerlm import (
            TransformerLM, lm_criterion,
        )
        from bigdl_tpu_torch.nn import greedy_generate, install_decode_cache
        from bigdl_tpu_torch.serving import ServingEngine, pick_bucket
        from bigdl_tpu_torch.utils.engine import Engine
        from bigdl_tpu_torch.utils.programs import Program
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
    build = report_flash_build(lib, kernels, _cuda.find_nvcc())
    ln_build = report_layer_norm_build(lib)

    log("phase 3: kernels against their plain versions")
    floor_ms = launch_floor_ms(lib.lib)
    log(f"  launch floor: an empty kernel through the C interface "
        f"{floor_ms:.5f} ms [{card}]")
    ln_rows = check_layer_norm(kernels, card, floor_ms)
    lnb_rows = check_layer_norm_bwd(kernels, card)
    fa_rows = check_flash(kernels, card)
    bwd_rows = check_flash_bwd(kernels, card)

    log("phase 4: full-sequence forward, full width")
    lm = build_lm(TransformerLM, "auto", "cuda")
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"  TransformerLM({VOCAB}, {EMBED}, {HEADS}, {LAYERS}, {MAX_LEN}): "
        f"{n_params} parameters")
    # the serving path is phases 4 and 5: counted from here ...
    kernels.reset_launch_counts()
    full_forward(lm, TransformerLM)
    fwd_counts = kernels.launch_counts()

    log("phase 5: serving")
    prompts, rounds = serve(lm, ServingEngine)
    launches = kernels.launch_counts()     # ... to here
    (results, wall, stats0), (results2, wall2, stats) = rounds
    cold = report_round("first round (captures)", results, wall, stats0, {},
                        card)
    warm = report_round("second round (replays only)", results2, wall2,
                        stats, stats0, card)
    log(f"  engine stats: {stats}")
    log(f"  launches: full forward {fwd_counts}, serving "
        f"{ {k: launches[k] - fwd_counts[k] for k in launches} }")
    for name in ("layer_norm_fwd", "flash_attention_fwd"):
        if launches[name] == 0:
            raise CheckFailed(f"the serving path never launched {name}")
    check_served_tokens(lm, greedy_generate, prompts, results)
    if any(not np.array_equal(a.tokens, b.tokens)
           for a, b in zip(results, results2)):
        raise CheckFailed("the second round served other tokens")
    log("  served tokens match solo greedy_generate, in both rounds")
    programs = check_programs(stats, prompts, stats["buckets"], pick_bucket,
                              launches, fwd_counts)
    if stats0["compiled_programs"] != stats["compiled_programs"]:
        raise CheckFailed("the second round captured new programs")
    eager_step = decode_step_ms(lm, install_decode_cache, card)
    replayed_step = replayed_decode_step(lm, kernels, install_decode_cache,
                                         Program, card)

    del lm
    torch.cuda.empty_cache()

    log("phase 6: training")
    fp32_ref = check_train_step(TransformerLM, lm_criterion)
    train_counts, run = train(TransformerLM, lm_criterion, kernels, card,
                              compare=True)
    _, run_fused = train(TransformerLM, lm_criterion, kernels, card,
                         fuse=FUSE, compare=True, profile=False)
    train_shape, serve_shape = (TRAIN_BATCH, HEADS, TRAIN_LEN, 64), \
        (2, HEADS, 512, 64)
    ln_shape = (TRAIN_BATCH * TRAIN_LEN, EMBED)

    def kernel_rows(dtype):
        """The phase-3 rows of the five kernels at the training step's
        shapes (LayerNorm with gamma in the step's dtype)."""
        return (find_row(ln_rows, ln_shape, dtype, dtype),
                find_row(lnb_rows, ln_shape, dtype, dtype),
                find_row(fa_rows, train_shape, dtype),
                find_row(bwd_rows, train_shape, dtype))

    def kernel_ms_a_step(counts, rows):
        per_step = {k: v / TRAIN_ITERS for k, v in counts.items()}
        ln_r, lnb_r, fa_r, bwd_r = rows
        return (per_step["layer_norm_fwd"] * ln_r["ms"]
                + per_step["layer_norm_bwd"] * lnb_r["ms"]
                + per_step["flash_attention_fwd"] * fa_r["ms"]
                + per_step["flash_attention_bwd_dq"] * bwd_r["dq_ms"]
                + per_step["flash_attention_bwd_dkv"] * bwd_r["dkv_ms"])

    ln_t, lnb, fa_t, bwd = kernel_rows("float32")
    kernel_ms = kernel_ms_a_step(train_counts, (ln_t, lnb, fa_t, bwd))
    log(f"  the five kernels: {kernel_ms:.3f} ms a step at their phase-3 "
        f"times, {kernel_ms / run['step_ms']:.1%} of the median step "
        f"[{card}]")

    # the same training under the bf16 mixed-precision policy
    Engine.init(compute_dtype=torch.bfloat16)
    try:
        bf16_check = check_train_step_bf16(TransformerLM, lm_criterion,
                                           fp32_ref)
        del fp32_ref
        counts16, run16 = train(TransformerLM, lm_criterion, kernels, card,
                                bf16=True, compare=True)
        _, run16_fused = train(TransformerLM, lm_criterion, kernels, card,
                               bf16=True, fuse=FUSE, compare=True,
                               profile=False)
        # the same with the flat update (off by default, as in JAX) and with
        # remat: their step times and launches, beside the plain run's
        _, run16_flat = train(TransformerLM, lm_criterion, kernels, card,
                              bf16=True, flat=True, profile=False)
        remat16, run16_remat = train(TransformerLM, lm_criterion, kernels,
                                     card, bf16=True, remat=True,
                                     profile=False)
    finally:
        Engine.reset()
    # remat re-runs the same forward: the same losses within 1e-4 relative
    remat_rel = max(abs(a - b) / abs(b) for a, b in
                    zip(run16_remat["losses"], run16["losses"]))
    if remat_rel > 1e-4:
        raise CheckFailed(f"bf16 training with remat departs from the run "
                          f"without it: losses {remat_rel:.3e} relative")
    rows16 = kernel_rows("bfloat16")
    kernel_ms16 = kernel_ms_a_step(counts16, rows16)
    log(f"  set_fuse_steps({FUSE}): step {run_fused['step_ms']:.2f} ms fp32 "
        f"(fuse 1: {run['step_ms']:.2f}), {run16_fused['step_ms']:.2f} ms "
        f"bf16 (fuse 1: {run16['step_ms']:.2f}) [{card}]")
    log(f"  bf16 against fp32: median step {run16['step_ms']:.2f} ms against "
        f"{run['step_ms']:.2f} ms ({run['step_ms'] / run16['step_ms']:.2f}x), "
        f"{run16['tokens_per_s']:.0f} against {run['tokens_per_s']:.0f} "
        f"tokens/s; the five kernels in bf16 {kernel_ms16:.3f} ms a step at "
        f"their phase-3 times, {kernel_ms16 / run16['step_ms']:.1%} of the "
        f"bf16 step; with the flat update {run16_flat['step_ms']:.2f} ms, "
        f"with remat {run16_remat['step_ms']:.2f} ms (losses within "
        f"{remat_rel:.1e} relative of the run without) [{card}]")

    # each kernel's row: its own slice's path (serving for the forward
    # kernels, training for the backward ones) and shapes; both paths'
    # launches under "paths"
    ln = find_row(ln_rows, (2 * 512, EMBED), "float32")
    ln_dec = find_row(ln_rows, (SLOTS, EMBED), "float32")
    fa = find_row(fa_rows, serve_shape, "float32")

    def design_of(kernel, plan, summary):   # the fp32 d = 64 instance's
        key = (kernel, "float32", 64, plan["warpgroups"])
        return dict(plan, **{k: build[key].get(k) for k in (
            "registers", "spill_bytes", "HGMMA", "UTMALDG")},
            summary=summary)

    design = design_of("flash_fwd_kernel", fa["plan"], (
        "wgmma (bf16 on the tensor cores; fp32 as 3xTF32) fed by a 2-stage "
        "TMA ring of K/V tiles from one producer warp; 64 query rows a "
        "consumer warpgroup"))
    bf16 = {name: {k: find_row(fa_rows, shape, "bfloat16")[k] for k in (
        "ms", "bound_ms", "library_ms", "err")}
        for name, shape in (("serving", serve_shape),
                            ("training", train_shape))}
    # the backward rows: the training shape in fp32, with both bounds, and
    # bf16 at (2·8, 1024, 64) causal and at the training shape
    bwd_summary = ("all products on wgmma (bf16 on the tensor cores, P and "
                   "dS rounded to bf16 and fed from registers; fp32 as "
                   "3xTF32 with K-major and transposed working sets) fed "
                   "by a 2-stage TMA ring of the streamed tiles from one "
                   "producer warp; 64 resident rows a consumer warpgroup; "
                   "one CTA owns each output tile: no atomics")

    def bwd_bf16_row(shape):
        r = find_row(bwd_rows, shape, "bfloat16")
        return {"shape": list(shape), "dq_ms": r["dq_ms"],
                "dkv_ms": r["dkv_ms"], "dq_bound_ms": r["dq_bound"][0],
                "dkv_bound_ms": r["dkv_bound"][0], "bound_by":
                r["dq_bound"][1], "max_abs_err_dq": r["err_dq"],
                "max_abs_err_dkv": r["err_dkv"],
                "library_ms": r["library_ms"]}

    bwd_bf16 = {"long": bwd_bf16_row((2, HEADS, 1024, 64)),
                "training": bwd_bf16_row(train_shape)}
    paths = {k: {"serving": launches[k], "training": train_counts[k],
                 "training_bf16": counts16[k]} for k in launches}

    def bf16_training(name):
        """The kernel's bf16 training instance: its phase-3 row at the
        training shape and its launches in the 8 bf16 steps."""
        ln_r, lnb_r, fa_r, bwd_r = rows16
        row = {"layer_norm_fwd": ln_r, "layer_norm_bwd": lnb_r,
               "flash_attention_fwd": fa_r}.get(name, bwd_r)
        out = {"shape": row["shape"], "dtype": row["dtype"],
               "launches": counts16[name],
               "launches_by_dtype": run16["by_dtype"][name],
               "plain_ms": row["plain_ms"], "library_ms": row["library_ms"]}
        if name.startswith("layer_norm"):
            out.update(params=row["params"], max_abs_err=row["err"],
                       ms=row["ms"], bound_ms=row["bound_ms"],
                       bound_by=row["bound_by"])
        elif name == "flash_attention_fwd":
            out.update(max_abs_err=row["err"], ms=row["ms"],
                       bound_ms=row["bound_ms"], bound_by=row["bound_by"])
        else:
            part = "dq" if name.endswith("dq") else "dkv"
            out.update(max_abs_err=row[f"err_{part}"], ms=row[f"{part}_ms"],
                       bound_ms=row[f"{part}_bound"][0],
                       bound_by=row[f"{part}_bound"][1],
                       plain_and_library_cover="dq+dk+dv")
        return out

    src = "bigdl_tpu_torch/kernels/csrc/"
    table = {"kernels": [
        {"name": "layer_norm_fwd", "route": "cuda",
         "source": src + "layernorm.cu",
         "replaces": "bigdl_tpu/kernels/layernorm.py:31",
         "launches": launches["layer_norm_fwd"], "shape": ln["shape"],
         "dtype": ln["dtype"], "max_abs_err": ln["err"], "ms": ln["ms"],
         "plain_ms": ln["plain_ms"], "bound_ms": ln["bound_ms"],
         "bound_by": ln["bound_by"], "library_ms": ln["library_ms"],
         "paths": paths["layer_norm_fwd"],
         "training_shape": ln_t["shape"], "training_ms": ln_t["ms"],
         "training_bound_ms": ln_t["bound_ms"],
         "training_library_ms": ln_t["library_ms"],
         "training_copy_ms": ln_t["copy_ms"],
         "decode_shape": ln_dec["shape"], "decode_ms": ln_dec["ms"],
         "decode_library_ms": ln_dec["library_ms"],
         "launch_floor_ms": floor_ms,
         "design": "one warp per row (4 rows a CTA), the row in registers, "
                   "128-bit loads and stores, statistics by warp shuffles",
         "registers": ln_build[("ln_fwd_warp", "float32", "float32", 4,
                                 4)].get("registers"),
         "bf16_training": dict(bf16_training("layer_norm_fwd"), registers=(
             ln_build[("ln_fwd_warp", "bfloat16", "bfloat16", 8, 2)]
             .get("registers")))},
        {"name": "layer_norm_bwd", "route": "cuda",
         "source": src + "layernorm.cu",
         "replaces": "bigdl_tpu/kernels/layernorm.py:99 (_fln_bwd, plain "
                     "jnp)",
         "launches": train_counts["layer_norm_bwd"], "shape": lnb["shape"],
         "dtype": lnb["dtype"], "max_abs_err": lnb["err"], "ms": lnb["ms"],
         "plain_ms": lnb["plain_ms"], "bound_ms": lnb["bound_ms"],
         "bound_by": lnb["bound_by"], "library_ms": lnb["library_ms"],
         "paths": paths["layer_norm_bwd"],
         "bf16": {k: find_row(lnb_rows, lnb["shape"], "bfloat16")[k]
                  for k in ("ms", "bound_ms", "library_ms", "err")},
         "bf16_training": dict(bf16_training("layer_norm_bwd"), registers=(
             ln_build[("ln_bwd_warp", "bfloat16", "bfloat16", 8, 2)]
             .get("registers"))),
         "design": "one warp per row (8 warps a CTA, ~2 CTAs an SM striding "
                   "over rows), the row in registers; dgamma/dbeta partials "
                   "per CTA summed by a second kernel in a fixed order, no "
                   "float atomics",
         "registers": ln_build[("ln_bwd_warp", "float32", "float32", 4,
                                 4)].get("registers")},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": src + "flash_attention.cu",
         "replaces": "bigdl_tpu/kernels/flash_attention.py:54",
         "launches": launches["flash_attention_fwd"], "shape": fa["shape"],
         "dtype": fa["dtype"], "max_abs_err": fa["err"], "ms": fa["ms"],
         "plain_ms": fa["plain_ms"], "bound_ms": fa["bound_ms"],
         "bound_by": fa["bound_by"], "library_ms": fa["library_ms"],
         "paths": paths["flash_attention_fwd"],
         "training_shape": fa_t["shape"], "training_ms": fa_t["ms"],
         "bound_3xtf32_ms": fa["bound_3xtf32_ms"],
         "training_bound_ms": fa_t["bound_ms"],
         "training_bound_3xtf32_ms": fa_t["bound_3xtf32_ms"],
         "training_library_ms": fa_t["library_ms"],
         "bf16": bf16, "design": design,
         "bf16_training": bf16_training("flash_attention_fwd")},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": src + "flash_attention_bwd.cu",
         "replaces": "bigdl_tpu/kernels/flash_attention.py:132",
         "launches": train_counts["flash_attention_bwd_dq"],
         "shape": bwd["shape"], "dtype": bwd["dtype"],
         "max_abs_err": bwd["err_dq"], "ms": bwd["dq_ms"],
         "plain_ms": bwd["plain_ms"], "bound_ms": bwd["dq_bound"][0],
         "bound_by": bwd["dq_bound"][1], "library_ms": bwd["library_ms"],
         "plain_and_library_cover": "dq+dk+dv",
         "library_backend": bwd["library_backend"],
         "paths": paths["flash_attention_bwd_dq"],
         "bound_3xtf32_ms": bwd["dq_bound_3xtf32_ms"], "bf16": bwd_bf16,
         "bf16_training": bf16_training("flash_attention_bwd_dq"),
         "design": design_of("flash_bwd_dq_kernel", bwd["plans"][0],
                             bwd_summary)},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": src + "flash_attention_bwd.cu",
         "replaces": "bigdl_tpu/kernels/flash_attention.py:199",
         "launches": train_counts["flash_attention_bwd_dkv"],
         "shape": bwd["shape"], "dtype": bwd["dtype"],
         "max_abs_err": bwd["err_dkv"], "ms": bwd["dkv_ms"],
         "plain_ms": bwd["plain_ms"], "bound_ms": bwd["dkv_bound"][0],
         "bound_by": bwd["dkv_bound"][1], "library_ms": bwd["library_ms"],
         "plain_and_library_cover": "dq+dk+dv",
         "library_backend": bwd["library_backend"],
         "paths": paths["flash_attention_bwd_dkv"],
         "bound_3xtf32_ms": bwd["dkv_bound_3xtf32_ms"], "bf16": bwd_bf16,
         "bf16_training": bf16_training("flash_attention_bwd_dkv"),
         "design": design_of("flash_bwd_dkv_kernel", bwd["plans"][1],
                             bwd_summary)},
    ], "serving": {"programs": programs, "first_round": cold,
                   "second_round": warm,
                   "decode_step_eager": eager_step,
                   "decode_step_replayed": replayed_step},
        "training": {"step_ms": run["step_ms"],
                    "tokens_per_s": run["tokens_per_s"],
                    "kernel_ms_per_step": kernel_ms,
                    "replay_vs_eager": run["eager"],
                    "fused": {"fuse": FUSE, "step_ms": run_fused["step_ms"],
                              "tokens_per_s": run_fused["tokens_per_s"],
                              "replay_vs_eager": run_fused["eager"]},
                    "profile": {k: (run["profile"] or {}).get(k)
                                for k in ("busy_ms", "wall_ms",
                                          "host_calls")},
                    "bf16": {"step_ms": run16["step_ms"],
                             "tokens_per_s": run16["tokens_per_s"],
                             "kernel_ms_per_step": kernel_ms16,
                             "one_step_check": bf16_check,
                             "flat_update_step_ms": run16_flat["step_ms"],
                             "remat_step_ms": run16_remat["step_ms"],
                             "remat_launches": remat16,
                             "replay_vs_eager": run16["eager"],
                             "fused": {"fuse": FUSE,
                                       "step_ms": run16_fused["step_ms"],
                                       "tokens_per_s":
                                           run16_fused["tokens_per_s"],
                                       "replay_vs_eager":
                                           run16_fused["eager"]},
                             "profile": {k: (run16["profile"] or {}).get(k)
                                         for k in ("busy_ms", "wall_ms",
                                                   "host_calls")}}}}
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
