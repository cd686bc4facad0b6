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
7. runs the llama-style path at full width, ``TransformerLM(32000, 512,
   8, 6)`` with 2 KV heads, RoPE, RMSNorm, SwiGLU and the fused head
   (``lm_criterion(fused_head=True)``, chunks of 8192): one (2, 256) step
   of a 2-layer, 8192-token llama model on the card against the CPU plain
   model in fp32 (loss 1e-4, gradients 1e-3) and bf16 (1e-2, 5e-2); 17
   bf16 ``LocalOptimizer`` steps at 16 x 512, fuse 1 and
   ``set_fuse_steps(8)``, replays bitwise equal to eager steps with equal
   launches; three bf16 steps with dropout 0.1 on one batch, whose two
   replays draw different masks; the head's forward and backward at (8192,
   512) x 32000, fused against the unfused bf16 head, with their bounds and
   peak memory; then, with ``max_len=1024``, the (2, 512) forward against
   the CPU plain model, two serving rounds of phase 5's 16 requests
   (tokens equal to ``greedy_generate``, the cache at KV-head width), and
   one ``SequenceBeamSearch`` (beam 3, decode 32, a 128-token seed; the
   flash forward at (3·8, 160, 64)) against ``beam_generate``;
8. runs the vision path at full width, NHWC, with cuDNN's deterministic
   algorithms (autotuned in each program's eager warm-up): ``ImageNormalize
   -> ResNet(1000, depth 50, ImageNet, conv1SpaceToDepth)``, the JAX bench's
   resnet50 leg; one (2, 224, 224, 3) uint8 step's loss, gradients and
   running statistics on the card against the CPU in fp32 and bf16 (the
   gradients' limits measured: the CPU's NCHW step against its NHWC step,
   the CPU's bf16 step against its fp32 step); 17 bf16 steps of
   ``LocalOptimizer`` at batch 256 on 8 in-memory batches, fuse 1 and
   ``set_fuse_steps(8)``, each bitwise equal to the same steps run eagerly
   (losses, parameters, running statistics), with step ms, images/s, the
   share of the bf16 dense peak, peak memory, the first window and one
   profiled replayed step split into convolutions, batch norm and
   elementwise glue, pooling and the rest; 17 fp32 steps beside them;
   ``Top1Accuracy`` and ``Top5Accuracy`` over 868 held-out images (a padded
   last batch) through the captured eval program, equal to the host folds
   of eager logits; ``fuse_conv_bn``'s folded inference against the
   unfused model at batch 256 in fp32 and bf16, timed; and the LeNet-5 and
   VGG-for-CIFAR training mains on the card, whose losses must fall;
9. checks that the serving path (phases 4 and 5) launched both forward
   kernels and each training run (the 17 steps, fp32 and bf16) all five,
   every launch in the run's dtype (bf16 operands and bf16 gamma and beta
   under the bf16 policy), the LayerNorm backward once for each LayerNorm
   (the forward kernels once a step without remat, twice in each block
   with it) and the plain backward never (phase 7's path: the flash
   kernels only), and prints the kernel table as one JSON line (each
   kernel's row with its bf16 training instance and every path's
   launches), the card line, and the result line ``{"ok": true, "device":
   {...}}`` last.

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
# the llama-style path (phase 7): the transformerlm leg's widths with the
# JAX training main's options (bigdl_tpu/models/transformerlm/train.py)
LLAMA = dict(num_kv_heads=2, position="rope", norm="rms", mlp_kind="swiglu",
             fused_head=True)
BEAM, BEAM_SEED, BEAM_DECODE = 3, 128, 32
BEAM_SHAPE = (BEAM, HEADS, BEAM_SEED + BEAM_DECODE, 64)
HEAD_CHUNK = 8192                                # lm_criterion's default
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
    # the static beam search's full forward: beam x heads, seed + decode
    cases.append((BEAM_SHAPE, True, torch.float32, 2e-4, 2e-4))
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


def full_forward(lm, build_ref):
    """The (2, 512) forward on the card against ``build_ref()``, the same
    weights on the CPU with the plain attention."""
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
    ref = build_ref()
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


def decode_kernels(lm, install_decode_cache, Program, card, name):
    """One replayed decode step of the slot grid under ``torch.profiler``
    (reported only): how many kernels the graph runs and their device
    time, with the largest by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tok = torch.zeros((SLOTS, 1), dtype=torch.long, device=DEVICE)
    with torch.no_grad():
        state = install_decode_cache(lm, SLOTS, MAX_LEN)
        prog = Program(("decode_profile", name),
                       lambda t: lm.run(t, state)[0], (tok,), DEVICE)
        prog()                                # warm-up, then capture
        prog()
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                prog()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA]
        except Exception as e:  # noqa: BLE001 — an observation, not a check
            log(f"  profiler: no device times ({type(e).__name__}: {e})")
            return None

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (e.self_cuda_time_total if us is None else us) / 1e3

    n = sum(e.count for e in events)
    busy = sum(dev_ms(e) for e in events)
    top = sorted(events, key=dev_ms, reverse=True)[:5]
    log(f"  {name} decode step, one replay profiled: {n} kernels, "
        f"{busy:.3f} ms of device time; largest: "
        + "; ".join(f"{e.key[:48]} x{e.count} {dev_ms(e):.3f} ms"
                    for e in top) + f" [{card}]")
    return {"kernels": n, "device_ms": busy,
            "top": [[e.key[:90], dev_ms(e), e.count] for e in top]}


def check_programs(stats, prompts, buckets, pick_bucket, launches,
                   fwd_counts, ln_per_call=2 * LAYERS + 1):
    """The engine's program ledger: one program per prefill bucket used,
    one decode, one assign, within ``len(buckets) + 2``; every model call
    of the run (a prefill or a tick, eager warm-up or replay) launched the
    LayerNorm forward ``ln_per_call`` times (13; none with RMSNorm), as an
    eager run does."""
    used = {pick_bucket(len(p), buckets) for p in prompts}
    n, bound = stats["compiled_programs"], stats["program_grid_bound"]
    calls = stats["prefills"] + stats["decode_ticks"]
    ln = launches["layer_norm_fwd"] - fwd_counts["layer_norm_fwd"]
    log(f"  programs: {n} compiled (bound {bound}; {len(used)} prefill "
        f"buckets used + decode + assign); LN forward launches {ln} over "
        f"{calls} model calls ({ln_per_call} each eagerly: "
        f"{ln_per_call * calls})")
    if n > bound or n != len(used) + 2:
        raise CheckFailed(f"the engine compiled {n} programs for "
                          f"{len(used)} buckets (bound {bound})")
    if ln != ln_per_call * calls:
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


def profile_step(opt, batch, card, kinds=KERNEL_KINDS):
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
        kind = next((k for k, words in kinds if any(
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
                    remat, llama=False):
    """The same steps run eagerly on the card: a fresh model from the same
    seed, the trainer's step function called directly on each recorded
    batch with the host's step numbers, as the program would replay it.
    Returns the losses, the parameters and the launches of those steps."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import LocalOptimizer
    from bigdl_tpu_torch.optim.optim_method import hyper_tensor

    build = build_llama_lm if llama else build_train_lm
    lm = build(TransformerLM, "auto", DEVICE, remat=remat)
    opt = LocalOptimizer(lm, DataSet.array([]), lm_criterion(llama),
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
          flat=False, remat=False, fuse=1, profile=True, compare=False,
          llama=False):
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
    build = build_llama_lm if llama else build_train_lm
    lm = build(TransformerLM, "auto", DEVICE, remat=remat)
    opt = (LocalOptimizer(lm, data, lm_criterion(llama), device=DEVICE)
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
                                  method(), seen, remat, llama)
    finally:
        opt._run_steps = run_steps
        ln_module.layer_norm_backward = plain_bwd
    what = ("llama " if llama else "") + \
        ("bf16 steps" if bf16 else "steps") + \
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
        if n == 0 and not (llama and name.startswith("layer_norm")):
            raise CheckFailed(f"the training path never launched {name}")
    # LN: two a block, one final (none with RMSNorm); under remat a block's
    # forward kernels run again when its backward recomputes it
    runs = 2 if remat else 1
    norms = 0 if llama else 1
    ln_per_run = (2 * LAYERS + 1) * TRAIN_ITERS * norms
    ln_fwd = (2 * LAYERS * runs + 1) * TRAIN_ITERS * norms
    flash_fwd = LAYERS * runs * TRAIN_ITERS
    if (counts["layer_norm_fwd"] != ln_fwd
            or counts["flash_attention_bwd_dq"] != LAYERS * TRAIN_ITERS
            or counts["flash_attention_bwd_dkv"] != LAYERS * TRAIN_ITERS
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
        if counts[name] and split != {key: counts[name]}:
            raise CheckFailed(f"the training path ({what}) launched {name} "
                              f"as {split}, not all as {key}")
    check = compare_eager(what, losses, lm, counts, ref, bf16,
                          bitwise_required=llama) if compare else None
    prof = (profile_step(opt, next(iter(data.data(train=True))), card)
            if profile else None)
    return counts, dict(losses=losses, step_ms=step_ms,
                        tokens_per_s=tokens / step_ms * 1e3,
                        first_window_ms=(marks[0] - t0) * 1e3, profile=prof,
                        by_dtype=by_dtype, windows=windows, eager=check)


def compare_eager(what, losses, lm, counts, ref, bf16,
                  bitwise_required=False):
    """The replayed run against the same steps run eagerly: every loss
    within the one-step check's loss tolerance (relative 1e-4, bf16 1e-2),
    every parameter within its gradient tolerance (relative Frobenius 1e-3,
    bf16 5e-2), and the same launches of every kernel. Reports the largest
    differences and whether everything is bitwise equal, which
    ``bitwise_required`` demands."""
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
    if bitwise_required and not bitwise:
        raise CheckFailed(f"{what}: the replayed steps are not bitwise "
                          f"equal to the eager ones")
    return {"loss_rel": loss_rel, "param_rel": rel[worst],
            "param_max_abs_err": abs_err, "bitwise": bitwise,
            "launches_per_step": {k: v / TRAIN_ITERS
                                  for k, v in counts.items()}}


# ---------------------------------------------------------------- phase 7
def build_llama_lm(TransformerLM, attention_impl, device, remat=False,
                   max_len=TRAIN_LEN, dropout=0.0):
    """The llama-style model at full width: ``TransformerLM(32000, 512, 8,
    6)`` with 2 KV heads, RoPE, RMSNorm, SwiGLU and the fused head."""
    return TransformerLM(VOCAB, EMBED, HEADS, LAYERS, max_len,
                         dropout=dropout, remat=remat,
                         attention_impl=attention_impl,
                         generator=torch.Generator().manual_seed(SEED + 8),
                         device=device, **LLAMA)


def check_llama_step(TransformerLM, lm_criterion, bf16):
    """Loss and every gradient of one (2, 256) step of a small llama-style
    model, ``TransformerLM(8192, 512, 8, 2, **LLAMA)`` through
    ``lm_criterion(fused_head=True, chunk_size=2048)``, on the card (flash
    kernels) against the same weights on the CPU (``attention_impl=
    "full"``), both through ``LocalOptimizer``'s loss-and-gradient path
    (under the bf16 policy with ``bf16``). Tolerances as phase 6: fp32
    loss 1e-4 and gradients 1e-3 relative; bf16 1e-2 and 5e-2."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import LocalOptimizer

    rng = np.random.default_rng(SEED + 9)
    ids = torch.from_numpy(rng.integers(0, 8192, (2, 257)))
    x, y = ids[:, :-1], ids[:, 1:]
    runs = []
    for device, impl in ((DEVICE, "auto"), ("cpu", "full")):
        lm = TransformerLM(8192, EMBED, HEADS, 2, 256, attention_impl=impl,
                           generator=torch.Generator().manual_seed(SEED + 9),
                           device=device, **LLAMA)
        opt = LocalOptimizer(lm, DataSet.array([]),
                             lm_criterion(True, chunk_size=2048),
                             device=device)
        names, params = zip(*lm.named_parameters())
        loss, grads = opt._loss_and_grads(list(params), x.to(device),
                                          y.to(device))
        runs.append((loss.item(), {n: g.detach().cpu()
                                   for n, g in zip(names, grads)}))
        del lm, opt, loss, grads
    (loss, grads), (loss_ref, grads_ref) = runs
    rel_loss = abs(loss - loss_ref) / abs(loss_ref)
    rel = rel_errors(grads, grads_ref)
    worst = max(rel, key=rel.get)
    loss_tol, grad_tol = (1e-2, 5e-2) if bf16 else (1e-4, 1e-3)
    log(f"  llama one (2, 256) {'bf16 ' if bf16 else ''}step: loss "
        f"{loss:.6f} vs CPU plain {loss_ref:.6f} (relative {rel_loss:.2e}, "
        f"limit {loss_tol}); gradients of {len(rel)} parameters, worst "
        f"relative error {rel[worst]:.2e} ({worst}, limit {grad_tol})")
    if rel_loss > loss_tol or rel[worst] > grad_tol:
        raise CheckFailed(f"llama training step disagrees with the CPU plain "
                          f"model: loss {rel_loss:.3e}, {worst} "
                          f"{rel[worst]:.3e}")
    return {"rel_loss": rel_loss, "worst_grad_rel": rel[worst]}


def cache_bytes(state) -> int:
    if isinstance(state, dict):
        return sum(cache_bytes(v) for v in state.values())
    return state.numel() * state.element_size()


def beam_search(lm, nn, card):
    """One ``SequenceBeamSearch`` (beam 3, decode 32, a 128-token seed, the
    full forward a step through the flash kernel) and one ``beam_generate``
    (KV-cached, plain cached attention) over the same model: their
    sequences must be equal. The search's candidate selections are
    recorded: where the two differ, the smallest gap a selection rested on
    must be under the near-tie bound (the flash kernel and the plain
    attention round differently)."""
    from bigdl_tpu_torch.nn import beam_search as bs_module

    rng = np.random.default_rng(SEED + 10)
    seed = rng.integers(0, VOCAB, (1, BEAM_SEED))
    gaps = []
    top_k = bs_module._top_k

    def recorded(x, k):
        vals, idx = top_k(x, k + 1 if k < x.shape[-1] else k)
        real = vals > bs_module._NEG / 2
        d = (vals[..., :-1] - vals[..., 1:])[real[..., 1:]]
        if d.numel():
            gaps.append(float(d.min()))
        return vals[..., :k], idx[..., :k]

    search = nn.SequenceBeamSearch(lm, BEAM, -1, BEAM_DECODE, alpha=0.6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bs_module._top_k = recorded
    try:
        out = search.forward(seed)
    finally:
        bs_module._top_k = top_k
    torch.cuda.synchronize()
    static_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seqs, scores = nn.beam_generate(lm, seed, BEAM_DECODE, BEAM, -1, 0.6)
    torch.cuda.synchronize()
    cached_s = time.perf_counter() - t0
    equal = bool(torch.equal(out[1], seqs))
    score_err = max_err(out[2], scores)
    min_gap = min(gaps)
    log(f"  beam search (beam {BEAM}, decode {BEAM_DECODE}, seed "
        f"{BEAM_SEED}): SequenceBeamSearch {static_s * 1e3:.1f} ms "
        f"({BEAM_DECODE} full forwards at {BEAM_SHAPE}), beam_generate "
        f"{cached_s * 1e3:.1f} ms ({BEAM_SEED + BEAM_DECODE - 1} cached "
        f"steps); sequences equal {equal}, scores max|err| {score_err:.3e}, "
        f"smallest selection gap {min_gap:.3e} [{card}]")
    if not equal and min_gap >= NEAR_TIE:
        raise CheckFailed("SequenceBeamSearch and beam_generate chose other "
                          f"sequences with no near-tie (gap {min_gap})")
    if equal and score_err > 1e-3:
        raise CheckFailed(f"beam scores differ by {score_err}")
    return {"static_ms": static_s * 1e3, "cached_ms": cached_s * 1e3,
            "sequences_equal": equal, "score_max_abs_err": score_err,
            "min_selection_gap": min_gap}


def dropout_step(TransformerLM, lm_criterion, card):
    """Three bf16 steps of the full-width llama model with dropout 0.1 on
    one batch at learning rate 0: the first is the warm-up and capture, the
    next two are replays; each replay draws new masks, so their losses
    differ."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer

    lm = build_llama_lm(TransformerLM, "auto", DEVICE, dropout=0.1)
    opt = (LocalOptimizer(lm, DataSet.array([]), lm_criterion(True),
                          device=DEVICE)
           .set_optim_method(SGD(learningrate=0.0)))
    rng = np.random.default_rng(SEED + 11)
    x, y = (torch.from_numpy(rng.integers(0, VOCAB, (TRAIN_BATCH,
                                                     TRAIN_LEN))).cuda()
            for _ in range(2))
    losses = [opt.train_step(x, y) for _ in range(3)]
    replays = opt._step_program.replays
    log(f"  dropout 0.1, bf16, one batch three times (lr 0): losses "
        f"{losses}; replays {replays}")
    if replays != 2 or losses[1] == losses[2] or \
            not all(np.isfinite(losses)):
        raise CheckFailed(f"dropout replays did not draw new masks: "
                          f"{losses}, {replays} replays")
    return {"losses": losses, "replays": replays}


def time_head(nn, card):
    """The LM head's forward and backward at (8192, 512) x 32000 under the
    bf16 policy, as the step runs it: the fused head (bf16 hidden, weight
    and bias cast to fp32, ``chunked_softmax_xent`` in chunks of 8192, fp32
    products with TF32 off) against the unfused one (bf16 ``Linear``, the
    fp32 ``LogSoftMax`` island, NLL), with their bounds: four fp32 products
    of 2·N·V·d on the CUDA cores (67 TFLOP/s) for the fused head, two bf16
    ones plus the fp32 softmax's bytes for the unfused one."""
    import torch.nn.functional as F

    n, d = TRAIN_BATCH * TRAIN_LEN, EMBED
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    h = torch.randn(n, d, generator=g, device=DEVICE).bfloat16()
    w = (torch.randn(VOCAB, d, generator=g, device=DEVICE) * 0.02).bfloat16()
    b = torch.zeros(VOCAB, device=DEVICE).bfloat16()
    labels = torch.randint(0, VOCAB, (n,), generator=g, device=DEVICE)
    for t in (h, w, b):
        t.requires_grad_()

    def fused():
        loss = nn.chunked_softmax_xent(h.float(), w.float(), b.float(),
                                       labels, HEAD_CHUNK).mean()
        return torch.autograd.grad(loss, (h, w, b))

    def unfused():
        logp = F.log_softmax(F.linear(h, w, b).float(), dim=-1)
        return torch.autograd.grad(F.nll_loss(logp, labels), (h, w, b))

    with torch.no_grad():
        ref = (F.log_softmax((h.float() @ w.float().T + b.float()), -1)
               .gather(1, labels[:, None])[:, 0].neg())
    got = nn.chunked_softmax_xent(h.float(), w.float(), b.float(), labels,
                                  HEAD_CHUNK).detach()
    err = max_err(got, ref)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fused()
    fused_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    unfused()
    unfused_peak = torch.cuda.max_memory_allocated() - base
    f_ms, _ = time_ms(fused, reps=3, trials=3)
    u_ms, _ = time_ms(unfused, reps=3, trials=3)
    fma_ms = 4 * 2.0 * n * VOCAB * d / PEAK_FLOPS["float32"] * 1e3
    bf16_ms = max(2 * 2.0 * n * VOCAB * d / PEAK_FLOPS["bfloat16"],
                  4 * n * VOCAB * 4 / HBM_BYTES_PER_S) * 1e3
    log(f"  LM head forward + backward at ({n}, {d}) x {VOCAB}: fused "
        f"{f_ms:.3f} ms (bound {fma_ms:.3f} ms: four fp32 products on the "
        f"CUDA cores; peak memory {fused_peak / 2**20:.0f} MiB), unfused "
        f"bf16 {u_ms:.3f} ms (bound {bf16_ms:.3f} ms; peak "
        f"{unfused_peak / 2**20:.0f} MiB); fused losses against the plain "
        f"fp32 head max|err| {err:.3e} [{card}]")
    if err > 1e-3:
        raise CheckFailed(f"the fused head's losses disagree with the plain "
                          f"head: {err}")
    return {"fused_ms": f_ms, "unfused_ms": u_ms, "fused_bound_ms": fma_ms,
            "unfused_bound_ms": bf16_ms, "fused_peak_bytes": fused_peak,
            "unfused_peak_bytes": unfused_peak, "max_abs_err": err}


def llama_path(TransformerLM, lm_criterion, nn, kernels, card,
               ServingEngine, pick_bucket, Engine):
    """Phase 7: the llama-style path at full width. Its serving path (the
    full forward, two serving rounds, the beam searches) and its bf16
    training runs are each counted from a reset."""
    checks = {"fp32": check_llama_step(TransformerLM, lm_criterion, False)}
    Engine.init(compute_dtype=torch.bfloat16)
    try:
        checks["bf16"] = check_llama_step(TransformerLM, lm_criterion, True)
        counts, run = train(TransformerLM, lm_criterion, kernels, card,
                            bf16=True, compare=True, llama=True)
        _, run_fused = train(TransformerLM, lm_criterion, kernels, card,
                             bf16=True, fuse=FUSE, compare=True,
                             profile=False, llama=True)
        drop = dropout_step(TransformerLM, lm_criterion, card)
    finally:
        Engine.reset()
    head = time_head(nn, card)

    lm = build_llama_lm(TransformerLM, "auto", DEVICE,
                        max_len=MAX_LEN).evaluate()
    # the serving path: counted from here ...
    kernels.reset_launch_counts()
    full_forward(lm, lambda: build_llama_lm(TransformerLM, "full", "cpu",
                                            max_len=MAX_LEN).evaluate())
    fwd_counts = kernels.launch_counts()
    prompts, rounds = serve(lm, ServingEngine)
    serve_counts = kernels.launch_counts()
    beams = beam_search(lm, nn, card)
    launches = kernels.launch_counts()     # ... to here
    (results, wall, stats0), (results2, wall2, stats) = rounds
    cold = report_round("llama first round (captures)", results, wall,
                        stats0, {}, card)
    warm = report_round("llama second round (replays only)", results2,
                        wall2, stats, stats0, card)
    check_served_tokens(lm, nn.greedy_generate, prompts, results)
    if any(not np.array_equal(a.tokens, b.tokens)
           for a, b in zip(results, results2)):
        raise CheckFailed("the llama engine's second round served other "
                          "tokens")
    programs = check_programs(stats, prompts, stats["buckets"], pick_bucket,
                              serve_counts, fwd_counts, ln_per_call=0)
    from bigdl_tpu_torch.utils.programs import Program
    tick_profile = decode_kernels(lm, nn.install_decode_cache, Program, card,
                                  "llama")
    engine_cache = cache_bytes(nn.install_decode_cache(lm, SLOTS, MAX_LEN))
    mha_cache = engine_cache * HEADS // LLAMA["num_kv_heads"]
    log(f"  llama serving: tokens match solo greedy_generate in both rounds; "
        f"the {SLOTS}-slot, {MAX_LEN}-position fp32 cache is "
        f"{engine_cache / 1e6:.1f} MB ({LLAMA['num_kv_heads']} KV heads; "
        f"{mha_cache / 1e6:.1f} MB with {HEADS}); launches {launches} "
        f"(full forward {fwd_counts})")
    if launches["flash_attention_fwd"] != LAYERS * (1 + BEAM_DECODE):
        raise CheckFailed(f"the llama serving path launched the flash "
                          f"forward {launches['flash_attention_fwd']} times, "
                          f"not {LAYERS * (1 + BEAM_DECODE)}")
    del lm
    torch.cuda.empty_cache()
    beam_counts = {k: launches[k] - serve_counts[k] for k in launches}
    return {"counts": counts, "serving_counts": launches,
            "beam_counts": beam_counts, "summary": {
        "one_step_check": checks,
        "training_bf16": {"step_ms": run["step_ms"],
                          "tokens_per_s": run["tokens_per_s"],
                          "replay_vs_eager": run["eager"],
                          "profile": {k: (run["profile"] or {}).get(k)
                                      for k in ("busy_ms", "wall_ms",
                                                "by_kind_ms", "host_calls")},
                          "fused": {"fuse": FUSE,
                                    "step_ms": run_fused["step_ms"],
                                    "tokens_per_s": run_fused["tokens_per_s"],
                                    "replay_vs_eager": run_fused["eager"]}},
        "dropout": drop, "head": head,
        "serving": {"programs": programs, "first_round": cold,
                    "second_round": warm, "cache_bytes": engine_cache,
                    "decode_step_profile": tick_profile,
                    "cache_bytes_all_heads": mha_cache},
        "beam_search": beams}}


# ---------------------------------------------------------------- phase 8
# the vision path: the JAX bench's resnet50 leg (bigdl_tpu/benchmark.py:
# 215-309): ImageNormalize -> ResNet-50 with the space-to-depth stem, NHWC
# (:197), uint8 224x224x3 pixels normalised on the card (:231-237), batch
# 256 (:163), ClassNLLCriterion (:239), 8 in-memory batches, SGD(0.01,
# momentum 0.9, dampening 0) (:354), bf16 (:349)
VISION_BATCH, VISION_HW, VISION_CLASSES = 256, 224, 1000
RESNET50_STEP_FLOPS = 3 * 2 * 4.09e9 * VISION_BATCH       # benchmark.py:42
VISION_PARITY_BATCH = 2
# each residual branch's last BN gamma in the one-step check's second bf16
# step, where the backward does not amplify rounding (check_resnet_step)
DAMPED_GAMMA = 0.05
# bf16 against fp32 losses: the first (rounding only, the one-step
# check's 1e-2) and all 17 (the trajectories also drift apart)
VISION_DRIFT = (1e-2, 5e-2)
VISION_FOLD_FP32 = 1e-3  # folded against unfused log-probs, relative
# kinds of a profiled vision step, by words in the kernel's name (first
# match wins)
VISION_KINDS = (
    ("layout transposes", ("nchwtonhwc", "nhwctonchw")),
    ("conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn", "implicit")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("pooling", ("pool",)),
    ("bn/elementwise", ("elementwise", "reduce", "vectorized", "unrolled",
                        "batch_norm")))


def build_resnet50(device, seed=SEED + 8):
    """``ImageNormalize -> ResNet-50`` (s2d stem), weights from a seed."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.resnet import ResNet
    net = ResNet(VISION_CLASSES, {"depth": 50, "dataSet": "ImageNet",
                                  "conv1SpaceToDepth": True},
                 generator=torch.Generator().manual_seed(seed), device=device)
    return nn.Sequential().add(nn.ImageNormalize()).add(net).to(device)


def vision_batches(n, seed):
    """``n`` uint8 NHWC batches of 256 with labels, made from a seed."""
    from bigdl_tpu_torch.dataset import MiniBatch
    r = np.random.default_rng(seed)
    return [MiniBatch(r.integers(0, 256, (VISION_BATCH, VISION_HW, VISION_HW,
                                          3), dtype=np.uint8),
                      r.integers(0, VISION_CLASSES, VISION_BATCH).astype(
                          np.int32)) for _ in range(n)]


def flat_rel(a: dict, b: dict) -> float:
    """Relative Frobenius distance of two gradient sets, the whole model."""
    num = sum(float((a[n] - g).double().norm()) ** 2 for n, g in b.items())
    den = sum(float(g.double().norm()) ** 2 for g in b.values())
    return math.sqrt(num / max(den, 1e-300))


def resnet_loss_and_grads(model, x, y, device):
    """Loss, gradients (host, fp32) and running statistics after one
    forward and backward of the training step's own path."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import LocalOptimizer
    opt = LocalOptimizer(model, DataSet.array([]), ClassNLLCriterion(),
                         device=device)
    names, params = zip(*model.named_parameters())
    loss, grads = opt._loss_and_grads(list(params), x.to(device),
                                      y.to(device))
    stats = {n: b.detach().cpu().clone() for n, b in model.named_buffers()
             if "running" in n}
    return loss.item(), {n: g.detach().cpu().float()
                         for n, g in zip(names, grads)}, stats


def damp_residuals(model, gamma=DAMPED_GAMMA):
    """``model`` (as :func:`build_resnet50` makes it) with each residual branch's last BN gamma (the parameters
    that ``zeroInitResidual`` zeroes) set to ``gamma``, in place."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.resnet import ResNet
    zeroed = ResNet(VISION_CLASSES, {"depth": 50, "dataSet": "ImageNet",
                                     "conv1SpaceToDepth": True,
                                     "zeroInitResidual": True},
                    device="cpu")
    # the ResNet is the second child of build_resnet50's Sequential
    names = {"1." + n for n, p in zeroed.named_parameters()
             if n.endswith(".weight") and p.dim() == 1 and not bool(p.any())}
    params = dict(model.named_parameters())
    assert len(names) == 16 and names <= set(params), names
    with torch.no_grad():
        for n in names:
            params[n].fill_(gamma)
    return model


def gradient_groups(model) -> dict:
    """Parameter names by group: the whole model, each child of the ResNet
    that has parameters ("block <i>"), and the classifier (the last
    ``Linear``)."""
    from bigdl_tpu_torch import nn
    names = [n for n, _ in model.named_parameters()]
    out = {"all": names}
    for n in names:
        out.setdefault("block " + n.split(".")[1], []).append(n)
    fc = [n for n, m in model.named_modules() if isinstance(m, nn.Linear)][-1]
    out["classifier"] = [n for n in names if n.startswith(fc + ".")]
    return out


def group_rel(a: dict, b: dict, names) -> float:
    return flat_rel({n: a[n] for n in names}, {n: b[n] for n in names})


def check_resnet_step(layout, Engine):
    """One step of ``ImageNormalize -> ResNet-50`` (s2d, NHWC) at (2, 224,
    224, 3) uint8 on the card against the same weights on the CPU: the
    loss, the gradients, and the running statistics after the step, in
    fp32 (TF32 off) and under the bf16 policy.

    The loss and the statistics are smooth functions of the weights:
    fp32 within 1e-4 relative (the LM path's loss tolerance; statistics
    per buffer, Frobenius); bf16: the loss within 1e-2, the statistics
    within 1.5x the CPU bf16 step's own distance from the CPU fp32 step's
    (at least 1e-2: over 2 images the last stage's statistics are over 98
    values a channel, and bf16 inputs move them ~6%).

    The gradients are not smooth: a ReLU gate whose input lies within
    rounding of zero opens on one side and shuts on the other (a batch of
    2 at 224x224 has ~20 million gated values), and at init the backward
    amplifies any difference block by block. In fp32 the CPU runs the same
    step again in NCHW (other summation orders, the same arithmetic), and
    the card's distance from the CPU's NHWC gradient (whole model,
    relative Frobenius) must be within 3x that NCHW-to-NHWC distance (and
    within 1e-3 when that is smaller). Under bf16 the rounding alone moves
    the whole gradient at init more than 100% from the fp32 gradient, on
    the CPU and in JAX alike (tests/test_torch_resnet.py), so it is held
    only where rounding does not swamp it: per group, the card's bf16
    gradient within 1.25x the CPU bf16 step's distance from the CPU fp32
    gradient, measured from the fp32 gradient (1.5x for a tensor alone),
    and within 1.5x of it from the CPU bf16 gradient (two roundings), with
    that CPU distance under 0.5, so that every limit is below the 1.0 a
    zero gradient reads. The
    groups: the classifier at init; and, in a second bf16 step on the same
    weights with each residual branch's last BN gamma at DAMPED_GAMMA (the
    parameters ``zeroInitResidual`` zeroes; the backward is tame there),
    every block, the whole model and every tensor alone whose CPU gap is
    under 0.5."""
    import copy
    r = np.random.default_rng(SEED + 9)
    x = torch.from_numpy(r.integers(0, 256, (VISION_PARITY_BATCH, VISION_HW,
                                             VISION_HW, 3), dtype=np.uint8))
    y = torch.from_numpy(r.integers(0, VISION_CLASSES, VISION_PARITY_BATCH)
                         .astype(np.int64))
    base = build_resnet50("cpu")
    damped = damp_residuals(copy.deepcopy(base))
    groups = gradient_groups(base)
    out = {}

    def run(where, fmt, dtype, weights=base):
        layout.set_image_format(fmt)
        Engine.init(compute_dtype=dtype)
        try:
            model = copy.deepcopy(weights).to(where)
            xx = x if fmt == "NHWC" else x.permute(0, 3, 1, 2).contiguous()
            t0 = time.perf_counter()
            res = resnet_loss_and_grads(model, xx, y, where)
            if where != "cpu":
                torch.cuda.synchronize()
            del model
            return res + (time.perf_counter() - t0,)
        finally:
            Engine.reset()
            layout.set_image_format("NHWC")

    card32 = run(DEVICE, "NHWC", torch.float32)
    cpu32 = run("cpu", "NHWC", torch.float32)
    cpu32_nchw = run("cpu", "NCHW", torch.float32)
    card16 = run(DEVICE, "NHWC", torch.bfloat16)
    cpu16 = run("cpu", "NHWC", torch.bfloat16)
    card16d = run(DEVICE, "NHWC", torch.bfloat16, damped)
    cpu16d = run("cpu", "NHWC", torch.bfloat16, damped)
    cpu32d = run("cpu", "NHWC", torch.float32, damped)
    torch.cuda.empty_cache()

    def stats_rel(a, b):
        return max(float((a[n] - v).norm() / v.norm().clamp(min=1e-30))
                   for n, v in b.items())

    def worst(a, b):
        rel = rel_errors(a, b)
        k = max(rel, key=rel.get)
        return k, rel[k]

    def held(card, cpu_bf16, cpu_fp32, names, fp32_factor=1.25):
        """Per group: the CPU's bf16-vs-fp32 gap, the card's distances
        from the CPU's fp32 and bf16 gradients, and the limits."""
        gap = group_rel(cpu_bf16[1], cpu_fp32[1], names)
        return {"cpu_gap": gap,
                "to_fp32": group_rel(card[1], cpu_fp32[1], names),
                "to_bf16": group_rel(card[1], cpu_bf16[1], names),
                "limit_fp32": fp32_factor * gap, "limit_bf16": 1.5 * gap}

    order = flat_rel(cpu32_nchw[1], cpu32[1])
    g32 = flat_rel(card32[1], cpu32[1])
    out["float32"] = {
        "loss": card32[0], "loss_rel": abs(card32[0] - cpu32[0]) / cpu32[0],
        "grad_rel": g32, "grad_limit": max(3 * order, 1e-3),
        "cpu_nchw_vs_nhwc_grad_rel": order,
        "worst_tensor": worst(card32[1], cpu32[1]),
        "stats_rel": stats_rel(card32[2], cpu32[2]),
        "card_s": card32[3], "cpu_s": cpu32[3]}
    stats_noise = stats_rel(cpu16[2], cpu32[2])
    bf16_groups = {"init " + g: held(card16, cpu16, cpu32, groups[g])
                   for g in ("classifier",)}
    bf16_groups.update({f"damped {g}": held(card16d, cpu16d, cpu32d, names)
                        for g, names in groups.items() if g != "classifier"})
    # and at the damped weights every tensor alone whose CPU gap is under
    # 0.5 (all but a few, which the CPU runs alone decide): a fault
    # confined to one kind of tensor (the BN gammas' gradient, say) moves
    # its own tensors past their limits. One tensor's distance from the
    # fp32 gradient spreads more than a group's (the CPU's NCHW bf16 step
    # up to 1.11x its NHWC step's gap, the card 1.15x): 1.5x for both
    per_tensor = {n: held(card16d, cpu16d, cpu32d, [n], fp32_factor=1.5)
                  for n in groups["all"]}
    not_held = sorted(n for n, h in per_tensor.items() if h["cpu_gap"] >= 0.5)
    per_tensor = {n: h for n, h in per_tensor.items() if n not in not_held}
    out["bfloat16"] = {
        "loss": card16[0], "loss_rel": abs(card16[0] - cpu16[0]) / cpu16[0],
        "grad_rel": flat_rel(card16[1], cpu16[1]),
        "grad_rel_to_fp32": flat_rel(card16[1], cpu32[1]),
        "cpu_bf16_vs_fp32_grad_rel": flat_rel(cpu16[1], cpu32[1]),
        "worst_tensor": worst(card16[1], cpu16[1]),
        "stats_rel": stats_rel(card16[2], cpu16[2]),
        "stats_limit": max(1e-2, 1.5 * stats_noise),
        "cpu_bf16_vs_fp32_stats_rel": stats_noise,
        "damped_gamma": DAMPED_GAMMA,
        "damped_loss_rel": abs(card16d[0] - cpu16d[0]) / cpu16d[0],
        "held": bf16_groups,
        "per_tensor": {
            "tensors": len(per_tensor), "not_held": not_held,
            "max_cpu_gap": max(h["cpu_gap"] for h in per_tensor.values()),
            "worst_to_fp32": max(((n, h["to_fp32"] / h["limit_fp32"])
                                  for n, h in per_tensor.items()),
                                 key=lambda t: t[1]),
            "worst_to_bf16": max(((n, h["to_bf16"] / h["limit_bf16"])
                                  for n, h in per_tensor.items()),
                                 key=lambda t: t[1])},
        "card_s": card16[3], "cpu_s": cpu16[3]}
    b = out["bfloat16"]
    for name, c in out.items():
        log(f"  one (2, 224, 224, 3) uint8 step, {name}: loss {c['loss']:.6f} "
            f"(relative to the CPU {c['loss_rel']:.2e}); gradients, whole "
            f"model, {c['grad_rel']:.2e} from the CPU's (worst tensor "
            f"{c['worst_tensor'][0]} {c['worst_tensor'][1]:.2e}); running "
            f"statistics {c['stats_rel']:.2e}; card {c['card_s']:.2f} s, "
            f"CPU {c['cpu_s']:.2f} s")
    log(f"  fp32 gradient limit {out['float32']['grad_limit']:.2e} (the "
        f"CPU's NCHW step is {order:.2e} from its NHWC step); bf16 running "
        f"statistics {b['stats_rel']:.2e}, limit {b['stats_limit']:.2e} "
        f"(the CPU bf16 step's are {stats_noise:.2e} from its fp32 "
        f"step's); bf16 gradients at init, whole model (not held: rounding "
        f"swamps it): the CPU bf16 step {b['cpu_bf16_vs_fp32_grad_rel']:.2e} "
        f"from the CPU fp32 step, the card's {b['grad_rel_to_fp32']:.2e}")
    log(f"  bf16 gradients held (group: CPU bf16-vs-fp32 gap; the card's "
        f"distance from the CPU fp32 / bf16 gradient, each over its limit); "
        f"damped: residual branches' last BN gamma {DAMPED_GAMMA}, loss "
        f"{b['damped_loss_rel']:.2e} from the CPU's:")
    for g, h in bf16_groups.items():
        log(f"    {g}: {h['cpu_gap']:.3e}; {h['to_fp32']:.3e} / "
            f"{h['limit_fp32']:.3e}, {h['to_bf16']:.3e} / "
            f"{h['limit_bf16']:.3e}")
    pt = b["per_tensor"]
    log(f"    damped, each of {pt['tensors']} tensors alone (not held, CPU "
        f"gap 0.5 or more: {pt['not_held']}): CPU gaps up to "
        f"{pt['max_cpu_gap']:.3e}; the nearest to its limit "
        f"{pt['worst_to_fp32'][0]} at {pt['worst_to_fp32'][1]:.3f} of it "
        f"(from the CPU fp32 gradient), {pt['worst_to_bf16'][0]} at "
        f"{pt['worst_to_bf16'][1]:.3f} (from the CPU bf16 gradient)")
    f = out["float32"]
    if f["loss_rel"] > 1e-4 or f["stats_rel"] > 1e-4 \
            or f["grad_rel"] > f["grad_limit"]:
        raise CheckFailed(f"the fp32 ResNet-50 step disagrees with the CPU: "
                          f"{f}")
    bad = {g: h for g, h in list(bf16_groups.items()) + [
               ("damped tensor " + n, h) for n, h in per_tensor.items()]
           if h["cpu_gap"] >= 0.5 or h["to_fp32"] > h["limit_fp32"]
           or h["to_bf16"] > h["limit_bf16"]}
    if b["loss_rel"] > 1e-2 or b["damped_loss_rel"] > 1e-2 \
            or b["stats_rel"] > b["stats_limit"] or bad:
        raise CheckFailed(f"the bf16 ResNet-50 step disagrees with the CPU: "
                          f"{ {k: v for k, v in b.items() if k != 'held'} }; "
                          f"groups out of their limits {bad}")
    return out


def release() -> None:
    """Give the memory of the models and programs just dropped back."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def train_vision(batches, kernels, card, bf16=False, fuse=1, compare=False,
                 profile=True):
    """TRAIN_ITERS steps of the bench's resnet50 leg at batch 256 over the
    8 in-memory ``batches`` (a fresh dataset, so every run sees the same
    epoch orders), the step a captured program (fuse 1)
    or fused windows of ``fuse``; under the bf16 policy or in fp32. Returns
    the run's numbers and, with ``compare``, the same steps run eagerly
    from the same seed (:func:`vision_eager`), which must equal the
    replayed steps bit for bit (cuDNN runs deterministic algorithms in
    this phase), and that eagerly trained model. ``profile``: one more
    replayed step under ``torch.profiler``, its device time by kind."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    data = DataSet.array(batches)
    model = build_resnet50(DEVICE)
    opt = (LocalOptimizer(model, data, ClassNLLCriterion(), device=DEVICE)
           .set_optim_method(SGD(learningrate=0.01, momentum=0.9,
                                 dampening=0.0))
           .set_end_when(Trigger.max_iteration(TRAIN_ITERS))
           .set_fuse_steps(fuse))
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
    RandomGenerator.set_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        opt.optimize()
        torch.cuda.synchronize()
    finally:
        opt._run_steps = run_steps
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    what = ("bf16" if bf16 else "fp32") + f" steps, fuse {fuse}"
    if len(losses) != TRAIN_ITERS or not all(np.isfinite(losses)):
        raise CheckFailed(f"ResNet-50 training gave losses {losses}")
    if fuse == 1:
        step_ms = float(statistics.median(np.diff(marks))) * 1e3
    else:
        if windows[:2] != [fuse, fuse]:
            raise CheckFailed(f"windows {windows}, not two of {fuse} first")
        step_ms = (marks[1] - marks[0]) / fuse * 1e3
    ips = VISION_BATCH / step_ms * 1e3
    share = RESNET50_STEP_FLOPS / (step_ms * 1e-3) / PEAK_FLOPS["bfloat16"]
    log(f"  ResNet-50 {TRAIN_ITERS} {what} at ({VISION_BATCH}, {VISION_HW}, "
        f"{VISION_HW}, 3) uint8: windows {windows}; losses "
        f"{[round(v, 4) for v in losses]}; first window (warm-up and "
        f"capture) {(marks[0] - t0) * 1e3:.1f} ms; step {step_ms:.2f} ms, "
        f"{ips:.1f} images/s, {share:.1%} of the bf16 dense peak "
        f"({RESNET50_STEP_FLOPS / 1e12:.2f} TFLOP a step); peak memory "
        f"{peak / 2**30:.2f} GiB; {wall:.2f} s in all [{card}]")
    if any(counts.values()):
        raise CheckFailed(f"the vision path launched the LM kernels "
                          f"{counts}")
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.detach().clone() for n, b in model.named_buffers()
             if "running" in n}
    if any(b.dtype != torch.float32 for b in stats.values()):
        raise CheckFailed("the running statistics are not fp32")
    prof = (profile_step(opt, next(iter(data.data(train=True))), card,
                         kinds=VISION_KINDS) if profile else None)
    run = dict(losses=losses, step_ms=step_ms, images_per_s=ips,
               bf16_peak_share=share, peak_memory_bytes=peak,
               first_window_ms=(marks[0] - t0) * 1e3, windows=windows,
               profile=prof)
    opt._step_program = None
    del opt, model, recorded, run_steps
    release()
    if not compare:
        return run, None
    ref_losses, ref = vision_eager(seen)
    ref_params = dict(ref.named_parameters())
    ref_stats = dict(ref.named_buffers())
    bitwise = losses == ref_losses and all(
        torch.equal(p, ref_params[n]) for n, p in params.items()) and all(
        torch.equal(b, ref_stats[n]) for n, b in stats.items())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    param_err = max(max_err(p, ref_params[n]) for n, p in params.items())
    stats_err = max(max_err(b, ref_stats[n]) for n, b in stats.items())
    log(f"  {what}, replayed against eager on the card: losses relative "
        f"{loss_rel:.2e}, parameters max|err| {param_err:.3e}, running "
        f"statistics max|err| {stats_err:.3e}; bitwise {bitwise}")
    if not bitwise:
        raise CheckFailed(f"ResNet-50 {what}: the replayed steps are not "
                          f"bitwise equal to the eager ones")
    run["replay_vs_eager"] = {"bitwise": bitwise, "loss_rel": loss_rel,
                              "param_max_abs_err": param_err,
                              "stats_max_abs_err": stats_err}
    return run, ref


def vision_eager(steps):
    """The recorded steps run eagerly from the same seed: the trainer's
    step function called on each batch with the host's step numbers."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer
    from bigdl_tpu_torch.optim.optim_method import hyper_tensor

    model = build_resnet50(DEVICE)
    opt = (LocalOptimizer(model, DataSet.array([]), ClassNLLCriterion(),
                          device=DEVICE)
           .set_optim_method(SGD(learningrate=0.01, momentum=0.9,
                                 dampening=0.0)))
    named, scales, mask = opt._prepare_step()
    step = opt._make_step_fn(named, scales, mask)
    losses = [float(step(inp, target, hyper_tensor(
        opt._method.hyper(k, opt._ostate), list(named.values()))))
        for k, (inp, target) in enumerate(steps)]
    torch.cuda.synchronize()
    return losses, model


def check_validation(model, card, Engine):
    """``Top1Accuracy`` and ``Top5Accuracy`` over 3 held-out batches of 256
    and a padded fourth of 100 (``valid`` < batch) through the captured
    eval program under the bf16 policy, against the same methods' host
    folds of the logits of an eager eval forward of the same batches:
    equal counts, exactly."""
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.nn.abstractnn import evaluating
    from bigdl_tpu_torch.optim.evaluator import eval_forward, run_device_eval
    from bigdl_tpu_torch.optim.validation import Top1Accuracy, Top5Accuracy

    n = 3 * VISION_BATCH + 100
    r = np.random.default_rng(SEED + 10)
    imgs = r.integers(0, 256, (n, VISION_HW, VISION_HW, 3), dtype=np.uint8)
    labels = r.integers(0, VISION_CLASSES, n).astype(np.int32)
    val = (DataSet.array(Sample(imgs[i], labels[i]) for i in range(n))
           >> SampleToMiniBatch(VISION_BATCH))
    methods = [Top1Accuracy(), Top5Accuracy()]
    Engine.init(compute_dtype=torch.bfloat16)
    try:
        t0 = time.perf_counter()
        results, stats = run_device_eval(model, val, methods, DEVICE)
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        results2, _ = run_device_eval(model, val, methods, DEVICE)
        pass2_s = time.perf_counter() - t0
        host = [None, None]
        with torch.no_grad(), evaluating(model):
            for b in val.data(train=False):
                out = eval_forward(model, torch.from_numpy(b.input).to(
                    DEVICE)).cpu()
                for i, m in enumerate(methods):
                    part = m.apply(out, b.target, b.valid)
                    host[i] = part if host[i] is None else host[i] + part
    finally:
        Engine.reset()
    got = [(r_.correct, r_.count) for r_ in results]
    want = [(h.correct, h.count) for h in host]
    log(f"  validation (bf16): Top1 {results[0].result()[0]:.4f}, Top5 "
        f"{results[1].result()[0]:.4f} over {results[0].count} images in "
        f"{stats['batches']} batches (the last padded to {VISION_BATCH} with "
        f"100 valid); fetched {stats['fetch_bytes']} bytes; the host folds "
        f"of eager logits: {want}; first pass (captures) {pass_s:.2f} s, "
        f"second {pass2_s:.2f} s [{card}]")
    if got != want or [(r_.correct, r_.count) for r_ in results2] != want \
            or results[0].count != n:
        raise CheckFailed(f"device validation {got} differs from the host "
                          f"folds {want}")
    return {"top1": results[0].result()[0], "top5": results[1].result()[0],
            "count": n, "correct": got, "fetch_bytes": stats["fetch_bytes"],
            "first_pass_s": pass_s, "second_pass_s": pass2_s}


def check_folded_inference(model, card, Engine):
    """``fuse_conv_bn`` of the trained model in eval mode against the
    unfused model at batch 256, in fp32 (TF32 off) and under the bf16
    policy, both timed. Errors are the largest log-prob difference over
    the largest log-prob magnitude (at least 1). Limits: fp32 1e-3 (the
    fold changes the order of operations of 52 conv-BN pairs: every
    bottleneck's three and the four projection shortcuts; the s2d stem is
    not a ``SpatialConvolution`` and stays unfused, as in JAX); bf16 within
    2x the unfused bf16 forward's own distance from the fp32 forward (the
    folded weights are rounded to bf16 once, the unfused path rounds the
    convolution's output before the fp32 BN)."""
    from bigdl_tpu_torch.kernels.conv_bn import FusedConvBNReLU
    from bigdl_tpu_torch.nn import fuse_conv_bn
    from bigdl_tpu_torch.nn.abstractnn import evaluating
    from bigdl_tpu_torch.optim.evaluator import eval_forward

    fused = build_resnet50(DEVICE)
    fused.load_state_dict(model.state_dict())
    fused = fuse_conv_bn(fused)
    n_fused = sum(isinstance(m, FusedConvBNReLU) for m in fused.modules())
    x = torch.from_numpy(vision_batches(1, SEED + 11)[0].input).to(DEVICE)
    out = {}
    with torch.no_grad(), evaluating(model), evaluating(fused):
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            Engine.init(compute_dtype=dtype)
            try:
                plain = eval_forward(model, x)
                folded = eval_forward(fused, x)
                ms = time_ms(lambda: eval_forward(model, x), reps=3,
                             trials=3)[0]
                fms = time_ms(lambda: eval_forward(fused, x), reps=3,
                              trials=3)[0]
            finally:
                Engine.reset()
            out[name] = {"max_abs_err": max_err(folded, plain),
                         "scale": max(1.0, float(plain.abs().max())),
                         "unfused_ms": ms, "folded_ms": fms,
                         "plain": plain}
    drift = max_err(out["bfloat16"]["plain"], out["float32"]["plain"]) \
        / out["float32"]["scale"]
    for name, c in out.items():
        c.pop("plain")
        c["rel_err"] = c["max_abs_err"] / c["scale"]
        log(f"  folded inference ({n_fused} conv-BN pairs fused), {name}: "
            f"log-probs within {c['max_abs_err']:.3e} of the unfused "
            f"model's (largest |log-prob| {c['scale']:.3g}, relative "
            f"{c['rel_err']:.2e}); {c['folded_ms']:.2f} ms against "
            f"{c['unfused_ms']:.2f} ms unfused at batch {VISION_BATCH} "
            f"[{card}]")
    out["bf16_vs_fp32_unfused_rel_err"] = drift
    log(f"  the unfused bf16 forward is {drift:.2e} (relative) from the fp32 "
        f"forward: the bf16 fold's limit is {2 * drift:.2e}")
    if n_fused != 52 or out["float32"]["rel_err"] > VISION_FOLD_FP32 \
            or out["bfloat16"]["rel_err"] > 2 * drift:
        raise CheckFailed(f"folded inference: {n_fused} pairs fused, "
                          f"errors {out}")
    return out


def run_main(main, argv, card, batch):
    """A training main on the card, its per-iteration losses read from the
    optimizer's log: the loss must fall (the mean of the last 4 below the
    mean of the first 4); images/s over the steps after the first."""
    import logging
    records = []

    class Losses(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("Epoch"):
                records.append((time.perf_counter(), record.args[2]))

    logger = logging.getLogger("bigdl_tpu_torch.optim.optimizer")
    handler, level = Losses(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        opt = main.main(argv)
        wall = time.perf_counter() - t0
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    times, losses = zip(*records)
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    ips = (len(losses) - 1) * batch / (times[-1] - times[0])
    name = main.__name__.split(".")[-2]
    log(f"  {name} main ({' '.join(argv)}): {len(losses)} steps, loss "
        f"{first:.4f} (first 4) -> {last:.4f} (last 4), Top1 "
        f"{opt.state['score']:.4f}; {ips:.0f} images/s after the first "
        f"step; {wall:.2f} s in all [{card}]")
    if not last < first:
        raise CheckFailed(f"{name}: the loss did not fall ({first} -> "
                          f"{last})")
    return {"steps": len(losses), "first_loss": first, "last_loss": last,
            "top1": opt.state["score"], "images_per_s": ips, "wall_s": wall}


def vision_path(kernels, card, Engine):
    """Phase 8: the vision path at full width, NHWC, cuDNN with its
    deterministic algorithms (autotuned in each program's eager warm-up)."""
    from bigdl_tpu_torch.models.lenet import train as lenet_main
    from bigdl_tpu_torch.models.vgg import train as vgg_main
    from bigdl_tpu_torch.nn import layout

    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = True
    layout.set_image_format("NHWC")
    try:
        step_check = check_resnet_step(layout, Engine)
        data = vision_batches(TRAIN_STEPS, SEED + 12)
        Engine.init(compute_dtype=torch.bfloat16)
        try:
            run16, trained = train_vision(data, kernels, card, bf16=True,
                                          compare=True)
            run16_fused, _ = train_vision(data, kernels, card, bf16=True,
                                          fuse=FUSE, compare=True,
                                          profile=False)
        finally:
            Engine.reset()
        run32, _ = train_vision(data, kernels, card, profile=True)
        drift = [abs(a - b) / abs(b) for a, b in
                 zip(run16["losses"], run32["losses"])]
        log(f"  bf16 against fp32 at batch {VISION_BATCH}: step "
            f"{run16['step_ms']:.2f} against {run32['step_ms']:.2f} ms "
            f"({run32['step_ms'] / run16['step_ms']:.2f}x); first loss "
            f"within {drift[0]:.2e} relative (limit {VISION_DRIFT[0]}), all "
            f"within {max(drift):.2e} (limit {VISION_DRIFT[1]}) [{card}]")
        if drift[0] > VISION_DRIFT[0] or max(drift) > VISION_DRIFT[1]:
            raise CheckFailed(f"bf16 ResNet-50 losses depart from fp32 by "
                              f"{drift}")
        drift = max(drift)
        validation = check_validation(trained, card, Engine)
        folded = check_folded_inference(trained, card, Engine)
        del trained, data
        release()
    finally:
        layout.set_image_format(None)
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
    kernels.reset_launch_counts()
    lenet = run_main(lenet_main, ["-b", "128", "--synthetic-size", "16384"],
                     card, 128)
    vgg = run_main(vgg_main, ["-b", "128", "--synthetic-size", "8192"],
                   card, 128)
    counts = kernels.launch_counts()
    if any(counts.values()):
        raise CheckFailed(f"LeNet-5 or VGG launched the LM kernels {counts}")
    return {"lm_kernel_launches": counts, "one_step_check": step_check,
            "training_bf16": {k: run16[k] for k in (
                "step_ms", "images_per_s", "bf16_peak_share",
                "peak_memory_bytes", "first_window_ms", "replay_vs_eager",
                "losses")} | {"profile": {k: (run16["profile"] or {}).get(k)
                              for k in ("busy_ms", "wall_ms", "by_kind_ms",
                                        "host_calls")}},
            "training_bf16_fused": {k: run16_fused[k] for k in (
                "step_ms", "images_per_s", "bf16_peak_share",
                "peak_memory_bytes", "first_window_ms", "replay_vs_eager")},
            "training_fp32": {k: run32[k] for k in (
                "step_ms", "images_per_s", "peak_memory_bytes",
                "first_window_ms", "losses")} | {
                "profile": {k: (run32["profile"] or {}).get(k) for k in (
                    "busy_ms", "wall_ms", "by_kind_ms", "host_calls")},
                "bf16_loss_drift": drift},
            "validation": validation, "folded_inference": folded,
            "lenet5": lenet, "vgg_cifar10": vgg}


# -------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "GPU only", file=sys.stderr)
        return 2
    try:
        import bigdl_tpu_torch
        from bigdl_tpu_torch import kernels, nn
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
    full_forward(lm, lambda: build_lm(TransformerLM, "full", "cpu"))
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
    replayed_step["profile"] = decode_kernels(
        lm, install_decode_cache, Program, card, "LayerNorm/GELU")

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

    log("phase 7: the llama-style path, full width")
    llama = llama_path(TransformerLM, lm_criterion, nn, kernels, card,
                       ServingEngine, pick_bucket, Engine)
    llama_step = llama["summary"]["training_bf16"]["step_ms"]
    llama_kernel_ms = kernel_ms_a_step(llama["counts"], rows16)
    log(f"  llama bf16 step {llama_step:.2f} ms "
        f"({llama['summary']['training_bf16']['tokens_per_s']:.0f} tokens/s) "
        f"against {run16['step_ms']:.2f} ms for the LayerNorm/GELU model's; "
        f"its flash kernels {llama_kernel_ms:.3f} ms a step at their "
        f"phase-3 times; the fused head "
        f"{llama['summary']['head']['fused_ms']:.2f} ms against "
        f"{llama['summary']['head']['unfused_ms']:.2f} ms unfused [{card}]")
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

    log("phase 8: the vision path, full width")
    vision = vision_path(kernels, card, Engine)
    log(f"  the vision path launched none of the five kernels (cuDNN "
        f"convolutions, cuBLAS for the final Linear, torch ops for batch "
        f"norm, pooling and the rest): {vision['lm_kernel_launches']}")

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
                 "training_bf16": counts16[k],
                 "llama_serving": llama["serving_counts"][k],
                 "llama_training_bf16": llama["counts"][k],
                 "vision": vision["lm_kernel_launches"][k]}
             for k in launches}
    beam_row = find_row(fa_rows, BEAM_SHAPE, "float32")

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
         "bf16_training": bf16_training("flash_attention_fwd"),
         "beam_search": {k: beam_row[k] for k in (
             "shape", "dtype", "ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by", "bound_3xtf32_ms", "err")} | {
             "launches": llama["beam_counts"]["flash_attention_fwd"]}},
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
                                                   "host_calls")}}},
        "llama": dict(llama["summary"], kernel_ms_per_step=llama_kernel_ms),
        "vision": vision}
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
