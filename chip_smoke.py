#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py          # from the repository root, on a CUDA machine

Phases, each printing its own lines; any failure raises and exits nonzero:
  1. the card's name and power limit, as nvidia-smi reports them;
  2. the kernels' build from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a),
     and ptxas's registers, spills and static shared memory for every
     redesigned kernel (K1, K2, K3, both K4 kernels, K5 in f32 and in bf16);
  3. every kernel held against its plain PyTorch version on the card, over
     the shapes of the JAX package's kernel tests and the served models'
     shapes, K2's chains off its tensor-core tiles (K0, N not a multiple
     of 8, a layer without bias), K3 at set sizes and batches on and off its
     16-row tiles, 32-row passes and 2-event blocks (deepsets-32 and -64
     widths and an odd-width chain, x aligned and not), and K4 on column
     slices and misaligned views: the INT8 kernels with torch.equal
     (global_agg's two impls also against each other), flash attention
     within the JAX tests' tolerance (2e-5 for f32, 2e-2 for bf16);
  4. the serving path through ``repro_torch.launch.serve.main`` on CUDA:
     deepsets-32 fused, jsc-m fused and jsc-m unfused, each with the launch
     counts set to 0 just before and read just after; every served output
     must equal the plain version computed on the CPU;
  4b. the fleet serving path through the same ``main``: ``--mix
     deepsets-32,jsc-m --replicas 4`` with the metrics, trace, drift gate
     (0.05) and SLO (50 ms p99 at 0.99), the same burst at ``--replicas
     1`` and both again in turn (R=4, R=1, R=1, R=4), an open-loop run at ``--replicas 4 --arrivals poisson:2000
     --admission-depth 8``, and jsc-m ``--mode unfused --replicas 4``,
     each with the launch counts set to 0 just before and read just after;
     each run builds a fresh fleet, every replica must have served a batch
     on a CUDA stream of its own, every gathered output must equal the
     plain version computed on the CPU, and admitted + shed must equal
     offered; the burst and open-loop numbers are printed per tenant, with
     the host time a served event costs in the fleet's completion observer
     (timed on synthetic requests) and in the scatter;
  5. the entry points of the kernels no model path reaches, each call with
     the launch counts set to 0 just before and read just after:
     ``global_agg`` at the paper's Table 4 shapes (both impls, both ops) and
     ``flash_mha`` at the attention width of qwen3-14b (B=1, S=4096, 40
     heads, 8 KV heads, head dim 128; f32 and bf16, causal), each output
     held against its plain version on the card;
  6. each kernel timed at the shapes of phases 4 and 5, beside its bound on
     this card, its plain version and, where one PyTorch call computes the
     same function, that call (``torch._int_mm``, ``torch.sum``,
     ``scaled_dot_product_attention``), which the port itself never calls;
     K2 beside K1's five launches of the same batch and at three chain
     depths; K3 for one event, at three phi depths, at 1, 2 and 4 events a
     block and on a misaligned x; the launch floor (a 1-element zero_());
     and SDPA's own max |err| in f32 against the plain version;
  7. the H100 latency model (``repro_torch.core.h100_model``) against the
     card: its measured constants calibrated anew (``h100_model.calibrate``:
     the launch floor, K2 at 2/5/9 layers and K3 for one event at phi
     depths 2/3/6, K1 a layer, one host-to-device copy of a served batch,
     all at 64 rows) and printed beside the values the file holds; modeled
     vs measured device time, fused (K2, or K3 for one DeepSets event) and
     per-layer (K1 a layer), for JSC-M, JSC-XL and 64^3L8 at 64 rows and
     deepsets-32/-64 one event, on the shapes ``JetServer.modeled_latency_us``
     builds, each fused output equal to its plain version; JSC-M and
     deepsets-32 are the chains the constants were fit on, the rest held
     out; and the fusion planner's groups for every realistic workload,
     each run by K2 on the card.
It then prints the ``kernels`` JSON line and, last, the device JSON line.
TF32 is off throughout, so the plain versions' f32 products are f32.

It exits nonzero, with no result, where CUDA is absent or where the rest of
the repository is not beside it. It imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12          # FP32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # bf16 tensor cores
BATCH = 64
SEED = 0
# The paper's Table 4 shapes (src/repro/core/perfmodel.py:60-65), M x F.
TABLE4_SHAPES = ((32, 32), (32, 64), (64, 32), (64, 64))
# qwen3-14b's attention (src/repro/configs/archs.py:73), one sequence.
MHA_SHAPE = dict(b=1, s=4096, h=40, kv=8, hd=128)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (BH, S, T, d, causal) off both kernels' tiles (128 queries, 64 keys; 64
# queries, 32 keys for the f32 kernel at d > 128), as in
# tests/test_torch_cuda.py.
RAGGED_FLASH = ((2, 200, 200, 64, True), (2, 130, 300, 128, False),
                (2, 300, 130, 128, True), (1, 257, 257, 256, True),
                (2, 70, 190, 256, False), (1, 77, 77, 5, True),
                (1, 100, 61, 80, False))
# The design of the kernels redesigned since their first port.
DESIGN = {
    "mm_int8": ("mma.sync m16n8k32 s8.s8.s32 (no .satfinite); 32-row tiles, "
                "128 blocks for 4096 rows; 16-byte x staging; w^T in shared "
                "memory"),
    "flash_attn_bfloat16": (
        "wgmma m64n64k16 bf16 -> f32; two warpgroups x 64 query rows, two "
        "blocks an SM; 64-key K/V tiles in a 2-stage TMA ring (mbarrier), "
        "128-byte swizzle; P from registers"),
    "flash_attn_float32": (
        "FP32 FMA; 8 warps x 16 query rows, one block an SM; 8x4 score and "
        "8x8 output register patches (hd 128); 64-key K/V tiles by cp.async "
        "through a 3-buffer mbarrier ring, refilled by the warps one tile "
        "late; P in warp-private shared memory under __syncwarp"),
    "cascade_mlp": (
        "mma.sync m16n8k32 s8.s8.s32 (no .satfinite); a warp carries 16 rows "
        "through every layer, activations in warp-private shared memory "
        "under __syncwarp; 32-row blocks, 128 for 4096 rows; weights, biases "
        "and x by cp.async, one block barrier"),
    "deepsets": (
        "mma.sync m16n8k32 s8.s8.s32 (no .satfinite); an event spans two "
        "warps, each a 16-row tile of every 32 set rows through phi under "
        "__syncwarp, meeting once at the set sum (named barrier); passes of "
        "4/2/1 n-tiles fixed at compile time, bias in the accumulators, "
        "cvt.pack.sat; set sum from the fragments (__shfl_xor over g); rho "
        "on row 0 of a tile; x staged as an event's contiguous bytes, read "
        "by funnel shift; layer records in shared memory; one block "
        "barrier"),
    "global_agg_mac": (
        "one launch on the caller's matrix (any F, row stride, alignment); "
        "8 warps a block each on an eighth of the row quads; a lane a word "
        "of 4 columns, __byte_perm 4x4 transpose, signed __dp4a against "
        "0x01010101; partials meet in shared memory; 128 columns a block"),
    "global_agg_extract_add": (
        "one launch on the caller's matrix (any F, row stride, alignment); "
        "8 warps a block each on an eighth of the rows; a lane a column, "
        "serial sign-extended adds; partials meet in shared memory; 32 "
        "columns a block"),
}
# A second, tighter bound on flash_mha in bf16 at qwen3-14b width: the max
# |err| over the query rows that see at least 64 keys, where |o| is small
# and a wrong rescale or a lost key tile would hide under FLASH_TOL. Twice
# the 3.9e-3 read there on an H100 (PERF.md).
FLASH_LATE_ROWS, FLASH_LATE_TOL = 63, {"bfloat16": 8e-3}


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True,
        timeout=60).stdout
    return out.strip().splitlines()[0]


# -- inputs --------------------------------------------------------------------

def _rand_int8(rng, shape, device, lo=-128, hi=128):
    import torch
    return torch.from_numpy(rng.integers(lo, hi, shape).astype("int8")).to(device)


def _random_deepsets(rng, f, phi_nodes, rho_nodes, m):
    import numpy as np
    from repro_torch.quant import quantize_mlp
    dims = [f] + list(phi_nodes)
    pw = [rng.normal(0, 0.4, (dims[i], dims[i + 1])) for i in range(len(dims) - 1)]
    pb = [rng.normal(0, 0.1, (d,)) for d in dims[1:]]
    xs = rng.normal(0, 1, (m, f))
    phi = quantize_mlp(pw, pb, [True] * len(pw), xs)
    h = xs
    for w, b in zip(pw, pb):
        h = np.maximum(h @ w + b, 0)
    rdims = [dims[-1]] + list(rho_nodes)
    rw = [rng.normal(0, 0.3, (rdims[i], rdims[i + 1])) for i in range(len(rdims) - 1)]
    rb = [rng.normal(0, 0.1, (d,)) for d in rdims[1:]]
    rho = quantize_mlp(rw, rb, [True] * (len(rw) - 1) + [False],
                       h.mean(0, keepdims=True))
    return phi, rho


# -- phase 2: the build -------------------------------------------------------

def ptxas_report(names=("flash_attn_bf16_kernel", "flash_attn_kernel",
                        "mm_int8_kernel", "cascade_mlp_kernel",
                        "deepsets_kernel", "global_agg_mac_kernel",
                        "global_agg_extract_add_kernel")) -> dict:
    """Registers, spills and static shared memory that ptxas reported (the
    build's ``-Xptxas=-v`` log) for every instantiation of the kernels
    named."""
    import re
    from repro_torch.kernels import _build
    log = (_build.BUILD_ROOT / _build.source_hash() / "build.log").read_text()
    out, cur = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            name = next((n for n in names if n in mangled), None)
            # Template arguments follow the name as I L<type><value>E ... E.
            args = re.match(r"I((?:L[a-z]\d+E)+)E",
                            mangled.split(name, 1)[1]) if name else None
            cur = None if name is None else (
                name + "<" + ",".join(re.findall(r"L[a-z](\d+)E",
                                                 args.group(1))) + ">"
                if args else name)
            continue
        if cur is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            out.setdefault(cur, {}).update(spill_stores=int(spill.group(1)),
                                           spill_loads=int(spill.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(cur, {}).update(
                registers=int(used.group(1)),
                static_smem_bytes=int(smem.group(1)) if smem else 0)
    return out


# -- phase 3: kernels against their plain versions -------------------------------

def _diff(a, b) -> float:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
                             f"{tuple(b.shape)} {b.dtype}")
    if torch.equal(a, b):
        return 0.0
    err = float((a.to(torch.int64) - b.to(torch.int64)).abs().max())
    raise AssertionError(f"kernel differs from its plain version, max |err| "
                         f"{err}")


def check_kernels(dev) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.core.h100_model import random_qmlp
    from repro_torch.kernels.cascade_mlp import (cascade_mlp, cascade_mlp_ref,
                                                 deepsets, deepsets_ref,
                                                 mlp_unfused)
    from repro_torch.kernels.mm_int8 import mm_int8, mm_int8_ref
    err = {"mm_int8": 0.0, "cascade_mlp": 0.0, "deepsets": 0.0}
    n_cases = dict.fromkeys(err, 0)

    rng = np.random.default_rng(SEED)
    grid = itertools.product([1, 7, 8, 32, 64, 100, 128, 4096],
                             [5, 16, 21, 32, 64, 130],
                             [5, 10, 32, 64, 128, 200])
    for i, (m, k, n) in enumerate(grid):
        x, w = _rand_int8(rng, (m, k), dev), _rand_int8(rng, (k, n), dev)
        b = (_rand_int8(rng, (n,), dev).to(torch.int32) * 40
             if i % 2 == 0 else None)
        kw = dict(shift=(0, 3, 7)[i % 3], relu=(i // 2) % 2 == 1)
        for out_int8 in ((True, False) if i % 5 == 0 else (True,)):
            err["mm_int8"] = max(err["mm_int8"], _diff(
                mm_int8(x, w, b, out_int8=out_int8, **kw),
                mm_int8_ref(x, w, b, out_int8=out_int8, **kw)))
            n_cases["mm_int8"] += 1
    sat = mm_int8(torch.full((8, 128), 127, dtype=torch.int8, device=dev),
                  torch.full((128, 8), 127, dtype=torch.int8, device=dev))
    if int(sat.max()) != 127 or int(sat.min()) != 127:
        raise AssertionError("mm_int8 does not saturate")

    chains = [[16, 64, 32, 32, 32, 5], [16, 128, 64, 64, 64, 5]]
    for depth in range(2, 7):
        chains.append([int(rng.choice([16, 21, 32, 64]))]
                      + [int(rng.choice([32, 64, 128])) for _ in range(depth - 1)]
                      + [5])
    # Off K2's tiles: K0 of 5 and 130, N not a multiple of 8 mid-chain.
    chains += [[5, 64, 32, 5], [130, 200, 64, 10], [16, 20, 13, 37, 70, 5]]
    qs = [random_qmlp(rng, dims) for dims in chains]
    # and jsc-m's chain with its second layer's bias dropped
    qs.append(dataclasses.replace(qs[0], layers=tuple(
        dataclasses.replace(l, bias_q=None) if i == 1 else l
        for i, l in enumerate(qs[0].layers))))
    for q in qs:
        q, k0 = q.to(dev), q.layers[0].w_q.shape[0]
        for rows in (1, 7, 17, 64, 100, BATCH * 64, BATCH * 64 + 1):
            x = _rand_int8(rng, (rows, k0), dev)
            want = cascade_mlp_ref(x, q)
            err["cascade_mlp"] = max(err["cascade_mlp"],
                                     _diff(cascade_mlp(x, q), want))
            err["mm_int8"] = max(err["mm_int8"], _diff(mlp_unfused(x, q), want))
            n_cases["cascade_mlp"] += 1

    # K3: deepsets-32 and deepsets-64 widths, and a chain with widths that
    # are no multiple of 8 and a phi layer without bias; set sizes on and off
    # the 16-row tiles and 32-row passes, batches on and off 2-event blocks.
    for i, (nodes, no_bias) in enumerate(((([32, 32, 32], [32, 10]), ()),
                                          (([64, 64, 64], [64, 10]), ()),
                                          (([20, 13, 37], [10]), (1,)))):
        phi, rho = _random_deepsets(rng, 21, *nodes, 32)
        phi = dataclasses.replace(phi, layers=tuple(
            dataclasses.replace(l, bias_q=None) if j in no_bias else l
            for j, l in enumerate(phi.layers)))
        phi, rho = phi.to(dev), rho.to(dev)
        for j, (m, b) in enumerate(itertools.product(
                (1, 7, 15, 16, 17, 32, 33, 64, 200), (1, 3, BATCH, BATCH + 1))):
            agg = ("mean", "sum")[(i + j) % 2]
            x = _rand_int8(rng, (b, m, 21), dev, -40, 40)
            if j % 9 == 0:      # a view one byte past an alignment
                x = _rand_int8(rng, (1 + x.numel(),), dev, -40, 40)[1:].view(
                    b, m, 21)
            mp = 1 << (m - 1).bit_length()
            want = deepsets_ref(F.pad(x, (0, 0, 0, mp - m)), phi, rho, agg=agg)
            err["deepsets"] = max(err["deepsets"],
                                  _diff(deepsets(x, phi, rho, agg=agg), want))
            n_cases["deepsets"] += 1
    for name in err:
        print(f"[check] {name}: {n_cases[name]} cases equal to the plain "
              f"version on the card (max |err| {err[name]})")
    err.update(check_global_agg(dev, rng))
    err.update(check_flash(dev, rng))
    return err


def check_global_agg(dev, rng) -> dict:
    """tests/test_kernels.py:109-112's grid, plus M that are no power of two,
    x op x impl, then column slices of a 160-wide matrix (row stride not F,
    on and off a word) and views one byte past an alignment; every result
    equal to the plain version and mac equal to extract_add."""
    import torch.nn.functional as F
    from repro_torch.kernels.global_agg import global_agg, global_agg_ref
    n = 0
    inputs = [_rand_int8(rng, (m, f), dev) for m, f in itertools.product(
        [1, 3, 4, 7, 8, 16, 32, 64, 100], [5, 32, 40, 64, 130])]
    for m, (c0, c1) in itertools.product((1, 7, 64, 100),
                                         ((8, 40), (3, 67), (0, 64), (4, 5))):
        inputs.append(_rand_int8(rng, (m, 160), dev)[:, c0:c1])
    for m, f in ((8, 128), (64, 64), (33, 21)):
        inputs.append(_rand_int8(rng, (1 + m * f,), dev)[1:].view(m, f))
    for x in inputs:
        m = x.shape[0]
        for op in ("sum", "mean"):
            mp = 1 << (m - 1).bit_length() if op == "mean" else m
            want = global_agg_ref(F.pad(x, (0, 0, 0, mp - m)), op=op)
            mac = global_agg(x, op=op, impl="mac")
            _diff(mac, want)
            _diff(global_agg(x, op=op, impl="extract_add"), mac)
            n += 1
    print(f"[check] global_agg: {n} cases (column slices and misaligned "
          f"views among them), mac and extract_add each equal to the plain "
          f"version on the card (max |err| 0.0)")
    return {"global_agg": 0.0}


def _close(got, want, tol: float) -> float:
    """Max |got - want| in f32; raises beyond atol = rtol = ``tol``."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("the kernel's output is not finite")
    diff = (g - w).abs()
    if bool((diff > tol + tol * w.abs()).any()):
        raise AssertionError(f"kernel differs from its plain version beyond "
                             f"{tol}: max |err| {float(diff.max())}")
    return float(diff.max())


def _normal(rng, shape, dev, dtype):
    import torch
    return torch.from_numpy(rng.normal(0, 1, shape).astype("float32")).to(
        dev, getattr(torch, dtype))


def _heads(x, b, h, s, hd):
    """(B, S, H, hd) -> (B*H, S, hd), contiguous."""
    return x.transpose(1, 2).reshape(b * h, s, hd).contiguous()


def mha_plain(q, k, v):
    """flash_mha's plain version: the GQA repeat and the (B*H, S, hd)
    layout around flash_attention_ref, on the tensors' own device."""
    from repro_torch.kernels.flash_attn import flash_attention_ref
    b, s, h, hd = q.shape
    n_rep = h // k.shape[2]
    kr, vr = (t.repeat_interleave(n_rep, dim=2) for t in (k, v))
    out = flash_attention_ref(*(_heads(t, b, h, s, hd) for t in (q, kr, vr)))
    return out.reshape(b, h, s, hd).transpose(1, 2).reshape(b, s, h * hd)


def check_flash(dev, rng) -> dict:
    """tests/test_flash_attn.py:23-28's (BH, S, d, bq, bk) list x {f32, bf16}
    (causal), non-causal once, the ragged shapes of RAGGED_FLASH in both,
    and flash_mha at S in {96, 200, 256} with 1, 2 and 4 KV heads in f32
    and bf16."""
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attention_ref, flash_mha)
    err = {f"flash_attn_{dt}": 0.0 for dt in FLASH_TOL}
    n = dict.fromkeys(FLASH_TOL, 0)
    cases = [(dt, (bh, s, s, d, bq, bk), True) for dt in FLASH_TOL
             for bh, s, d, bq, bk in ((4, 256, 64, 128, 128),
                                      (2, 512, 128, 128, 128),
                                      (1, 128, 64, 64, 64),
                                      (3, 384, 128, 128, 64))]
    cases.append(("float32", (2, 256, 256, 64, 128, 128), False))
    cases += [(dt, (bh, s, t, d, s, t), causal) for dt in FLASH_TOL
              for bh, s, t, d, causal in RAGGED_FLASH]
    for dt, (bh, s, t, d, bq, bk), causal in cases:
        q = _normal(rng, (bh, s, d), dev, dt)
        k, v = (_normal(rng, (bh, t, d), dev, dt) for _ in range(2))
        e = _close(flash_attention(q, k, v, causal=causal, block_q=bq,
                                   block_k=bk),
                   flash_attention_ref(q, k, v, causal=causal), FLASH_TOL[dt])
        err[f"flash_attn_{dt}"] = max(err[f"flash_attn_{dt}"], e)
        n[dt] += 1
    for dt, s, kv in itertools.product(FLASH_TOL, (96, 200, 256), (1, 2, 4)):
        q = _normal(rng, (2, s, 8, 64), dev, dt)
        k, v = (_normal(rng, (2, s, kv, 64), dev, dt) for _ in range(2))
        e = _close(flash_mha(q, k, v, block_q=64, block_k=64),
                   mha_plain(q, k, v), FLASH_TOL[dt])
        err[f"flash_attn_{dt}"] = max(err[f"flash_attn_{dt}"], e)
        n[dt] += 1
    for dt in FLASH_TOL:
        print(f"[check] flash_attn {dt}: {n[dt]} cases within {FLASH_TOL[dt]} "
              f"of the plain version on the card (max |err| "
              f"{err[f'flash_attn_{dt}']:.3e})")
    return err


# -- phase 4: the serving path ---------------------------------------------------

def _plain(run: dict, idx=None):
    """The plain version on the CPU of a tenant's served events."""
    import torch
    from repro_torch.kernels.cascade_mlp import cascade_mlp, deepsets
    xq = run["xq"] if idx is None else run["xq"][idx]
    x, q = torch.from_numpy(xq), run["qmlp"].to("cpu")
    if run["rho"] is not None:
        return deepsets(x, q, run["rho"].to("cpu")).numpy()
    b, m, f = x.shape
    return cascade_mlp(x.reshape(b * m, f), q).reshape(b, m, -1).numpy()


def drive_serving() -> dict:
    import numpy as np
    from repro_torch.kernels import launches
    from repro_torch.launch import serve

    runs = {}
    for name, argv, kernel in (
            ("deepsets-32 fused", ["--model", "deepsets-32", "--mode", "fused",
                                   "--events", "256", "--train-steps", "100"],
             "deepsets"),
            ("jsc-m fused", ["--model", "jsc-m", "--mode", "fused",
                             "--events", "128", "--train-steps", "100"],
             "cascade_mlp"),
            ("jsc-m unfused", ["--model", "jsc-m", "--mode", "unfused",
                               "--events", "128", "--train-steps", "100"],
             "mm_int8")):
        launches.reset()
        rep = serve.main(argv + ["--device", "cuda", "--seed", str(SEED)])
        counts = launches.snapshot()
        print(f"[serve] {name}: launches {counts}")
        if counts.get(kernel, 0) == 0:
            raise AssertionError(f"{name}: the {kernel} kernel never launched")
        if rep["burst_max_batch"] < 2:
            raise AssertionError(f"{name}: the burst was never batched")
        if not np.array_equal(rep["outputs"], _plain(rep)):
            raise AssertionError(f"{name}: served outputs differ from the "
                                 "plain version on the CPU")
        print(f"[serve] {name}: {len(rep['outputs'])} served outputs equal to "
              f"the CPU plain version; p50 {rep['p50_us']:.1f} us, p99 "
              f"{rep['p99_us']:.1f} us (p50 wait {rep['queue_wait_p50_us']:.1f} "
              f"us = dequeue {rep['dequeue_p50_us']:.1f} us + window "
              f"{rep['window_p50_us']:.1f} us, p50 service "
              f"{rep['service_p50_us']:.1f} us), "
              f"{rep['events_per_s']:.0f} events/s one at a time, "
              f"{rep['burst_events_per_s']:.0f} events/s in a burst (largest "
              f"batch {rep['burst_max_batch']})")
        runs[name] = dict(rep, launches=counts)
    f_out, u_out = runs["jsc-m fused"]["outputs"], runs["jsc-m unfused"]["outputs"]
    if not np.array_equal(f_out, u_out):
        raise AssertionError("jsc-m fused and unfused outputs differ")
    print("[serve] jsc-m fused and unfused outputs are equal")
    return runs


# -- phase 4b: the fleet serving path ---------------------------------------------

FLEET_MIX = ["--mix", "deepsets-32,jsc-m", "--events", "256",
             "--train-steps", "20"]
FLEET_KERNELS = {"deepsets-32": "deepsets", "jsc-m": "cascade_mlp"}
# The bursts at R=4 and R=1 in turn, all under the same SLO (its tracker is
# part of the per-event host work); the first also trains as phase 4 does,
# writes the metrics and the trace and holds the drift gate. The others
# train 20 steps: what they measure does not depend on the weights.
FLEET_BURST = FLEET_MIX + ["--slo", "50000:0.99"]
# name -> (argv, kernel each tenant must launch)
FLEET_RUNS = {
    "fleet R=4": (FLEET_BURST + ["--replicas", "4", "--drift-gate", "0.05",
                                 "--train-steps", "100"], FLEET_KERNELS),
    "fleet R=1": (FLEET_BURST + ["--replicas", "1"], FLEET_KERNELS),
    "fleet R=1 again": (FLEET_BURST + ["--replicas", "1"], FLEET_KERNELS),
    "fleet R=4 again": (FLEET_BURST + ["--replicas", "4"], FLEET_KERNELS),
    "fleet open loop R=4": (FLEET_MIX + ["--replicas", "4", "--arrivals",
                                         "poisson:2000", "--admission-depth",
                                         "8"], FLEET_KERNELS),
    "fleet jsc-m unfused R=4": (["--model", "jsc-m", "--mode", "unfused",
                                 "--replicas", "4", "--events", "256",
                                 "--train-steps", "20"],
                                {"jsc-m": "mm_int8"}),
}


def drive_fleet() -> dict:
    import numpy as np
    from repro_torch.kernels import launches
    from repro_torch.launch import serve

    out_dir = ROOT / "build" / "fleet"
    out_dir.mkdir(parents=True, exist_ok=True)
    files = ["--metrics-out", str(out_dir / "fleet_metrics.json"),
             "--trace-out", str(out_dir / "fleet_trace.json")]
    runs = {}
    for name, (argv, kernels) in FLEET_RUNS.items():
        extra = files if name == "fleet R=4" else []
        t0 = time.perf_counter()
        launches.reset()
        rep = serve.main(argv + extra + ["--device", "cuda", "--seed",
                                         str(SEED)])
        counts = launches.snapshot()
        wall = time.perf_counter() - t0
        print(f"[fleet] {name}: launches {counts} ({wall:.1f} s, training "
              f"included)")
        streams = []
        for tenant, run in rep["tenants"].items():
            if counts.get(kernels[tenant], 0) == 0:
                raise AssertionError(f"{name}: {tenant}'s {kernels[tenant]} "
                                     "kernel never launched")
            if min(run["batches"]) < 1:
                raise AssertionError(f"{name}: a {tenant} replica served no "
                                     f"batch: {run['batches']}")
            for s, used in zip(run["streams"], run["launch_streams"]):
                if s is None or used != [s]:
                    raise AssertionError(f"{name}: {tenant} replica on "
                                         f"stream {s} launched on {used}")
            streams += run["streams"]
            ol = run.get("open_loop")
            idx = None if ol is None else ol["admitted_idx"]
            if not np.array_equal(run["outputs"], _plain(run, idx)):
                raise AssertionError(f"{name}: {tenant}'s gathered outputs "
                                     "differ from the plain version on the CPU")
            if ol is not None:
                if ol["admitted"] + ol["shed"] != ol["offered"]:
                    raise AssertionError(f"{name}: {tenant}: admitted + shed "
                                         f"!= offered: {ol}")
                print(f"[fleet] {name}: {tenant}: offered {ol['offered']} "
                      f"({ol['offered_eps']:.0f}/s), admitted {ol['admitted']},"
                      f" shed {ol['shed']}, driver lag "
                      f"{ol['lag_s'] * 1e3:.3f} ms; open-loop p50 "
                      f"{ol['p50_us']:.1f} us, p99 {ol['p99_us']:.1f} us, "
                      f"queue wait p50 {ol['queue_wait_p50_us']:.1f} us, p99 "
                      f"{ol['queue_wait_p99_us']:.1f} us; batches a replica "
                      f"{run['batches']}; outputs equal to the CPU plain "
                      "version")
            else:
                b = run["batch"]
                print(f"[fleet] {name}: {tenant}: burst of {b['n']}: p50 "
                      f"{b['p50_us']:.1f} us, p99 {b['p99_us']:.1f} us, "
                      f"{b['throughput_eps']:.0f} events/s, scatter "
                      f"{b['replica_counts']}, batches a replica "
                      f"{run['batches']}; outputs equal to the CPU plain "
                      "version")
        if len(set(streams)) != len(streams):
            raise AssertionError(f"{name}: replicas share a stream: {streams}")
        if rep["slo"] is not None and not rep["slo"]["ok"]:
            raise AssertionError(f"{name}: SLO budget exhausted")
        print(f"[fleet] {name}: {len(streams)} replicas on {len(streams)} "
              "distinct CUDA streams, each of which served a batch")
        runs[name] = dict(rep, launches=counts)
    for tenant in ("deepsets-32", "jsc-m"):
        eps = {k: runs[k]["tenants"][tenant]["batch"]["throughput_eps"]
               for k in ("fleet R=4", "fleet R=1", "fleet R=1 again",
                         "fleet R=4 again")}
        r4 = (eps["fleet R=4"] + eps["fleet R=4 again"]) / 2
        r1 = (eps["fleet R=1"] + eps["fleet R=1 again"]) / 2
        print(f"[fleet] {tenant}: burst events/s R=4, R=1, R=1, R=4: "
              + ", ".join(f"{v:.0f}" for v in eps.values())
              + f"; mean R=4 / R=1 = {r4 / r1:.2f}x")
    hists = runs["fleet R=4"]["telemetry"]["metrics"]["histograms"]
    scatter = [h for h in hists if h["name"] == "fleet.dispatch.overhead_us"]
    print(f"[fleet] scatter (fleet R=4): "
          f"{sum(h['sum'] for h in scatter) / 512:.2f} us an event")
    time_fleet_observer(runs["fleet R=4"]["tenants"]["jsc-m"]["qmlp"])
    return runs


def time_fleet_observer(qmlp, n: int = 2000) -> float:
    """Host time of the fleet's per-request completion observer (latency
    and queue-wait histograms, counters, the drift stream and the SLO
    tracker), which each replica's worker runs for every served event:
    ``n`` synthetic completed requests, timed on this thread."""
    from repro_torch.obs.slo import SLOSpec
    from repro_torch.serve import _Request
    from repro_torch.serve.fleet import FleetServer, TenantSpec
    fleet = FleetServer([TenantSpec(name="m", qmlp=qmlp)], device="cuda",
                        slos={"m": SLOSpec(tenant="m", availability=0.99,
                                           p99_latency_budget_ns=5e7)})
    try:
        observe = fleet._servers["m"][0].on_done
        reqs = []
        for i in range(n):
            r = _Request(x=None, t_submit=float(i))
            r.t_start, r.t_done = i + 1e-4, i + 3e-4 + i * 1e-9
            reqs.append(r)
        t0 = time.perf_counter()
        for r in reqs:
            observe(r)
        us = (time.perf_counter() - t0) / n * 1e6
    finally:
        fleet.close()
    print(f"[fleet] completion observer: {us:.2f} us an event on the "
          f"worker thread ({n} synthetic requests)")
    return us


# -- phase 5: the entry points of K4 and K5 ---------------------------------------

def _counted(fn, kernel: str):
    """Calls ``fn`` with the launch counts set to 0 just before; returns its
    result and the counts read just after, and fails if ``kernel`` never
    launched."""
    import torch
    from repro_torch.kernels import launches
    launches.reset()
    out = fn()
    counts = launches.snapshot()
    torch.cuda.synchronize()
    if counts.get(kernel, 0) == 0:
        raise AssertionError(f"the {kernel} kernel never launched")
    return out, counts


def _where_err(got, want, dt: str) -> str:
    """Where the largest |got - want| of a (B, S, H*hd) attention output
    lies (its query row, and |want| there), the mean |err|, and the largest
    error over the rows that see at least 64 keys, held to FLASH_LATE_TOL."""
    diff = (got.float() - want.float()).abs()
    i = int(diff.argmax())
    row = (i // diff.shape[2]) % diff.shape[1]
    late = float(diff[:, FLASH_LATE_ROWS:].max())
    tol = FLASH_LATE_TOL.get(dt, FLASH_TOL[dt])
    if late > tol:
        raise AssertionError(f"max |err| {late:.3e} over rows >= "
                             f"{FLASH_LATE_ROWS} exceeds {tol}")
    return (f"largest at query row {row} where |want| = "
            f"{float(want.flatten()[i].float().abs()):.4f}; mean |err| "
            f"{float(diff.mean()):.3e}; max |err| over rows >= "
            f"{FLASH_LATE_ROWS} {late:.3e} (tolerance {tol})")


def drive_entry_points(dev, err: dict) -> dict:
    """Phase 5; folds the flash outputs' max |err| into ``err``."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attn import flash_mha
    from repro_torch.kernels.global_agg import global_agg, global_agg_ref

    rng = np.random.default_rng(SEED + 2)
    paths = {"inputs": {}}
    for m, f in TABLE4_SHAPES:
        x = _rand_int8(rng, (m, f), dev)
        paths["inputs"][(m, f)] = x
        for impl, op in itertools.product(("mac", "extract_add"),
                                          ("sum", "mean")):
            name = f"global_agg_{impl}"
            out, counts = _counted(lambda: global_agg(x, op=op, impl=impl),
                                   name)
            _diff(out, global_agg_ref(x, op=op))
            paths[name] = paths.get(name, 0) + counts[name]
            print(f"[path] global_agg {m}x{f} op={op} impl={impl}: launches "
                  f"{counts}, equal to the plain version")

    c = MHA_SHAPE
    for dt in FLASH_TOL:
        q = _normal(rng, (c["b"], c["s"], c["h"], c["hd"]), dev, dt)
        k, v = (_normal(rng, (c["b"], c["s"], c["kv"], c["hd"]), dev, dt)
                for _ in range(2))
        out, counts = _counted(lambda: flash_mha(q, k, v), "flash_attn")
        if out.shape != (c["b"], c["s"], c["h"] * c["hd"]) or out.dtype != q.dtype:
            raise AssertionError(f"flash_mha gave {tuple(out.shape)} {out.dtype}")
        want = mha_plain(q, k, v)
        e = _close(out, want, FLASH_TOL[dt])
        err[f"flash_attn_{dt}"] = max(err[f"flash_attn_{dt}"], e)
        paths[f"flash_attn_{dt}"] = counts["flash_attn"]
        paths["inputs"][dt] = (q, k, v)
        print(f"[path] flash_mha qwen3-14b width {c} {dt}, causal: launches "
              f"{counts}, output {tuple(out.shape)} finite, max |err| "
              f"{e:.3e} against the plain version (tolerance "
              f"{FLASH_TOL[dt]}); {_where_err(out, want, dt)}")
        del want
        del out
        torch.cuda.empty_cache()
    return paths


# -- phase 6: timing -------------------------------------------------------------

def _time_ms(fn, iters: int = 200, warmup: int = 10, graph: bool = True) -> dict:
    """Per-call time of ``fn``: eager (CUDA events around back-to-back calls,
    so host overhead shows when it exceeds the device time) and device
    (the same calls captured once in a CUDA graph and replayed). Without
    ``graph``, for calls of milliseconds, the device time is the eager one."""
    import torch
    from repro_torch.core.h100_model import graph_time_s
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    eager = start.elapsed_time(end) / iters
    if not graph:
        return {"ms": eager, "eager_ms": eager}
    return {"ms": graph_time_s(fn, iters) * 1e3, "eager_ms": eager}


def _bound(nbytes: float, ops: float, ops_per_s: float = INT8_OPS_PER_S) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def _chain_work(q, rows: int):
    """Bytes of weights+biases and int8 ops of one chain over ``rows`` rows."""
    wb = sum(l.w_q.numel() + (4 * l.bias_q.numel() if l.bias_q is not None else 0)
             for l in q.layers)
    ops = sum(2 * rows * l.w_q.shape[0] * l.w_q.shape[1] for l in q.layers)
    return wb, ops


def time_launch_floor(dev) -> float:
    """The device time of a 1-element zero_() in a CUDA graph of 200 calls:
    the yardstick for K2-K4's microseconds, which the port never calls."""
    import torch
    z = torch.zeros(1, device=dev)
    t = _time_ms(lambda: z.zero_())["ms"]
    print(f"[time] launch floor: a 1-element zero_() in a CUDA graph of 200 "
          f"calls takes {t * 1e3:.3f} us a call")
    return t


def time_global_agg(paths: dict, err: dict) -> list:
    """K4, each impl at every Table 4 shape ('sum'): the kernel launched on
    the caller's unpadded input (``ms``) and the wrapper's call
    (``call_ms``), the same single launch. The kernels line takes 64x64,
    deepsets-64's phi output."""
    import torch
    from repro_torch.kernels.global_agg import global_agg, global_agg_ref, ops
    out = []
    for impl in ("mac", "extract_add"):
        table = {}
        for m, f in TABLE4_SHAPES:
            x = paths["inputs"][(m, f)]
            kt = _time_ms(lambda: ops._launch(x, "sum", impl, m))
            ct = _time_ms(lambda: global_agg(x, op="sum", impl=impl))
            table[f"{m}x{f}"] = {"ms": kt["ms"], "call_ms": ct["ms"],
                                 "call_eager_ms": ct["eager_ms"]}
            print(f"[time] global_agg impl={impl} {m}x{f} sum: kernel_ms "
                  f"{kt['ms']:.6f}, call_ms {ct['ms']:.6f} (eager "
                  f"{ct['eager_ms']:.6f})")
        x = paths["inputs"][(64, 64)]
        pt = _time_ms(lambda: global_agg_ref(x, op="sum"))
        lt = _time_ms(lambda: torch.sum(x, 0, dtype=torch.int32))
        t = table["64x64"]
        out.append(dict(name=f"global_agg_{impl}", route="cuda",
                        source="src/repro_torch/kernels/csrc/global_agg.cu",
                        replaces="src/repro/kernels/global_agg/global_agg.py:57",
                        launches=paths[f"global_agg_{impl}"],
                        max_abs_err=err["global_agg"], ms=t["ms"],
                        eager_ms=t["call_eager_ms"], call_ms=t["call_ms"],
                        plain_ms=pt["ms"], library_ms=lt["ms"],
                        **_bound(x.numel() + 4 * 64, 0),
                        shape="64x64 int8, op=sum", table4=table))
    return out


def time_flash(paths: dict, err: dict) -> list:
    """K5 at the qwen3-14b width of phase 5, on the (B*H, S, hd) tensors
    flash_mha hands the kernel; the library call is SDPA on the same."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attention_ref)
    c = MHA_SHAPE
    b, s, h, hd = c["b"], c["s"], c["h"], c["hd"]
    out = []
    for dt, peak in (("float32", FP32_OPS_PER_S), ("bfloat16", BF16_OPS_PER_S)):
        q, k, v = paths["inputs"][dt]
        n_rep = h // c["kv"]
        qf = _heads(q, b, h, s, hd)
        kf, vf = (_heads(t.repeat_interleave(n_rep, dim=2), b, h, s, hd)
                  for t in (k, v))
        # Calls of milliseconds: host overhead is noise, so no CUDA graph.
        kt = _time_ms(lambda: flash_attention(qf, kf, vf, causal=True),
                      iters=5, warmup=1, graph=False)
        pt = _time_ms(lambda: flash_attention_ref(qf, kf, vf, causal=True),
                      iters=3, warmup=1, graph=False)
        # SDPA takes its fused backends only for (B, H, S, hd) inputs.
        q4, k4, v4 = (t.view(b, h, s, hd) for t in (qf, kf, vf))
        lt = _time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), iters=5, warmup=1, graph=False)
        # Which arithmetic the yardstick uses: SDPA's own error against the
        # plain version (f32 scores and softmax) on the same inputs.
        lib_err = float((F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True).view_as(qf).float()
            - flash_attention_ref(qf, kf, vf, causal=True).float())
            .abs().max())
        print(f"[time] flash_attn_{dt}: SDPA's own max |err| against the "
              f"plain version {lib_err:.3e} (the kernel's "
              f"{err[f'flash_attn_{dt}']:.3e})")
        nbytes = 4 * qf.numel() * qf.element_size()
        ops = 4 * hd * b * h * s * (s + 1) // 2
        out.append(dict(name=f"flash_attn_{dt}", route="cuda",
                        source="src/repro_torch/kernels/csrc/flash_attn.cu",
                        replaces="src/repro/kernels/flash_attn/flash_attn.py:70",
                        launches=paths[f"flash_attn_{dt}"],
                        max_abs_err=err[f"flash_attn_{dt}"], ms=kt["ms"],
                        eager_ms=kt["eager_ms"], plain_ms=pt["ms"],
                        library_ms=lt["ms"], library_max_abs_err=lib_err,
                        **_bound(nbytes, ops, peak),
                        tflops=ops / (kt["ms"] * 1e-3) / 1e12,
                        shape=f"qwen3-14b attention, B*H={b * h}, S=T={s}, "
                              f"hd={hd}, {dt}, causal"))
        del qf, kf, vf, q4, k4, v4
        torch.cuda.empty_cache()
    return out


def time_deepsets_shapes(dev, rng, x, phi, rho) -> dict:
    """K3 beside the served batch ``x``: one event (the card's per-event
    device time); phi at 2, 3 and 6 layers of width 32 (the cost of one
    layer); 1, 2 and 4 events a block; x one byte past an alignment (the
    byte path of the x staging). Each variant is first held against the
    plain version."""
    import torch
    from repro_torch.kernels.cascade_mlp import deepsets, deepsets_ref, ops
    one = _time_ms(lambda: deepsets(x[:1], phi, rho))["ms"]
    print(f"[time] deepsets one event (deepsets-32, B = 1, CUDA graph): "
          f"{one * 1e3:.3f} us on this card; the paper's 0.93 us for a 6-layer "
          f"DeepSets was measured on an AMD VEK280, not here")
    b, m, f = x.shape
    depth = {}
    for d in (2, 3, 6):
        pd, rd = (q.to(dev) for q in _random_deepsets(rng, f, [32] * d,
                                                      [32, 10], m))
        _diff(deepsets(x, pd, rd), deepsets_ref(x, pd, rd))
        depth[d] = _time_ms(lambda: deepsets(x, pd, rd))["ms"]
    layer = (depth[6] - depth[3]) / 3
    print(f"[time] deepsets by phi depth, {b} events x {m} x {f}, rho 32-10: "
          + ", ".join(f"{d} layers {t * 1e3:.3f} us" for d, t in depth.items())
          + f"; {layer * 1e3:.3f} us a 32-wide phi layer")
    split = {}
    for e in (1, 2, 4):
        saved, ops.EVENTS_PER_BLOCK = ops.EVENTS_PER_BLOCK, e
        try:
            _diff(deepsets(x, phi, rho), deepsets_ref(x, phi, rho))
            split[e] = _time_ms(lambda: deepsets(x, phi, rho))["ms"]
        finally:
            ops.EVENTS_PER_BLOCK = saved
    print(f"[time] deepsets by events a block, {b} events: " + ", ".join(
        f"{e} {t * 1e3:.3f} us" for e, t in split.items()))
    xm = torch.empty(1 + x.numel(), dtype=x.dtype, device=dev)[1:].view_as(x)
    xm.copy_(x)
    _diff(deepsets(xm, phi, rho), deepsets_ref(x, phi, rho))
    byte = _time_ms(lambda: deepsets(xm, phi, rho))["ms"]
    vec = _time_ms(lambda: deepsets(x, phi, rho))["ms"]
    print(f"[time] deepsets x staging, {b} events: 16-byte cp.async (x "
          f"aligned) {vec * 1e3:.3f} us, bytes (x one byte off) "
          f"{byte * 1e3:.3f} us")
    return {"one_event_ms": one, "phi_depth_ms": depth, "phi_layer_ms": layer,
            "events_per_block_ms": split, "byte_staging_ms": byte}


def time_kernels(dev, runs: dict, err: dict, paths: dict) -> list:
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.core.h100_model import random_qmlp
    from repro_torch.kernels.cascade_mlp import (cascade_mlp, cascade_mlp_ref,
                                                 deepsets, deepsets_ref)
    from repro_torch.kernels.mm_int8 import mm_int8, mm_int8_ref

    rng = np.random.default_rng(SEED + 1)
    out = []

    # K1: the per-layer launches of one served jsc-m batch (B*M rows).
    q = runs["jsc-m unfused"]["qmlp"].to(dev)
    rows = BATCH * 64
    a = torch.from_numpy(runs["jsc-m unfused"]["xq"][:BATCH].reshape(rows, -1)).to(dev)
    layers = []
    for l in q.layers:
        layers.append((a, l))
        a = mm_int8_ref(a, l.w_q, l.bias_q, shift=l.shift, relu=l.relu)
    t = {"ms": 0.0, "eager_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    nbytes = ops = 0
    for x, l in layers:
        k, n = l.w_q.shape
        kt = _time_ms(lambda: mm_int8(x, l.w_q, l.bias_q, shift=l.shift, relu=l.relu))
        pt = _time_ms(lambda: mm_int8_ref(x, l.w_q, l.bias_q, shift=l.shift,
                                          relu=l.relu))
        # torch._int_mm takes K and N in multiples of 8: pad (zeros are exact).
        k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
        xp = F.pad(x, (0, k8 - k)).contiguous()
        wp = F.pad(l.w_q, (0, n8 - n, 0, k8 - k)).contiguous()
        lt = _time_ms(lambda: torch._int_mm(xp, wp))
        t["ms"] += kt["ms"]
        t["eager_ms"] += kt["eager_ms"]
        t["plain_ms"] += pt["ms"]
        t["library_ms"] += lt["ms"]
        nbytes += rows * k + k * n + 4 * n + rows * n
        ops += 2 * rows * k * n
    out.append(dict(name="mm_int8", route="cuda",
                    source="src/repro_torch/kernels/csrc/mm_int8.cu",
                    replaces="src/repro/kernels/mm_int8/mm_int8.py:60",
                    launches=runs["jsc-m unfused"]["launches"].get("mm_int8", 0),
                    max_abs_err=err["mm_int8"], **t, **_bound(nbytes, ops),
                    shape=f"jsc-m, {len(layers)} layers x {rows} rows"))

    # K2: one served jsc-m batch.
    q = runs["jsc-m fused"]["qmlp"].to(dev)
    x = torch.from_numpy(runs["jsc-m fused"]["xq"][:BATCH].reshape(rows, -1)).to(dev)
    kt = _time_ms(lambda: cascade_mlp(x, q))
    pt = _time_ms(lambda: cascade_mlp_ref(x, q))
    wb, ops = _chain_work(q, rows)
    n_out = q.layers[-1].w_q.shape[1]
    out.append(dict(name="cascade_mlp", route="cuda",
                    source="src/repro_torch/kernels/csrc/cascade_mlp.cu",
                    replaces="src/repro/kernels/cascade_mlp/cascade_mlp.py:74",
                    launches=runs["jsc-m fused"]["launches"].get("cascade_mlp", 0),
                    max_abs_err=err["cascade_mlp"], ms=kt["ms"],
                    eager_ms=kt["eager_ms"], plain_ms=pt["ms"], library_ms=None,
                    **_bound(x.numel() + wb + rows * n_out, ops),
                    shape=f"jsc-m, {rows} rows"))
    k1, k2 = out
    print(f"[time] cascade_mlp (one launch) {k2['ms'] * 1e3:.3f} us vs mm_int8's "
          f"{len(layers)} launches {k1['ms'] * 1e3:.3f} us on the same jsc-m "
          f"batch: fused/unfused {k2['ms'] / k1['ms']:.3f}")
    # K2's cost a layer: jsc-m's widths at 2, 5 and 9 layers (32-wide ones
    # added in the middle), random weights, the same 4096 rows.
    depth = {}
    for dims in ([16, 64, 5], [16, 64, 32, 32, 32, 5],
                 [16, 64] + [32] * 7 + [5]):
        qd = random_qmlp(rng, dims).to(dev)
        _diff(cascade_mlp(x, qd), cascade_mlp_ref(x, qd))
        depth[len(dims) - 1] = _time_ms(lambda: cascade_mlp(x, qd))["ms"] * 1e3
    print(f"[time] cascade_mlp by depth, {rows} rows: " + ", ".join(
        f"{n} layers {t:.3f} us" for n, t in depth.items())
          + f"; {(depth[9] - depth[5]) / 4:.3f} us a 32-wide layer")

    # K3: one served deepsets-32 batch of 64 events.
    run = runs["deepsets-32 fused"]
    phi, rho = run["qmlp"].to(dev), run["rho"].to(dev)
    x = torch.from_numpy(run["xq"][:BATCH]).to(dev)
    b, m, f = x.shape
    kt = _time_ms(lambda: deepsets(x, phi, rho))
    pt = _time_ms(lambda: deepsets_ref(x, phi, rho))
    wb_phi, ops_phi = _chain_work(phi, b * m)
    wb_rho, ops_rho = _chain_work(rho, b)
    n_h, n_out = phi.layers[-1].w_q.shape[1], rho.layers[-1].w_q.shape[1]
    k3 = dict(name="deepsets", route="cuda",
              source="src/repro_torch/kernels/csrc/cascade_mlp.cu",
              replaces="src/repro/kernels/cascade_mlp/cascade_mlp.py:117",
              launches=run["launches"].get("deepsets", 0),
              max_abs_err=err["deepsets"], ms=kt["ms"],
              eager_ms=kt["eager_ms"], plain_ms=pt["ms"], library_ms=None,
              **_bound(x.numel() + wb_phi + wb_rho + b * n_out,
                       ops_phi + ops_rho + b * m * n_h),
              shape=f"deepsets-32, {b} events x {m} x {f}")
    k3.update(time_deepsets_shapes(dev, rng, x, phi, rho))
    out.append(k3)
    out += time_global_agg(paths, err)
    floor = time_launch_floor(dev)
    out += time_flash(paths, err)
    for k in out:
        if k["name"] in ("cascade_mlp", "deepsets", "global_agg_mac",
                         "global_agg_extract_add"):
            k["launch_floor_ms"] = floor
        k["bound_share"] = k["bound_ms"] / k["ms"]
        if k["name"] in DESIGN:
            k["design"] = DESIGN[k["name"]]
        print(f"[time] {k['name']} ({k['shape']}): kernel_ms {k['ms']:.6f} "
              f"(eager {k['eager_ms']:.6f}), plain_ms {k['plain_ms']:.6f}, "
              f"bound_ms {k['bound_ms']:.9f} ({k['bound_by']}), library_ms "
              f"{k['library_ms']}")
    return out


# -- phase 7: the H100 latency model against the card -----------------------------

# name -> (chain kind, widths, held out of the fit); the MLP chains of the
# JAX package's benchmarks/tpu_cascade_fusion.py at 64 rows, and the
# DeepSets models of Table 3 for one event.
MODEL_CHAINS = {
    "JSC-M": ("mlp", [16, 64, 32, 32, 32, 5], False),
    "JSC-XL": ("mlp", [16, 128, 64, 64, 64, 5], True),
    "64^3L8": ("mlp", [64] * 9, True),
    "deepsets-32": ("deepsets", (32, 21, [32, 32, 32], [32, 10]), False),
    "deepsets-64": ("deepsets", (64, 21, [64, 64, 64], [64, 10]), True),
}


def check_model(dev) -> None:
    """Phase 7; fails on a fused output that differs from its plain version
    or a planned group that K2 refuses."""
    import numpy as np
    import torch
    from repro_torch.core import h100_model
    from repro_torch.core.fusion_planner import plan, shapes_from_model
    from repro_torch.core.layerspec import REALISTIC_WORKLOADS
    from repro_torch.kernels.cascade_mlp import (cascade_mlp, cascade_mlp_ref,
                                                 deepsets, deepsets_ref,
                                                 mlp_unfused)
    from repro_torch.serve import JetServer

    cal = h100_model.calibrate(dev, seed=SEED)
    for name in h100_model.MEASURED:
        now, held = cal["constants"][name], getattr(h100_model, name)
        unit, scale = ("GB/s", 1e-9) if name.endswith("_BW") else ("us", 1e6)
        print(f"[model] {name}: measured {now * scale:.4f} {unit}, "
              f"h100_model.py holds {held * scale:.4f} {unit} (held / "
              f"measured {held / now:.3f})")
    pts = cal["points"]
    print("[model] calibration points (us): launch floor "
          f"{pts['launch_floor'] * 1e6:.4f}; K2 by layers "
          + ", ".join(f"{n}: {v * 1e6:.4f}"
                      for n, v in pts["cascade_mlp_by_layers"].items())
          + "; K3 one event by phi layers "
          + ", ".join(f"{n}: {v * 1e6:.4f}" for n, v in
                      pts["deepsets_one_event_by_phi_layers"].items())
          + "; K1 by layer " + ", ".join(f"{v * 1e6:.4f}"
                                         for v in pts["mm_int8_by_layer"])
          + f"; H2D of {pts['h2d_batch_bytes']} bytes "
            f"{pts['h2d_batch'] * 1e6:.4f}")

    rng = np.random.default_rng(SEED + 3)
    for name, (kind, spec, held_out) in MODEL_CHAINS.items():
        if kind == "mlp":
            q = h100_model.random_qmlp(rng, spec).to(dev)
            rho = None
            x = _rand_int8(rng, (64, spec[0]), dev)
            fused = lambda: cascade_mlp(x, q)
            exact = torch.equal(fused(), cascade_mlp_ref(x, q))
            unfused_s = h100_model.graph_time_s(lambda: mlp_unfused(x, q))
        else:
            m, f, phi_w, rho_w = spec
            q = h100_model.random_qmlp(rng, [f] + phi_w, relu_last=True).to(dev)
            rho = h100_model.random_qmlp(rng, [phi_w[-1]] + rho_w).to(dev)
            x = _rand_int8(rng, (1, m, f), dev)
            fused = lambda: deepsets(x, q, rho)
            exact = torch.equal(fused(), deepsets_ref(x, q, rho))
            unfused_s = None
        if not exact:
            raise AssertionError(f"{name}: the fused kernel differs from its "
                                 "plain version")
        fused_s = h100_model.graph_time_s(fused)
        server = JetServer(q, rho=rho, device=dev)
        try:
            mdl = server.modeled_latency_us()
        finally:
            server.close()
        layers = list(q.layers) + (list(rho.layers) if rho is not None else [])
        m_rows = layers[0].w_q.shape[0] if rho is not None else 64
        shapes = [h100_model.LayerShape(M=m_rows, K=l.w_q.shape[0],
                                        N=l.w_q.shape[1]) for l in layers]
        hbm = [h100_model.hbm_traffic_bytes(shapes, fused=f)
               for f in (True, False)]
        if unfused_s is None:
            unf = "none (no per-layer kernel path)"
            ratio_u = "n/a"
        else:
            unf = f"{unfused_s * 1e6:.4f} us (K1 x {len(layers)})"
            ratio_u = f"{mdl['unfused_us'] / (unfused_s * 1e6):.3f}"
        print(f"[model] {name} ({'held out' if held_out else 'in-sample'}"
              f"{', one event' if rho is not None else ', 64 rows'}): HBM "
              f"fused {hbm[0]} B / unfused {hbm[1]} B; launches 1 vs "
              f"{len(layers)}; modeled fused {mdl['fused_us']:.4f} us / "
              f"unfused {mdl['unfused_us']:.4f} us; measured fused "
              f"{fused_s * 1e6:.4f} us ({'K3' if rho is not None else 'K2'}) "
              f"/ unfused {unf}; modeled/measured fused "
              f"{mdl['fused_us'] / (fused_s * 1e6):.3f}, unfused {ratio_u}; "
              f"fused bit-exact {exact}")

    for name, fn in REALISTIC_WORKLOADS.items():
        shapes = shapes_from_model(fn())
        p = plan(shapes)
        for g in p.groups:
            dims = [shapes[g[0]].K] + [shapes[i].N for i in g]
            q = h100_model.random_qmlp(
                rng, dims, [shapes[i].bias for i in g]).to(dev)
            x = _rand_int8(rng, (64, dims[0]), dev)
            _diff(cascade_mlp(x, q), cascade_mlp_ref(x, q))
        print(f"fusion-plan {name}: {p.n_kernels} kernel(s), modeled speedup "
              f"{p.speedup:.2f}x vs per-layer; groups {list(p.groups)}, each "
              f"run by K2 on the card, equal to its plain version")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    torch.manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(_card_line())
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.library()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({_build.BUILD_ROOT / _build.source_hash()})")
    print(f"[ptxas] {json.dumps(ptxas_report())}")

    err = check_kernels(dev)
    runs = drive_serving()
    drive_fleet()
    paths = drive_entry_points(dev, err)
    kernels = time_kernels(dev, runs, err, paths)
    check_model(dev)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
