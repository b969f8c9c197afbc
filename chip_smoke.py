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
     within the JAX tests' tolerance (2e-5 for f32, 2e-2 for bf16), with a
     sliding window too (windows of 1, 63, 64 and 100 keys and wider than
     S; S and T on and off the tiles; GQA through flash_mha);
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
     and SDPA's own max |err| in f32 against the plain version; K5 bf16 at
     mixtral's layer shapes (B*H 32, S 8192, hd 128) with its window of
     4096 and without, each beside its bound and SDPA (the window as a
     boolean band mask), at minicpm3's MLA shapes (B*H 40, S 2048, the
     96-wide q/k and the zero-padded v), at recurrentgemma's local
     attention (B*H 10, S 8192, d 256, window 2048 and without) and at
     whisper's (B*H 128, d 64: the encoder, S = T = 1500 without the mask;
     the cross attention, 448 queries over 1500 keys without it; the
     decoder's causal self-attention at S = 448); K6, the MoE layer's
     grouped call, on one dispatch of a random router at
     DeepSeek-V2-Lite's benchmark layer (S 16,384, experts 0-7 of 64 held,
     top-6, d 2048, f 1408) and at mixtral-8x7b's (S 8192, top-2 of 8,
     d 4096, f 14336), each held against its plain version (the layer's
     loop over the held experts) and an f32 reference by relative RMS
     (K6_TOL, as tests/test_torch_moe_grouped_cuda.py), then timed beside
     its bound, the loop (with its host copy of the counts) and
     ``torch._grouped_mm`` (the library's grouped GEMM over the same
     device-side offsets, with the same gather and combine around it);
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
     each run by K2 on the card;
  8. the dense LM path through ``repro_torch.models.build`` at qwen3-14b's
     full width and depth (40 layers, bf16 weights, random from a seed):
     a prefill forward of 2048 tokens with the launch counts set to 0 just
     before and read just after (K5 bf16 exactly once a layer), finite f32
     logits of the full shape and a residual stream finite at every layer;
     layer 0's q/k/v through K5 and its plain version on the card (within
     FLASH_TOL); decode of the first 16 tokens from an empty cache against
     the forward's logits (within LM_DECODE_TOL, with the top-1
     agreement); and the prefill, K5's share of it and decode a token,
     each beside its bound, with the card's name and power limit;
  9. the MoE, sliding-window, MLA and M-RoPE paths through the same
     ``build``, each model at its published width with random bf16 weights
     from a seed, freed before the next, its peak memory printed, and each
     prefill forward with the launch counts set to 0 just before and read
     just after (K5 bf16 exactly once a layer, and K6, the MoE layer's
     grouped call, once a MoE layer at its widths): mixtral-8x7b cut to 16 of
     its 32 layers (a prefill of 8192 tokens, so its window of 4096 binds;
     layer 0's windowed attention through K5 against its plain version on
     one KV group; the share of expert choices dropped by capacity; decode
     of the first 16 tokens against the forward before its first dropped or
     re-routed position), minicpm3-4b whole (62 MLA layers, a prefill of
     2048; layer 0's MLA through K5 against its plain version; 16 decode
     steps), llama4-maverick one pattern group (a dense and a 128-expert
     layer with the shared expert; a prefill of 512) and qwen2-vl-72b at 2
     of 80 layers (a prefill of 2048 from the vision stub's embeds with
     three-stream positions); for mixtral and minicpm3 the prefill and
     decode a token beside their bounds, K5's and the experts' shares and
     the idle share;
  10. the recurrent and encoder-decoder paths through the same ``build``,
     each whole model at its published width with random bf16 weights
     from a seed, freed before the next, each prefill with the launch
     counts set to 0 just before and read just after: recurrentgemma-2b
     (26 layers; a prefill of 8192 tokens, so its window of 2048 binds; K5
     exactly 8 times, at d 256 with the one KV head repeated; block 2's
     windowed attention through K5 against its plain version; 16 decode
     steps into the RG-LRU states and ring caches of 2048), xlstm-350m (24
     layers; a prefill of 2048; K5 never; 16 decode steps; the mLSTM and
     sLSTM blocks' shares of the prefill) and whisper-base (6 + 6 layers;
     B = 16 stub frame tensors of 1500 frames and a prompt of 448; K5
     exactly 18 times, the encoder's and the cross attention without the
     mask; encoder layer 0's attention and decoder layer 0's cross
     attention against their plain versions; 16 decode steps); each decode
     within LM_DECODE_TOL of the forward's logits, and each prefill and
     decode a token beside its bound, with K5's share and the idle share;
  11. the training path through ``repro_torch.distributed.steps``:
     (a) recurrentgemma-2b whole at its published widths with f32 weights
     from a seed (the reference's param dtype), built with remat as
     ``launch.train`` builds it, ``make_train_step`` and AdamW as
     ``launch.train`` makes them, B = 2 x S = 2048 from
     the bigram sampler: one gradient of every leaf held finite and
     nonzero, then 4 steps with the launch counts set to 0 just before and
     read just after (K5 exactly 0 times: training runs the reference's
     attention functions under autograd), loss, ce and the grad norm
     finite at every step, the step time beside its bound (6 x params x
     tokens plus the attention's operations / 989 TFLOP/s; the weight and
     state bytes / 3.35 TB/s), the peak memory, the idle share and the top
     device ops; then ``make_prefill`` on the trained weights cast to bf16
     as serving holds them (K5 exactly 8 times, as phase 10), and K5 in
     its first attention layer at those shapes against its plain version;
     (b)
     ``repro_torch.launch.train.main`` end to end, xlstm-350m ``--full``:
     4 steps with a checkpoint at the end, then 6, which must resume from
     step 4 with exactly the (params, opt_state) run 1 saved, train on with
     finite losses and commit step 6 (the checkpoints are deleted after);
  12. the mesh (``repro_torch.launch.mesh``, ``distributed.planner``,
     ``shardctx``, ``compression``, ``launch.dryrun``) on the card:
     (a) ``make_host_mesh()`` (one rank: ``("data", "model")`` of shape
     (1, 1) on a one-rank nccl group); (b) at the end of phase 8, phase 8's
     qwen3-14b weights placed by ``params_sharding`` (wrapped as DTensors,
     not copied) and ``make_prefill(mesh=...)`` of the same tokens with the
     launch counts set to 0 just before and read just after (K5 exactly 40
     times), its logits against phase 8's (``torch.equal``: a one-rank mesh
     cuts nothing and every op runs on the same local tensors; else within
     FLASH_TOL) and its time beside phase 8's; (c) in phase 11a,
     ``compressed_psum`` over a one-rank ``pod`` group on every gradient
     leaf of recurrentgemma-2b (each element within half its scale step of
     its input, the new error equal to the input less q times the scale),
     timed beside its bound; (d) phase 11b runs with the mesh engaged
     (``launch.train`` places the weights, moments and batches on it);
     (e) ``python -m repro_torch.launch.dryrun`` for qwen3-14b
     ``train_4k`` on ``single``, mixtral-8x7b ``train_4k`` on ``multi``,
     qwen1.5-32b ``decode_32k`` on ``single``, mixtral-8x7b
     ``long_500k`` on ``multi``, and llama4-maverick ``decode_32k``,
     ``train_4k`` and ``prefill_32k`` on ``single`` (expert-parallel:
     below DRYRUN_LIMITS' bounds, 1e12 FLOP and 1e9 collective bytes a
     rank in decode, 1e12 reduce-scatter bytes and a peak of 80 GB in
     train; in prefill, where each rank attends on its own 3 of 40 heads,
     5e14 FLOP and 80 GB), seven CPU subprocesses started before
     phase 8 (no card), each record's memory a device, roofline terms and
     collectives printed (a decode record's cache must be exactly its
     share and its peak below its arguments plus its cache); (f) at the
     end of phase 8,
     ``make_decode_step`` on the same mesh with a cache placed by
     ``cache_sharding``, over phase 8's decode tokens: its logits against
     phase 8's decode (within MESH_DECODE_TOL, every row's top-1 token
     phase 8's) and its ms a token beside phase 8's; (g) in phase 9, on
     llama4's one pattern group, expert parallelism on the same one-rank
     mesh (tp = 1 divides its 128 experts: the MoE's exchange, a one-rank
     all-to-all): the unsharded decode of 16 tokens first, then the
     weights placed by ``params_sharding`` and ``make_prefill(mesh=...)``
     of phase 9's tokens (K5 exactly 2 times; logits against phase 9's,
     ``torch.equal`` or within FLASH_TOL; its dropped choices equal to
     phase 9's; the MoE layer's ms beside phase 9's), and
     ``make_decode_step`` on the mesh over the same 16 tokens, each step
     routed to the unsharded decode's experts, within MESH_DECODE_TOL of
     the unsharded decode with every row's top-1 token equal; each ms
     beside its unsharded twin.
It then prints the ``kernels`` JSON line (K5 bf16's numbers are phase 8's:
its launches in the prefill and its time at one layer's shapes, with those
of the phase-5/6 entry point under ``entry_point``, and the in-model calls
of phases 9 and 10 and their phase-6 shapes under ``paths``; its
``launches`` sums every LM prefill's count) and, last, the device JSON
line.
TF32 is off throughout, so the plain versions' f32 products are f32.

It exits nonzero, with no result, where CUDA is absent or where the rest of
the repository is not beside it. It imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
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
# (BH, S, T, d, window) with the causal mask: a window of one key, of one
# key tile less one and exactly one (64 keys), off the tiles, and wider than
# S; S and T on and off the tiles (tests/test_torch_cuda.py).
WINDOWED_FLASH = ((2, 256, 256, 64, 1), (2, 256, 256, 128, 63),
                  (2, 256, 256, 128, 64), (2, 300, 300, 128, 100),
                  (1, 200, 200, 64, 500), (2, 130, 300, 128, 64),
                  (2, 300, 130, 128, 63), (1, 257, 257, 256, 100),
                  (3, 384, 384, 96, 100), (2, 1024, 1024, 128, 300))
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


def mha_plain(q, k, v, scale=None, window=None, causal=True):
    """flash_mha's plain version: the GQA repeat and the (B*H, S, hd)
    layout around flash_attention_ref, on the tensors' own device; k/v
    (B, T, KV, hd), T != S without the causal mask."""
    from repro_torch.kernels.flash_attn import flash_attention_ref
    b, s, h, hd = q.shape
    t = k.shape[1]
    n_rep = h // k.shape[2]
    kr, vr = (x.repeat_interleave(n_rep, dim=2) for x in (k, v))
    out = flash_attention_ref(_heads(q, b, h, s, hd), _heads(kr, b, h, t, hd),
                              _heads(vr, b, h, t, hd), causal=causal,
                              scale=scale, window=window)
    return out.reshape(b, h, s, hd).transpose(1, 2).reshape(b, s, h * hd)


def check_flash(dev, rng) -> dict:
    """tests/test_flash_attn.py:23-28's (BH, S, d, bq, bk) list x {f32, bf16}
    (causal), non-causal once, the ragged shapes of RAGGED_FLASH in both,
    flash_mha at S in {96, 200, 256} with 1, 2 and 4 KV heads in f32
    and bf16, and the windows of WINDOWED_FLASH in both (and flash_mha with
    a window, mixtral's GQA ratio)."""
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
    n_win = dict.fromkeys(FLASH_TOL, 0)
    for dt, (bh, s, t, d, w) in itertools.product(FLASH_TOL, WINDOWED_FLASH):
        q = _normal(rng, (bh, s, d), dev, dt)
        k, v = (_normal(rng, (bh, t, d), dev, dt) for _ in range(2))
        e = _close(flash_attention(q, k, v, block_q=s, block_k=t, window=w),
                   flash_attention_ref(q, k, v, window=w), FLASH_TOL[dt])
        err[f"flash_attn_{dt}"] = max(err[f"flash_attn_{dt}"], e)
        n_win[dt] += 1
    for dt in FLASH_TOL:
        q = _normal(rng, (2, 600, 8, 128), dev, dt)
        k, v = (_normal(rng, (2, 600, 2, 128), dev, dt) for _ in range(2))
        e = _close(flash_mha(q, k, v, window=100),
                   mha_plain(q, k, v, window=100), FLASH_TOL[dt])
        err[f"flash_attn_{dt}"] = max(err[f"flash_attn_{dt}"], e)
        n_win[dt] += 1
    for dt in FLASH_TOL:
        print(f"[check] flash_attn {dt}: {n[dt]} cases and {n_win[dt]} with a "
              f"window within {FLASH_TOL[dt]} of the plain version on the "
              f"card (max |err| {err[f'flash_attn_{dt}']:.3e})")
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
        win = rep["serving_window"]
        print(f"[fleet] {name}: full collection before serving "
              f"{win['collect_ms']:.1f} ms (out of the bursts); while "
              f"serving: {win['full_collections']} full collections, "
              f"{win['cuda_mallocs']} cudaMalloc calls")
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


def _where_err(got, want, dt: str, scaled: bool = False) -> str:
    """Where the largest |got - want| of a (B, S, H*hd) attention output
    lies (its query row, and |want| there), the mean |err|, and the largest
    error over the rows that see at least 64 keys, held to FLASH_LATE_TOL.
    ``scaled`` (the model layers of phase 10, whose outputs reach 2 and
    more) holds each element of those rows to FLASH_LATE_TOL times its
    |want| where that exceeds 1: both sides round the output to bf16 once,
    so they may differ by an ulp of the value, which is 2^-6 at 2."""
    diff = (got.float() - want.float()).abs()
    i = int(diff.argmax())
    row = (i // diff.shape[2]) % diff.shape[1]
    late_diff = diff[:, FLASH_LATE_ROWS:]
    late = float(late_diff.max())
    tol = FLASH_LATE_TOL.get(dt, FLASH_TOL[dt])
    bound = tol
    if scaled:
        bound = tol * want[:, FLASH_LATE_ROWS:].float().abs().clamp_min(1.0)
    if bool((late_diff > bound).any()):
        j = int((late_diff - bound).argmax())
        raise AssertionError(f"max |err| {late:.3e} over rows >= "
                             f"{FLASH_LATE_ROWS} exceeds {tol} (x max(1, "
                             f"|want|): {scaled}); worst where |want| = "
                             f"{float(want[:, FLASH_LATE_ROWS:].flatten()[j]):.4f}")
    return (f"largest at query row {row} where |want| = "
            f"{float(want.flatten()[i].float().abs()):.4f}; mean |err| "
            f"{float(diff.mean()):.3e}; max |err| over rows >= "
            f"{FLASH_LATE_ROWS} {late:.3e} (tolerance {tol}"
            f"{' x max(1, |want|)' if scaled else ''})")


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


# The (B*H, S, d) q and (B*H, T, d) k/v the prefills of phases 9 and 10 hand
# K5 a layer (T = S unless given; causal unless said; v's width vd = d
# unless given):
#  * mixtral-8x7b (src/repro/configs/archs.py:34; 32 heads on 8 KV heads, hd
#    128, window 4096) at S = 8192;
#  * minicpm3-4b's MLA (:108; 40 heads, q/k 64 + 32 wide, v 64 zero-padded
#    to 96, scale 1/sqrt(96)) at S = 2048;
#  * recurrentgemma-2b's local attention (:119; 10 heads on one KV head, hd
#    256, window 2048) at S = 8192;
#  * whisper-base (:133; 8 heads, hd 64, B = 16): the encoder over 1500
#    frames and the cross attention of a 448-token prompt over them, both
#    without the mask, and the decoder's causal self-attention at S = 448.
K5_MODEL_SHAPES = {
    "mixtral-8x7b": dict(bh=32, s=8192, d=128, window=4096, vd=128),
    "minicpm3-4b": dict(bh=40, s=2048, d=96, window=None, vd=64),
    "recurrentgemma-2b": dict(bh=10, s=8192, d=256, window=2048),
    "whisper-base encoder": dict(bh=128, s=1500, d=64, causal=False),
    "whisper-base cross": dict(bh=128, s=448, t=1500, d=64, causal=False),
    "whisper-base decoder self": dict(bh=128, s=448, d=64),
}


def _visible_pairs(s: int, window=None, t=None) -> int:
    """(query, key) pairs a causal mask with ``window`` lets through; all
    s * t without the mask (``t`` given)."""
    if t is not None:
        return s * t
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def time_flash_models(dev) -> dict:
    """Phase 6, K5 bf16 at the layer shapes of phases 9 and 10
    (K5_MODEL_SHAPES): each beside its bound (2*(d + vd) operations a
    visible pair), its plain version and SDPA on the same tensors (a
    window as a boolean band mask); a windowed shape with its window and
    without, the same inputs in turn."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attention_ref)
    rng = np.random.default_rng(SEED + 6)
    out = {}
    for name, c in K5_MODEL_SHAPES.items():
        bh, s, d = c["bh"], c["s"], c["d"]
        t, vd = c.get("t", s), c.get("vd", d)
        causal, window = c.get("causal", True), c.get("window")
        q = _normal(rng, (bh, s, d), dev, "bfloat16")
        k, v = (_normal(rng, (bh, t, d), dev, "bfloat16") for _ in range(2))
        v[..., vd:] = 0
        scale = d ** -0.5
        for w in ((window, None) if window else (None,)):
            # 20 calls: the windowed / causal ratio below is a gate
            kt = _time_ms(lambda: flash_attention(
                q, k, v, causal=causal, block_q=s, block_k=t, scale=scale,
                window=w), iters=20, warmup=3, graph=False)
            pt = _time_ms(lambda: flash_attention_ref(
                q, k, v, causal=causal, scale=scale, window=w),
                iters=2, warmup=1, graph=False)
            q4, k4, v4 = (x.view(1, bh, -1, d) for x in (q, k, v))
            if w is None:
                lib = lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal, scale=scale)
            else:
                i = torch.arange(s, device=dev)
                band = ((i[None, :] <= i[:, None])
                        & (i[None, :] > i[:, None] - w))
                lib = lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=band, scale=scale)
            lt = _time_ms(lib, iters=5, warmup=1, graph=False)
            # a score dot of d and a value product of vd (MLA's v is
            # zero-padded from vd to d) a visible pair
            pairs = _visible_pairs(s, w, None if causal else t)
            ops = 2 * (d + vd) * bh * pairs
            bound = _bound((2 * s + 2 * t) * bh * d * q.element_size(), ops,
                           BF16_OPS_PER_S)
            key = f"{name} window {w}" if window else name
            mask = (f"causal, window {w}" if causal
                    else "no mask")
            out[key] = dict(ms=kt["ms"], eager_ms=kt["eager_ms"],
                            plain_ms=pt["ms"], library_ms=lt["ms"], **bound,
                            bound_share=bound["bound_ms"] / kt["ms"],
                            tflops=ops / (kt["ms"] * 1e-3) / 1e12,
                            shape=f"{name} prefill, one layer: B*H={bh}, "
                                  f"S={s}, T={t}, d={d}, bf16, {mask}")
            print(f"[time] flash_attn_bfloat16 at {key} (B*H={bh}, S={s}, "
                  f"T={t}, d={d}, {mask}): kernel_ms {kt['ms']:.4f}, "
                  f"bound_ms {bound['bound_ms']:.4f} ({bound['bound_by']}; "
                  f"{bound['bound_ms'] / kt['ms']:.3f} of it; "
                  f"{pairs * bh / 1e6:.1f} M visible pairs), plain_ms "
                  f"{pt['ms']:.3f}, SDPA {lt['ms']:.4f} ms")
        if window:
            r = (out[f"{name} window {window}"]["ms"]
                 / out[f"{name} window None"]["ms"])
            out[name + " windowed / causal"] = r
            print(f"[time] flash_attn_bfloat16 at {name}: windowed / causal "
                  f"{r:.3f} (visible pairs {_visible_pairs(s, window)} "
                  f"/ {_visible_pairs(s)} = "
                  f"{_visible_pairs(s, window) / _visible_pairs(s):.3f})")
            if r > 0.85:
                raise AssertionError(f"K5 with the window takes {r:.3f} of "
                                     f"the causal call: tiles not skipped")
        del q, k, v
        torch.cuda.empty_cache()
    return out


# K6 against its plain version (tests/test_torch_moe_grouped_cuda.py): its
# relative RMS error to an f32 reference of the held experts may pass the
# loop's by at most a quarter plus "abs", and the two outputs lie within
# "apart" relative RMS of each other.
K6_TOL = {"rel": 1.25, "abs": 1e-4, "apart": 0.01}
# (published configuration, tokens of the layer's one dispatch group)
K6_SHAPES = (("deepseek-v2-lite", 16384), ("mixtral-8x7b", 8192))


def _held_f32(p, xf, d, counts):
    """The held experts on x's rows in f32 from the same bf16 operands, g,
    u, SiLU and h rounded to bf16 as K6 and the loop round them."""
    import torch.nn.functional as F
    out = xf.float().new_zeros(xf.shape)
    bf = lambda t: t.bfloat16().float()
    start = 0
    for e, n in enumerate(counts):
        tok = d.token[start:start + n]
        xe = xf[tok].float()
        g, u = bf(xe @ p["wg"][e].float()), bf(xe @ p["wu"][e].float())
        h = bf(bf(F.silu(g)) * u)
        out.index_add_(0, tok, (h @ p["wd"][e].float())
                       * d.weight[start:start + n, None])
        start += n
    return out


def _grouped_mm_experts(p, xf, d, rows: int):
    """The held experts by the library: the ``rows`` held rows' tokens
    gathered, gate, up and down by ``torch._grouped_mm`` over the experts'
    device-side offsets, and the gate-weighted outputs added into their
    tokens in f32 (``index_add_``), rounded once. ``rows``, the held rows,
    is read on the host once, outside any timed call: the library's shapes
    need it."""
    import torch
    import torch.nn.functional as F
    offs = d.offsets[1:].to(torch.int32)
    tok = d.token[:rows]
    xs = xf[tok]
    h = (F.silu(torch._grouped_mm(xs, p["wg"], offs=offs))
         * torch._grouped_mm(xs, p["wu"], offs=offs))
    y = torch._grouped_mm(h, p["wd"], offs=offs).float()
    out = torch.zeros(xf.shape, dtype=torch.float32, device=xf.device)
    return out.index_add_(0, tok, y * d.weight[:rows, None]).to(xf.dtype)


def time_moe_grouped(dev) -> dict:
    """Phase 6, K6 at K6_SHAPES: a random router's dispatch of random bf16
    x and stacks at each published layer, K6 held to its plain version (the
    loop) by K6_TOL, then K6's call, the loop and the library's grouped
    GEMMs timed, K6's launches counted. Returns the kernels line's K6
    entry, the DeepSeek-V2-Lite layer's numbers at its top and each shape's
    under ``shapes``."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import launches
    from repro_torch.kernels.moe_grouped import moe_grouped
    from repro_torch.models import moe as M
    from repro_torch.models.transformer import _moe_cfg
    shapes = {}
    for name, S in K6_SHAPES:
        cfg = _moe_cfg(configs.get(name))
        gen = torch.Generator(device=dev).manual_seed(SEED + 35)
        p = M.moe_init(gen, cfg, dtype=torch.bfloat16, device=dev)
        x = torch.randn((1, S, cfg.d_model), generator=gen,
                        device=dev).bfloat16()
        if not M.takes_k6(p, x):
            raise AssertionError(f"{name}: its MoE layer does not take K6")
        K, xf = cfg.top_k, x.reshape(S, cfg.d_model)
        d = M.dispatch(M.moe_route(p, x, cfg), x, cfg)
        counts = M.held_counts(d)
        rows, n = sum(counts), len(counts)
        k6 = lambda: moe_grouped(xf, p["wg"], p["wu"], p["wd"], d.token,
                                 d.weight, d.counts, d.offsets, d.inverse, K)
        loop = lambda: M._experts_loop(p, xf, d, M.held_counts(d))
        lib = lambda: _grouped_mm_experts(p, xf, d, rows)
        launches.reset()
        got = k6()
        if launches.snapshot() != {"moe_grouped": 1}:
            raise AssertionError(f"{name}: K6's call launched "
                                 f"{launches.snapshot()}")
        plain = loop()
        try:
            lib_out = lib()
        except RuntimeError as e:   # no grouped GEMM for this card or build
            print(f"[time] moe_grouped at {name}: torch._grouped_mm "
                  f"refused: {str(e)[:200]}")
            lib = lib_out = None
        ref = _held_f32(p, xf, d, counts)
        rms = lambda a: float((a.float() - ref).norm() / ref.norm())
        e_k6, e_loop = rms(got), rms(plain)
        e_lib = None if lib is None else rms(lib_out)
        apart = float((got.float() - plain.float()).norm()
                      / plain.float().norm())
        if (not bool(torch.isfinite(got).all())
                or e_k6 > K6_TOL["rel"] * e_loop + K6_TOL["abs"]
                or apart > K6_TOL["apart"]):
            raise AssertionError(
                f"{name}: K6's relative RMS {e_k6:.3e} against the loop's "
                f"{e_loop:.3e}, the two {apart:.3e} apart (K6_TOL {K6_TOL})")
        del got, plain, lib_out, ref
        kt, pt = (_time_ms(fn, iters=20, warmup=3, graph=False)
                  for fn in (k6, loop))
        lt = (_time_ms(lib, iters=20, warmup=3, graph=False) if lib
              else {"ms": None})
        f, dm = cfg.d_ff, cfg.d_model
        # gate, up and down of every held row; the stacks read once, x
        # read and the output written once
        ops = 2 * rows * dm * f * 3
        bound = _bound(3 * n * dm * f * 2 + 2 * S * dm * 2, ops,
                       BF16_OPS_PER_S)
        shapes[name] = dict(
            ms=kt["ms"], plain_ms=pt["ms"], library_ms=lt["ms"], **bound,
            bound_share=bound["bound_ms"] / kt["ms"], rel_rms=e_k6,
            plain_rel_rms=e_loop, library_rel_rms=e_lib, rows=rows,
            max_over_mean=max(counts) * n / rows,
            shape=f"{name} MoE layer: S={S}, {n} held of {cfg.n_experts} "
                  f"experts, top-{K}, d={dm}, f={f}, bf16")
        print(f"[time] moe_grouped at {name} (S={S}, {n} held experts of "
              f"{cfg.n_experts}, top-{K}, d {dm}, f {f}; {rows} held rows, "
              f"busiest {max(counts) * n / rows:.3f} x the mean): "
              f"call_ms {kt['ms']:.4f}, bound_ms {bound['bound_ms']:.4f} "
              f"({bound['bound_by']}; {bound['bound_ms'] / kt['ms']:.3f} of "
              f"it), plain_ms {pt['ms']:.4f} (the loop), library_ms "
              f"{lt['ms']} (torch._grouped_mm); relative RMS to the f32 "
              f"reference: K6 {e_k6:.3e}, loop {e_loop:.3e}, library "
              f"{e_lib}; K6 and the loop {apart:.3e} apart")
        del p, x, xf, d
        torch.cuda.empty_cache()
    top = shapes[K6_SHAPES[0][0]]
    return dict(name="moe_grouped", route="cuda",
                source="src/repro_torch/kernels/csrc/moe_grouped.cu",
                replaces=None, launches=1, max_abs_err=None,
                **{k: top[k] for k in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by", "bytes",
                                       "ops", "bound_share", "shape")},
                shapes=shapes)


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


# -- phase 8: the dense LM path at qwen3-14b's full width ---------------------

# qwen3-14b (src/repro/configs/archs.py:73) at full width and depth: 40
# layers, d 5120, 40 heads, 8 KV heads, head dim 128, d_ff 17408, vocab
# 151936; bf16 weights (29.6 GB). One prompt of 2048 tokens, then decode of
# its first 16 tokens from an empty cache of 64.
LM_ARCH = "qwen3-14b"
LM_BATCH, LM_SEQ = 1, 2048
LM_CACHE, LM_DECODE = 64, 16
# Bound on decode against the forward's logits at the same positions, as
# max |diff| / max |logit|: the reference's own decode-vs-forward tolerance
# (0.06, tests/test_arch_smoke.py) taken relative to the largest logit.
# Decode casts the normalized softmax weights to bf16 and K5 bf16 packs the
# unnormalized ones, which moves every logit by about one bf16 ulp of the
# largest (0.4%) a layer that rounds apart; a wrong position, cache slot or
# mask moves them by order 1.
LM_DECODE_TOL = 0.06
# Bound on the mesh decode (phase 12f) against phase 8's decode of the same
# tokens, as max |diff| / max |logit|: the same function in another order
# (the flash-decode normalizes after the p.v product in f32, where ``_sdpa``
# rounds the softmax weights to bf16 before it). The CPU test of the mesh
# decode against the port's unsharded decode holds it to this constant
# (tests/test_torch_mesh_decode.py's MESH_TOL).
MESH_DECODE_TOL = 0.015
# A MoE decode pinned to another run's experts (``moe.routing_log``): its
# own router may choose otherwise only at a near-tie, at most MOE_MAX_FLIPS
# (token, layer, step) choices a run, each within MOE_TIE_MARGIN of its own
# probabilities (its own top-k's less the pinned experts'). Two decodes
# held within 1.5-2.5% of the largest logit of each other feed the router
# inputs that far apart, which moves a probability by up to about 1e-2
# (measured on 4 CPU ranks: 0.0111 at most, reduced llama4's mesh decode
# against the reference's picks); a misrouted token is off by order 1. The
# CPU test of the mesh decode holds its picks to the same constants
# (tests/test_torch_mesh_decode.py).
MOE_MAX_FLIPS, MOE_TIE_MARGIN = 2, 0.02


def _lm_flops(cfg, b: int, s: int) -> float:
    """Operations of one prefill: 2 a weight a token for every matmul
    (param_count() counts the embedding once: the tied LM head; its lookup
    does none), and 4*hd a visible (query, key) pair a head a layer."""
    pairs = s * (s + 1) // 2
    return (2.0 * b * s * cfg.param_count()
            + 4.0 * cfg.hd * cfg.n_heads * b * pairs * cfg.n_layers)


def _profile(fn, label: str, top: int = 6, tag: str = "lm") -> dict:
    """One traced run of ``fn`` (torch.profiler, CPU and CUDA): its wall
    time, the device's busy time (the kernels' self time, summed) and the
    kernels that take most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        print(f"[{tag}] profile {label}: the trace shows no device time")
        return {"wall_ms": wall, "busy_ms": None}
    print(f"[{tag}] profile {label}: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms (idle share {1 - busy / wall:.3f}); "
          + "; ".join(f"{ms:.3f} ms x{n} {k[:60]}" for ms, n, k in rows[:top]))
    # Kernel names cut to 80 characters: templated PyTorch kernels' names
    # run to 600, and the kernels line carries four traces.
    return {"wall_ms": wall, "busy_ms": busy,
            "top": [dict(ms=ms, count=n, name=k[:80])
                    for ms, n, k in rows[:top]]}


def drive_lm(dev, err: dict) -> dict:
    """Phase 8; fails on a K5 count other than one a layer a forward,
    logits that are not finite or of the wrong shape, K5 inside the model
    off its plain version by more than FLASH_TOL, or decode off the
    forward by more than LM_DECODE_TOL."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import launches
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attention_ref, flash_mha)
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as B
    from repro_torch.models import build
    from repro_torch.models import transformer as T

    # bf16 GEMMs reduce in f32, as the reference's XLA products do.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = configs.get(LM_ARCH)
    b, s = LM_BATCH, LM_SEQ
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[lm] {LM_ARCH} full width and depth ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv} KV, hd {cfg.hd}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}): {n_params} weights, "
          f"{w_bytes / 1e9:.3f} GB on the card (bf16 matmuls, f32 norms), "
          f"random from seed {SEED} in {init_s:.2f} s; "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated")

    rng = np.random.default_rng(SEED + 8)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    launches.reset()
    logits, aux = model(toks)
    torch.cuda.synchronize()
    counts = launches.snapshot()
    if counts != {"flash_attn": cfg.n_layers}:
        raise AssertionError(f"a prefill forward launched {counts}; want "
                             f"flash_attn x {cfg.n_layers}, one a layer")
    if (logits.shape != (b, s, cfg.vocab) or logits.dtype != torch.float32
            or not bool(torch.isfinite(logits).all()) or float(aux) != 0.0):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             f"{logits.dtype}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    print(f"[lm] prefill forward B={b} S={s}: launches {counts}; logits "
          f"{tuple(logits.shape)} f32, finite, max |logit| "
          f"{float(logits.abs().max()):.3f}")

    # The residual stream layer by layer (the same blocks, outside the
    # counted run): finite through all 40 random layers, and how it grows.
    x = B.embed(model.embedding, toks)
    grow = {}
    for i, (kind, p) in enumerate(zip(model.kinds, model.layers), 1):
        x, _ = T.block_apply(kind, p, x, cfg, None)
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"the residual stream is not finite after "
                                 f"layer {i}")
        if i in (1, 10, 20, 30, 40):
            grow[i] = float(x.float().pow(2).mean().sqrt())
    print("[lm] residual stream rms after layer " + ", ".join(
        f"{i}: {v:.3f}" for i, v in grow.items()) + " (finite at every layer)")

    # K5 inside the model: layer 0's q/k/v through flash_mha and through
    # its plain version, on the card.
    l0 = model.layers[0]
    acfg = T._attn_cfg(cfg)
    h = T._norm(cfg, l0["ln1"], B.embed(model.embedding, toks))
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    q, k, v = A._qkv(l0["attn"], h, acfg, pos)
    got = flash_mha(q, k, v)
    want = mha_plain(q, k, v)
    e = _close(got, want, FLASH_TOL["bfloat16"])
    err["flash_attn_bfloat16"] = max(err["flash_attn_bfloat16"], e)
    print(f"[lm] K5 in layer 0 (q {tuple(q.shape)}, k/v {tuple(k.shape)} "
          f"bf16): max |err| {e:.3e} against the plain version (tolerance "
          f"{FLASH_TOL['bfloat16']}); {_where_err(got, want, 'bfloat16')}")
    del got, want, h

    # Decode from an empty cache over the prompt's first tokens.
    cache = model.init_cache(b, LM_CACHE)
    launches.reset()
    dec = []
    for t in range(LM_DECODE):
        lg, cache = model.decode_step(toks[:, t:t + 1], cache)
        dec.append(lg)
    torch.cuda.synchronize()
    dec_counts = launches.snapshot()
    dec_steps = dec
    dec = torch.cat(dec, dim=1)
    full = logits[:, :LM_DECODE]
    rel = float((dec - full).abs().max() / full.abs().max())
    top1 = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    if not bool(torch.isfinite(dec).all()) or rel > LM_DECODE_TOL:
        raise AssertionError(f"decode differs from the forward's logits: "
                             f"max |diff| / max |logit| {rel:.4e} (bound "
                             f"{LM_DECODE_TOL})")
    print(f"[lm] decode of the first {LM_DECODE} tokens (cache {LM_CACHE}, "
          f"{cfg.kv_cache_dtype}) against the forward's logits: max |diff| / "
          f"max |logit| {rel:.4e} (bound {LM_DECODE_TOL}), top-1 agreement "
          f"{top1:.4f}; launches {dec_counts or 'none'} (attention over the "
          f"cache in plain PyTorch, as the reference)")
    del dec, full

    # Times, each beside its bound.
    def lm_times():
        """Prefill ms, and decode ms a token (the mean of tokens 1..15 after
        token 0 from an empty cache), with the cache left behind."""
        pre = _time_ms(lambda: model(toks), iters=3, warmup=1, graph=False)
        cache = model.init_cache(b, LM_CACHE)
        tok_iter = iter(range(LM_DECODE))

        def step():
            nonlocal cache
            t = next(tok_iter)
            _, cache = model.decode_step(toks[:, t:t + 1], cache)

        step()
        dec = _time_ms(step, iters=LM_DECODE - 1, warmup=0, graph=False)
        return pre["ms"], dec["ms"], cache

    flops = _lm_flops(cfg, b, s)
    pre_ms, dec_ms, cache = lm_times()
    pre_bound = flops / BF16_OPS_PER_S * 1e3
    # The same with cuBLAS's default (bf16 partial sums may round to bf16).
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    pre_rr, dec_rr, _ = lm_times()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    mha = _time_ms(lambda: flash_mha(q, k, v), iters=10, warmup=2,
                   graph=False)
    n_rep = cfg.n_heads // cfg.n_kv
    qf = _heads(q, b, cfg.n_heads, s, cfg.hd)
    kf, vf = (_heads(t.repeat_interleave(n_rep, dim=2), b, cfg.n_heads, s,
                     cfg.hd) for t in (k, v))
    kern = _time_ms(lambda: flash_attention(qf, kf, vf, causal=True),
                    iters=10, warmup=2, graph=False)
    plain = _time_ms(lambda: flash_attention_ref(qf, kf, vf, causal=True),
                     iters=3, warmup=1, graph=False)
    q4, k4, v4 = (t.view(b, cfg.n_heads, s, cfg.hd) for t in (qf, kf, vf))
    lib = _time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), iters=10, warmup=2, graph=False)
    k5_ops = 4 * cfg.hd * b * cfg.n_heads * s * (s + 1) // 2
    k5_bound = _bound(4 * qf.numel() * qf.element_size(), k5_ops,
                      BF16_OPS_PER_S)
    kv_bytes = sum(c.k.numel() * c.k.element_size() * 2
                   for c in cache["layers"])
    dec_bound = (w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    share = cfg.n_layers * mha["ms"] / pre_ms
    # Where the time goes: one traced prefill and four traced decode steps.
    prof_pre = _profile(lambda: model(toks), f"prefill B={b} S={s}")
    cache = model.init_cache(b, LM_CACHE)

    def four():
        nonlocal cache
        for t in range(4):
            _, cache = model.decode_step(toks[:, t:t + 1], cache)

    prof_dec = _profile(four, f"4 decode steps B={b}")
    print(f"[lm] {_card_line()}")
    print(f"[lm] prefill B={b} S={s}: {pre_ms:.3f} ms, bound "
          f"{pre_bound:.3f} ms ({flops / 1e12:.3f} TFLOP / 989 TFLOP/s bf16; "
          f"{flops / (pre_ms * 1e-3) / 1e12:.1f} TFLOP/s achieved, "
          f"{pre_bound / pre_ms:.3f} of the bound)")
    print(f"[lm] K5 in the prefill: flash_mha at the layer's shapes "
          f"{mha['ms']:.4f} ms a call (the kernel alone {kern['ms']:.4f} ms, "
          f"bound {k5_bound['bound_ms']:.4f} ms, plain version "
          f"{plain['ms']:.4f} ms, SDPA {lib['ms']:.4f} ms); x {cfg.n_layers} "
          f"layers = {cfg.n_layers * mha['ms']:.3f} ms, {share:.4f} of the "
          f"prefill")
    print(f"[lm] decode B={b}: {dec_ms:.3f} ms a token (mean of tokens "
          f"1..{LM_DECODE - 1}), bound {dec_bound:.3f} ms ({w_bytes} weight "
          f"+ {kv_bytes} cache bytes / 3.35 TB/s; {dec_bound / dec_ms:.3f} "
          f"of the bound)")
    print(f"[lm] with bf16 reduced-precision reduction allowed (cuBLAS's "
          f"default; off for every check above): prefill {pre_rr:.3f} ms, "
          f"decode {dec_rr:.3f} ms a token")
    k5 = dict(launches=counts["flash_attn"], ms=kern["ms"],
              eager_ms=kern["eager_ms"], call_ms=mha["ms"],
              plain_ms=plain["ms"], library_ms=lib["ms"], **k5_bound,
              tflops=k5_ops / (kern["ms"] * 1e-3) / 1e12,
              bound_share=k5_bound["bound_ms"] / kern["ms"],
              shape=f"{LM_ARCH} prefill, one layer: B*H={b * cfg.n_heads}, "
                    f"S=T={s}, hd={cfg.hd}, bf16, causal")
    out = dict(arch=LM_ARCH, k5=k5,
               prefill_ms=pre_ms, prefill_bound_ms=pre_bound,
               prefill_reduced_reduction_ms=pre_rr,
               prefill_tflop=flops / 1e12, k5_share=share, decode_ms=dec_ms,
               decode_reduced_reduction_ms=dec_rr,
               decode_bound_ms=dec_bound, decode_rel_err=rel,
               decode_top1=top1, weight_bytes=w_bytes, init_s=init_s,
               residual_rms=grow, profile_prefill=prof_pre,
               profile_decode=prof_dec)
    del cache, q, k, v, qf, kf, vf, q4, k4, v4
    out["mesh"] = drive_mesh_prefill(dev, model, cfg, toks, logits, pre_ms)
    out["mesh"]["decode"] = drive_mesh_decode(dev, model, cfg, toks,
                                              dec_steps, dec_ms)
    del model, logits, dec_steps
    torch.cuda.empty_cache()
    return out


# -- phase 9: the MoE, sliding-window, MLA and M-RoPE paths -------------------

# name -> (layers kept, None for all; prefill length), at the published widths
# of src/repro/configs/archs.py, bf16 weights random from SEED:
#  * mixtral-8x7b (:34): 16 of its 32 layers, 23.35 G weights, 46.7 GB (all
#    32 would be 93 GB); S = 8192, so its window of 4096 binds for the last
#    4096 queries.
#  * minicpm3-4b (:108): all 62 MLA layers, 4.07 G weights.
#  * llama4-maverick (:16): one pattern group, a dense layer and a MoE layer
#    of 128 experts with the shared expert, 17.5 G weights.
#  * qwen2-vl-72b (:146): 2 of 80 layers, 3.0 G weights, from the vision
#    stub's embeds with three-stream (M-RoPE) positions.
LM_FAMILIES = {"mixtral-8x7b": (16, 8192), "minicpm3-4b": (None, 2048),
               "llama4-maverick-400b-a17b": (2, 512),
               "qwen2-vl-72b": (2, 2048)}
def _build_lm(dev, name: str, n_layers, tag: str = "lm9"):
    """``build`` at the published width, cut to ``n_layers``; prints its
    size."""
    import torch
    from repro_torch import configs
    from repro_torch.models import build
    cfg = configs.get(name)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    n = sum(p.numel() for p in model.parameters())
    print(f"[{tag}] {name} ({cfg.n_layers} layers, pattern {cfg.pattern} + "
          f"{cfg.pattern_tail}, encoder {cfg.enc_layers}, d {cfg.d_model}, "
          f"{cfg.n_heads} heads, {cfg.n_kv} KV, hd {cfg.hd}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, experts {cfg.n_experts} top-{cfg.top_k}, "
          f"window {cfg.window}): {n} weights, {w_bytes / 1e9:.3f} GB, "
          f"random from seed {SEED} in {init_s:.2f} s")
    return cfg, model, w_bytes


def _counted_prefill(model, cfg, b: int, s: int, *, want=None, k6: int = 0,
                     tag: str = "lm9", **inputs):
    """One prefill forward with the launch counts set to 0 just before and
    read just after; fails unless K5 launched exactly ``want`` times (once
    a layer by default), K6 exactly ``k6`` times, and the logits are finite
    f32 of the full shape."""
    import torch
    from repro_torch.kernels import launches
    want = cfg.n_layers if want is None else want
    expect = {k: n for k, n in (("flash_attn", want), ("moe_grouped", k6))
              if n}
    launches.reset()
    logits, aux = model(inputs.pop("toks", None), **inputs)
    torch.cuda.synchronize()
    counts = launches.snapshot()
    if counts != expect:
        raise AssertionError(f"{cfg.name}: a prefill launched {counts}; want "
                             f"{expect}")
    if (logits.shape != (b, s, cfg.vocab) or logits.dtype != torch.float32
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{cfg.name}: prefill logits "
                             f"{tuple(logits.shape)} {logits.dtype}")
    print(f"[{tag}] {cfg.name} prefill B={b} S={s}: launches "
          f"{counts or 'none'}; logits {tuple(logits.shape)} f32, finite; "
          f"aux {float(aux):.4f}")
    return logits, {"flash_attn": counts.get("flash_attn", 0)}


def _decode(model, toks, n: int, pick=None, max_len: int = LM_CACHE):
    """Decode of the first ``n`` tokens from an empty cache of ``max_len``,
    and each MoE layer's routing in call order (step by step, the layers in
    order); with ``pick``, each MoE call routes the experts it gives
    (``moe.routing_log``)."""
    import torch
    from repro_torch.models import moe as M
    cache = model.init_cache(toks.shape[0], max_len)
    out, log = [], []
    with M.routing_log(log, pick):
        for t in range(n):
            lg, cache = model.decode_step(toks[:, t:t + 1], cache)
            out.append(lg)
    torch.cuda.synchronize()
    return torch.cat(out, dim=1), log


def _lm_times(model, toks, n: int, max_len: int = LM_CACHE) -> tuple:
    """Prefill ms, and decode ms a token (the mean of tokens 1..n-1 after
    token 0 from an empty cache of ``max_len``)."""
    pre = _time_ms(lambda: model(toks), iters=2, warmup=1, graph=False)
    cache = model.init_cache(toks.shape[0], max_len)
    steps = iter(range(n))

    def step():
        nonlocal cache
        t = next(steps)
        _, cache = model.decode_step(toks[:, t:t + 1], cache)

    step()
    dec = _time_ms(step, iters=n - 1, warmup=0, graph=False)
    return pre["ms"], dec["ms"], cache


def _decode_check(name, dec, full) -> dict:
    """Decode against the forward's logits at the same positions, within
    LM_DECODE_TOL."""
    import torch
    f = full[:, :dec.shape[1]]
    rel = float((dec - f).abs().max() / f.abs().max())
    top1 = float((dec.argmax(-1) == f.argmax(-1)).float().mean())
    if not bool(torch.isfinite(dec).all()) or rel > LM_DECODE_TOL:
        raise AssertionError(f"{name}: decode differs from the forward's "
                             f"logits over {dec.shape[1]} positions: "
                             f"{rel:.4e} (bound {LM_DECODE_TOL})")
    return dict(rel=rel, top1=top1)


def _phase9_times(name, cfg, model, toks, w_bytes, active_bytes, attn_ops,
                  k5_call, moe_call=None) -> dict:
    """Prefill and decode a token beside their bounds; the shares of K5's
    call (and the MoE layer's) in the prefill, from their times at layer
    0's shapes times the layers; the idle share from torch.profiler."""
    b, s = toks.shape
    pre_ms, dec_ms, cache = _lm_times(model, toks, LM_DECODE)
    flops = 2.0 * b * s * cfg.active_param_count() + attn_ops
    pre_bound = flops / BF16_OPS_PER_S * 1e3
    kv_bytes = sum(sum(t.numel() * t.element_size() for t in c[:2])
                   for c in cache["layers"])
    act_bound = (active_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    all_bound = (w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    k5 = _time_ms(k5_call, iters=5, warmup=1, graph=False)
    k5_share = cfg.n_layers * k5["ms"] / pre_ms
    out = dict(prefill_ms=pre_ms, prefill_bound_ms=pre_bound,
               prefill_tflop=flops / 1e12, decode_ms=dec_ms,
               decode_bound_ms=act_bound, decode_all_weights_ms=all_bound,
               k5_call_ms=k5["ms"], k5_share=k5_share)
    moe_txt = ""
    if moe_call is not None:
        moe = _time_ms(moe_call, iters=3, warmup=1, graph=False)
        n_moe = sum(k == "attn_moe" for k in model.kinds)
        out.update(moe_layer_ms=moe["ms"],
                   moe_share=n_moe * moe["ms"] / pre_ms)
        moe_txt = (f"; the MoE layer (router, dispatch, experts, combine) "
                   f"{moe['ms']:.3f} ms x {n_moe} = {out['moe_share']:.4f} "
                   f"of the prefill")
    out["profile_prefill"] = _profile(lambda: model(toks),
                                      f"{name} prefill B={b} S={s}")
    print(f"[lm9] {_card_line()}")
    print(f"[lm9] {name} prefill B={b} S={s}: {pre_ms:.3f} ms, bound "
          f"{pre_bound:.3f} ms ({flops / 1e12:.3f} active TFLOP / 989 "
          f"TFLOP/s bf16; {pre_bound / pre_ms:.3f} of the bound); K5's call "
          f"at layer 0 {k5['ms']:.4f} ms x {cfg.n_layers} = {k5_share:.4f} "
          f"of the prefill{moe_txt}")
    moe_txt, all_txt = "", ""
    if cfg.n_experts:
        moe_txt = (f" (top-{cfg.top_k} of {cfg.n_experts} experts a layer: "
                   f"what the design reads, as it skips an expert no token "
                   f"chose)")
        all_txt = f"; with every expert read {all_bound:.3f} ms"
    print(f"[lm9] {name} decode B={b}: {dec_ms:.3f} ms a token (mean of "
          f"tokens 1..{LM_DECODE - 1}); bound {act_bound:.3f} ms "
          f"({act_bound / dec_ms:.3f} of it) = ({active_bytes} weight bytes "
          f"a token reads{moe_txt} + {kv_bytes} cache bytes) / 3.35 "
          f"TB/s{all_txt}")
    return out


def drive_mixtral(dev, err: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attn import flash_mha
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as B
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    name = "mixtral-8x7b"
    cfg, model, w_bytes = _build_lm(dev, name, LM_FAMILIES[name][0])
    b, s = 1, LM_FAMILIES[name][1]
    rng = np.random.default_rng(SEED + 9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    fwd = []
    with M.routing_log(fwd):
        # K6 once a layer: each of the 16 is a MoE layer at its widths
        logits, counts = _counted_prefill(model, cfg, b, s, k6=16, toks=toks)
    k = cfg.top_k
    dropped = [r.dropped for r in fwd]
    share = sum(dropped) / (len(fwd) * b * s * k)
    first_drop = min((int((~r.keep[0]).any(-1).nonzero()[0])
                      for r in fwd if r.dropped), default=s)
    print(f"[lm9] {name} capacity {fwd[0].capacity} an expert (S={s}, "
          f"top-{k}, "
          f"factor {cfg.capacity_factor}): {sum(dropped)} of "
          f"{len(fwd) * b * s * k} choices dropped ({share:.5f}); by layer "
          f"{dropped}; the first dropped token is at position {first_drop}")

    # Layer 0's windowed attention through K5 and its plain version, on one
    # KV group (its 4 query heads), so the plain scores fit in 1.1 GB.
    l0 = model.layers[0]
    acfg = T._attn_cfg(cfg)
    x0 = B.embed(model.embedding, toks)
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    q, kk, v = A._qkv(l0["attn"], T._norm(cfg, l0["ln1"], x0), acfg, pos)
    rep = cfg.n_heads // cfg.n_kv
    grp = [t.to(torch.bfloat16).contiguous()
           for t in (q[:, :, :rep], kk[:, :, :1], v[:, :, :1])]
    got = flash_mha(*grp, window=cfg.window)
    want = mha_plain(*grp, window=cfg.window)
    e = _close(got, want, FLASH_TOL["bfloat16"])
    err["flash_attn_bfloat16"] = max(err["flash_attn_bfloat16"], e)
    free = mha_plain(*grp)
    binds = float((free.float() - want.float()).abs()[:, cfg.window:].max())
    print(f"[lm9] {name} K5 in layer 0 with the window {cfg.window} (one KV "
          f"group: q {tuple(grp[0].shape)}, k/v {tuple(grp[1].shape)}): max "
          f"|err| {e:.3e} against the plain version (tolerance "
          f"{FLASH_TOL['bfloat16']}); {_where_err(got, want, 'bfloat16')}; "
          f"the window moves rows >= {cfg.window} by up to {binds:.3e}")
    del got, want, free, grp

    # Decode of the first tokens from an empty cache, against the forward at
    # every position. Each decode step routes its token to the experts the
    # forward chose for it, its gates from its own router: the two runs
    # round apart, and a router near-tie would otherwise send a token to
    # another expert and move it, and through attention the later ones, by
    # order 1. Where the decode's own router would have chosen otherwise is
    # printed, with the largest gap between the two runs' probabilities.
    n_moe = len(fwd)

    def pick(i):
        t, layer = divmod(i, n_moe)
        r = fwd[layer]
        return r.expert_ids[:, t:t + 1], r.keep[:, t:t + 1]

    dec, log = _decode(model, toks, LM_DECODE, pick)
    if len(log) != LM_DECODE * n_moe:
        raise AssertionError(f"{name}: {len(log)} MoE calls in "
                             f"{LM_DECODE} decode steps of {n_moe} layers")
    own, div = [], 0.0
    for i, r in enumerate(log):
        t, layer = divmod(i, n_moe)
        want = fwd[layer]
        div = max(div, float((r.probs[:, 0] - want.probs[:, t]).abs().max()))
        if not torch.equal(r.expert_ids[:, 0].sort(-1).values,
                           want.expert_ids[:, t].sort(-1).values):
            own.append((t, layer))
    chk = _decode_check(name, dec, logits)
    print(f"[lm9] {name} decode of the first {LM_DECODE} tokens (ring caches "
          f"of {min(LM_CACHE, cfg.window)}, each token routed to the "
          f"forward's experts) against the forward's logits at all "
          f"{LM_DECODE} positions: max |diff| / max |logit| {chk['rel']:.4e} "
          f"(bound {LM_DECODE_TOL}), top-1 agreement {chk['top1']:.4f}; the "
          f"router probabilities of the two runs differ by up to {div:.4e}; "
          f"(position, layer) where the decode's own router chose other "
          f"experts: {own or 'none'}")
    del dec

    # layer 0's MoE input, for its time
    h = T._norm(cfg, l0["ln2"], x0 + A.attention(
        l0["attn"], T._norm(cfg, l0["ln1"], x0), acfg))
    mcfg = T._moe_cfg(cfg)
    attn_ops = (4.0 * cfg.hd * cfg.n_heads * b * _visible_pairs(s, cfg.window)
                * cfg.n_layers)
    active = w_bytes - sum(k_ == "attn_moe" for k_ in model.kinds) * (
        cfg.n_experts - cfg.top_k) * 3 * cfg.d_model * cfg.d_ff * 2
    out = _phase9_times(
        name, cfg, model, toks, w_bytes, active, attn_ops,
        lambda: flash_mha(q, kk, v, window=cfg.window),
        lambda: M.moe_forward(l0["moe"], h, mcfg))
    out.update(launches=counts["flash_attn"], drop_share=share,
               dropped_by_layer=dropped, first_drop=first_drop,
               decode_rel_err=chk["rel"], decode_top1=chk["top1"],
               decode_positions=LM_DECODE, router_divergence=div,
               own_picks_differ=own,
               weight_bytes=w_bytes,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    print(f"[lm9] {name} peak memory {out['peak_gb']:.3f} GB")
    return out


def drive_minicpm3(dev, err: dict) -> dict:
    import math
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import flash_mha
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as B
    from repro_torch.models import transformer as T
    name = "minicpm3-4b"
    cfg, model, w_bytes = _build_lm(dev, name, LM_FAMILIES[name][0])
    b, s = 1, LM_FAMILIES[name][1]
    rng = np.random.default_rng(SEED + 10)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    logits, counts = _counted_prefill(model, cfg, b, s, toks=toks)

    # Layer 0's MLA through K5 and its plain version: q = [q_nope | q_rope],
    # k = [k_nope | k_rope over the heads], v zero-padded to their width.
    l0 = model.layers[0]
    mcfg = T._mla_cfg(cfg)
    hx = T._norm(cfg, l0["ln1"], B.embed(model.embedding, toks))
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    qn, qr = A._mla_q(l0["mla"], hx, mcfg, pos)
    c_kv, kr = A._mla_kv_a(l0["mla"], hx, mcfg, pos)
    kn, v = A._mla_kv_b(l0["mla"], c_kv, mcfg)
    qk = mcfg.qk_nope_dim + mcfg.qk_rope_dim
    q = torch.cat([qn, qr], -1).to(torch.bfloat16)
    kk = torch.cat([kn, kr.expand(-1, -1, cfg.n_heads, -1)], -1).to(
        torch.bfloat16)
    vp = F.pad(v, (0, qk - mcfg.v_head_dim)).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(qk)
    got = flash_mha(q, kk, vp, scale=scale)
    want = mha_plain(q, kk, vp, scale=scale)
    e = _close(got, want, FLASH_TOL["bfloat16"])
    err["flash_attn_bfloat16"] = max(err["flash_attn_bfloat16"], e)
    print(f"[lm9] {name} K5 in layer 0's MLA (q/k {tuple(q.shape)}, v padded "
          f"from {mcfg.v_head_dim} to {qk}, scale 1/sqrt({qk})): max |err| "
          f"{e:.3e} against the plain version (tolerance "
          f"{FLASH_TOL['bfloat16']}); {_where_err(got, want, 'bfloat16')}")
    del got, want

    dec, _ = _decode(model, toks, LM_DECODE)
    chk = _decode_check(name, dec, logits)
    print(f"[lm9] {name} decode of the first {LM_DECODE} tokens (latent cache "
          f"of {LM_CACHE}) against the forward's logits: max |diff| / max "
          f"|logit| {chk['rel']:.4e} (bound {LM_DECODE_TOL}), top-1 agreement "
          f"{chk['top1']:.4f}")
    del dec
    # The reference's MLA arithmetic a visible pair and head: a 96-wide
    # score dot and a 64-wide value product.
    attn_ops = (2.0 * (qk + mcfg.v_head_dim) * cfg.n_heads * b
                * _visible_pairs(s) * cfg.n_layers)
    out = _phase9_times(name, cfg, model, toks, w_bytes, w_bytes, attn_ops,
                        lambda: flash_mha(q, kk, vp, scale=scale))
    out.update(launches=counts["flash_attn"], decode_rel_err=chk["rel"],
               decode_top1=chk["top1"], weight_bytes=w_bytes,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    print(f"[lm9] {name} peak memory {out['peak_gb']:.3f} GB")
    return out


def drive_llama4(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as B
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    name = "llama4-maverick-400b-a17b"
    cfg, model, w_bytes = _build_lm(dev, name, LM_FAMILIES[name][0])
    b, s = 1, LM_FAMILIES[name][1]
    rng = np.random.default_rng(SEED + 11)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    fwd = []
    with M.routing_log(fwd):
        # K6 once: the second of its two layers is its MoE layer
        logits, counts = _counted_prefill(model, cfg, b, s, k6=1, toks=toks)
    # The shared expert on the card: the MoE layer's output for a token whose
    # only choice capacity dropped is the shared expert's alone.
    x = B.embed(model.embedding, toks)
    x, _ = T.block_apply(model.kinds[0], model.layers[0], x, cfg, None)
    l1 = model.layers[1]
    x = x + A.attention(l1["attn"], T._norm(cfg, l1["ln1"], x),
                        T._attn_cfg(cfg))
    h = T._norm(cfg, l1["ln2"], x)
    mcfg = T._moe_cfg(cfg)
    r = M.moe_route(l1["moe"], h, mcfg)
    out, _ = M.moe_forward(l1["moe"], h, mcfg)
    shared = B.swiglu(l1["moe"]["shared"], h)
    drop = (~r.keep[0, :, 0]).nonzero()[:, 0]
    if len(drop) == 0 or not torch.equal(out[0, drop], shared[0, drop]):
        raise AssertionError(f"{name}: {len(drop)} dropped tokens; the "
                             f"shared expert alone must serve them")
    kept = r.keep[0, :, 0]
    moved = float((out[0, kept].float() - shared[0, kept].float()).abs().max())
    moe_ms = _time_ms(lambda: M.moe_forward(l1["moe"], h, mcfg), iters=3,
                      warmup=1, graph=False)["ms"]
    print(f"[lm9] {name} MoE layer: {len(drop)} of {s} tokens dropped by "
          f"capacity {r.capacity} ({cfg.n_experts} experts, top-"
          f"{cfg.top_k}), each served by the "
          f"shared expert alone (equal); the routed expert moves the kept "
          f"ones by up to {moved:.3f}; the layer {moe_ms:.3f} ms")
    del out, shared, x
    mesh = drive_llama4_mesh(dev, model, cfg, toks, logits, h, dict(
        dropped=sum(q.dropped for q in fwd), moe_ms=moe_ms))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"[lm9] {name} peak memory {peak:.3f} GB")
    return dict(launches=counts["flash_attn"], dropped=len(drop),
                moe_layer_ms=moe_ms, weight_bytes=w_bytes, peak_gb=peak,
                mesh=mesh)


def drive_llama4_mesh(dev, model, cfg, toks, want, h, plain: dict) -> dict:
    """Phase 12g, on phase 9's llama4 (one pattern group, 128 experts):
    expert parallelism on the one-rank (1, 1) nccl mesh, where tp = 1
    divides E, so the MoE takes the exchange (``shardctx.expert_parallel``:
    a one-rank all-to-all over tp) in the prefill and in the decode.
    First the unsharded decode of the prefill's first LM_DECODE tokens from
    an empty cache, its routing recorded; then the weights placed by
    ``params_sharding`` (wrapped as DTensors, not copied),
    ``make_prefill(mesh=...)`` of phase 9's tokens with the launch counts
    set to 0 just before and read just after (K5 exactly 2 times), its
    logits against phase 9's (``torch.equal``, else within FLASH_TOL) and
    its dropped choices beside phase 9's; the MoE layer on the mesh timed
    beside phase 9's (the padded (E, 1, C, d) buffer computes E·C rows
    where phase 9 computes S); then ``make_decode_step`` on the mesh with a
    cache placed by ``cache_sharding``, each step routed to the unsharded
    decode's experts (``moe.routing_log``: a router near-tie that the two
    paths round apart would otherwise move a token by order 1; where the
    mesh's own router chose otherwise is printed and gated), held to the
    unsharded decode within MESH_DECODE_TOL with every row's top-1 token
    equal, and the mesh's own router choosing otherwise at most
    MOE_MAX_FLIPS times, each a near-tie (MOE_TIE_MARGIN).
    Each ms is printed beside its unsharded twin."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch._tree import flatten_with_paths, unflatten
    from repro_torch.distributed import shardctx, steps
    from repro_torch.distributed.planner import (PlanConfig, cache_sharding,
                                                 shard_model, shard_tensor)
    from repro_torch.kernels import launches
    from repro_torch.launch.mesh import axis_sizes, make_host_mesh
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    b = toks.shape[0]
    n = LM_DECODE

    def decode(step, mdl, cache, pick=None):
        out, log = [], []
        with M.routing_log(log, pick):
            for t in range(n):
                lg, cache = step(mdl, toks[:, t:t + 1], cache)
                out.append(lg.full_tensor() if shardctx.is_dtensor(lg)
                           else lg)
        torch.cuda.synchronize()
        return out, log, cache

    def timed(step, mdl, make_cache) -> float:
        cache = make_cache()
        it = iter(range(n))

        def one():
            nonlocal cache
            t = next(it)
            _, cache = step(mdl, toks[:, t:t + 1], cache)

        one()
        return _time_ms(one, iters=n - 1, warmup=0, graph=False)["ms"]

    pre0_ms = _time_ms(lambda: model(toks), iters=3, warmup=1,
                       graph=False)["ms"]
    plain_step = steps.make_decode_step(cfg)
    dec0, log0, _ = decode(plain_step, model, model.init_cache(b, LM_CACHE))
    dec0_ms = timed(plain_step, model, lambda: model.init_cache(b, LM_CACHE))

    mesh = make_host_mesh(device=dev)
    if mesh.size() != 1 or axis_sizes(mesh)["model"] != 1:
        raise AssertionError(f"phase 12g: host mesh {axis_sizes(mesh)}")
    before = torch.cuda.memory_allocated(dev)
    shard_model(model, mesh)
    grown = torch.cuda.memory_allocated(dev) - before
    exchange = {"expert-parallel exchange"}
    prefill = steps.make_prefill(cfg, mesh=mesh, device=dev)
    batch = {"tokens": toks}
    prefill(model, batch)                   # first call: sharding rules
    torch.cuda.synchronize()
    mlog = []
    launches.reset()
    with M.routing_log(mlog):
        got = prefill(model, batch)
    torch.cuda.synchronize()
    counts = launches.snapshot()
    layouts = [q.layout for q in mlog]
    if counts != {"flash_attn": cfg.n_layers} or set(layouts) != exchange:
        raise AssertionError(f"phase 12g: the mesh prefill launched {counts}"
                             f" (want flash_attn x {cfg.n_layers}) through "
                             f"the MoE layouts {layouts} (want {exchange})")
    got = got.full_tensor()
    same = bool(torch.equal(got, want))
    diff = 0.0 if same else _close(got, want, FLASH_TOL["bfloat16"])
    dropped = sum(q.dropped for q in mlog)
    if dropped != plain["dropped"]:
        raise AssertionError(f"phase 12g: the mesh prefill dropped {dropped}"
                             f" choices, phase 9 {plain['dropped']}")
    pre_ms = _time_ms(lambda: prefill(model, batch), iters=3, warmup=1,
                      graph=False)["ms"]
    mcfg = T._moe_cfg(cfg)
    l1 = model.layers[1]
    hd = distribute_tensor(h, mesh, [Replicate(), Replicate()])
    with torch.no_grad(), steps._mesh_context(mesh, PlanConfig()):
        moe_ms = _time_ms(lambda: M.moe_forward(l1["moe"], hd, mcfg),
                          iters=3, warmup=1, graph=False)["ms"]
    E, C = cfg.n_experts, mlog[0].capacity

    def placed_cache():
        cache = model.init_cache(b, LM_CACHE)
        specs = flatten_with_paths(cache_sharding(cache, mesh, batch_size=b,
                                                  cfg=cfg))
        return unflatten(cache, [
            shard_tensor(t, sh) if isinstance(t, torch.Tensor) else t
            for (_, t), (_, sh) in zip(flatten_with_paths(cache), specs)])

    step = steps.make_decode_step(cfg)
    dec1, log1, _ = decode(step, model, placed_cache(),
                           lambda i: (log0[i].expert_ids, log0[i].keep))
    layouts = {q.layout for q in log1}
    if layouts != exchange or len(log1) != len(log0):
        raise AssertionError(f"phase 12g: the mesh decode's MoE layouts "
                             f"{sorted(layouts)}, {len(log1)} MoE calls "
                             f"against the unsharded decode's {len(log0)}")
    # (MoE call, margin) of each token the mesh's own router sent elsewhere
    own = []
    for t, (p1, p0) in enumerate(zip(log1, log0)):
        mine, pinned = p1.expert_ids, p0.expert_ids
        apart = (mine.sort(-1).values != pinned.sort(-1).values).any(-1)
        margin = (p1.probs.gather(-1, mine).sum(-1)
                  - p1.probs.gather(-1, pinned).sum(-1))
        own += [(t, float(m)) for m in margin[apart]]
    if len(own) > MOE_MAX_FLIPS or any(m > MOE_TIE_MARGIN for _, m in own):
        raise AssertionError(f"phase 12g: the mesh decode's own router chose "
                             f"other experts than the unsharded decode at "
                             f"(MoE call, margin) {own}: more than "
                             f"{MOE_MAX_FLIPS}, or past the near-tie margin "
                             f"{MOE_TIE_MARGIN}")
    rel = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(dec1, dec0))
    top1 = float(torch.cat([(g.argmax(-1) == w.argmax(-1)).float()
                            for g, w in zip(dec1, dec0)]).mean())
    if (not all(bool(torch.isfinite(g).all()) for g in dec1)
            or rel > MESH_DECODE_TOL or top1 < 1.0):
        raise AssertionError(f"phase 12g: mesh decode off the unsharded "
                             f"one: max |diff| / max |logit| {rel:.4e} "
                             f"(bound {MESH_DECODE_TOL}), top-1 agreement "
                             f"{top1:.4f} (bound 1)")
    dec1_ms = timed(step, model, placed_cache)
    print(f"[mesh] {_card_line()}")
    print(f"[mesh] 12g {cfg.name} (one pattern group, {E} experts) on the "
          f"one-rank mesh, phase 9's weights placed by params_sharding as "
          f"DTensors ({grown / 1e9:.3f} GB allocated by the placing): "
          f"make_prefill(mesh=...) B={b} S={toks.shape[1]} launches "
          f"{counts}, the MoE expert-parallel (the exchange: a one-rank "
          f"all-to-all); logits "
          + ("equal to phase 9's (torch.equal)" if same else
             f"within FLASH_TOL of phase 9's (max |diff| {diff:.3e}: the "
             f"padded expert products round apart)")
          + f"; {dropped} choices dropped beside phase 9's "
          f"{plain['dropped']}; {pre_ms:.3f} ms a prefill beside phase "
          f"9's {pre0_ms:.3f} ms; the MoE layer "
          f"{moe_ms:.3f} ms ({E} x C={C} = {E * C} padded expert rows) "
          f"beside phase 9's {plain['moe_ms']:.3f} ms ({toks.shape[1]} "
          f"rows)")
    print(f"[mesh] 12g make_decode_step on the mesh ({LM_DECODE} steps from "
          f"an empty {LM_CACHE}-token cache placed by cache_sharding, each "
          f"routed to the unsharded decode's experts) against the unsharded "
          f"decode: max |diff| / max |logit| {rel:.4e} (bound "
          f"{MESH_DECODE_TOL}), top-1 agreement {top1:.4f} (bound 1); "
          f"(MoE call, margin) where the mesh's own router chose other "
          f"experts: {own or 'none'} (bound {MOE_MAX_FLIPS}, each within "
          f"{MOE_TIE_MARGIN})"
          f"; {dec1_ms:.3f} ms a token beside the unsharded {dec0_ms:.3f} "
          f"ms (mean of tokens 1..{n - 1})")
    return dict(launches=counts["flash_attn"], equal=same, max_diff=diff,
                dropped=dropped, phase9_dropped=plain["dropped"],
                prefill_ms=pre_ms, unsharded_prefill_ms=pre0_ms,
                moe_layer_ms=moe_ms,
                phase9_moe_layer_ms=plain["moe_ms"], padded_rows=E * C,
                decode_rel_err=rel, decode_top1=top1,
                decode_own_picks_differ=own, decode_ms=dec1_ms,
                unsharded_decode_ms=dec0_ms, placed_bytes=grown)


def drive_qwen2_vl(dev) -> dict:
    import numpy as np
    import torch
    name = "qwen2-vl-72b"
    cfg, model, w_bytes = _build_lm(dev, name, LM_FAMILIES[name][0])
    b, s = 1, LM_FAMILIES[name][1]
    # A 2 x 24 x 32 patch grid (temporal, height, width), then text that
    # resumes one past the grid's largest position in all three streams.
    tt, hh, ww = torch.meshgrid(torch.arange(2), torch.arange(24),
                                torch.arange(32), indexing="ij")
    grid = torch.stack([tt, hh, ww], -1).reshape(-1, 3)
    text = (32 + torch.arange(s - len(grid)))[:, None].expand(-1, 3)
    pos = torch.cat([grid, text])[None].to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    embeds = torch.randn((b, s, cfg.d_model), generator=gen, device=dev,
                         dtype=torch.float32).to(torch.bfloat16)
    logits, counts = _counted_prefill(model, cfg, b, s, toks=None,
                                      embeds=embeds, positions=pos)
    flat, _ = model(None, embeds=embeds, positions=pos[..., 0])
    moved = float((flat - logits).abs().max() / logits.abs().max())
    print(f"[lm9] {name} positions: a {tuple(grid.shape)} patch grid then "
          f"{s - len(grid)} text tokens; the same prefill with text-only "
          f"positions moves the logits by {moved:.4e} of the largest")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"[lm9] {name} peak memory {peak:.3f} GB")
    return dict(launches=counts["flash_attn"], weight_bytes=w_bytes,
                peak_gb=peak, mrope_moved=moved)


def drive_lm_families(dev, err: dict) -> dict:
    """Phase 9: each model built, driven and freed in turn."""
    import gc
    import torch
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {}
    for name, fn in (("mixtral-8x7b", lambda: drive_mixtral(dev, err)),
                     ("minicpm3-4b", lambda: drive_minicpm3(dev, err)),
                     ("llama4-maverick-400b-a17b", lambda: drive_llama4(dev)),
                     ("qwen2-vl-72b", lambda: drive_qwen2_vl(dev))):
        out[name] = fn()
        gc.collect()
        torch.cuda.empty_cache()
    return out


# -- phase 10: the recurrent and encoder-decoder paths ---------------------------

# name -> (batch, prefill length, K5 launches a prefill); whole models at the
# published widths of src/repro/configs/archs.py, bf16 weights random from
# SEED:
#  * recurrentgemma-2b (:119): 26 layers, 18 RG-LRU and 8 local attention
#    (window 2048, one KV head, hd 256), 2.50 G weights; S = 8192, so the
#    window binds for the last 6144 queries; decode into ring caches of
#    2048.
#  * xlstm-350m (:52): 24 layers, 21 mLSTM and 3 sLSTM, 0.41 G weights;
#    S = 2048, four of its 512-token chunks; no attention, so no K5.
#  * whisper-base (:133): 6 encoder and 6 decoder layers; B = 16 stub frame
#    tensors of 1500 frames (the reference's min(S, 1500),
#    src/repro/distributed/steps.py:196) and a prompt of 448 tokens
#    (whisper's context): K5 in the encoder (no mask), the decoder's self
#    attention (causal) and its cross attention (no mask, 448 x 1500).
LM_PHASE10 = {"recurrentgemma-2b": (1, 8192, 8), "xlstm-350m": (1, 2048, 0),
              "whisper-base": (16, 448, 18)}
WHISPER_FRAMES = 1500


def _weight_counts(modules) -> tuple:
    """(bf16, f32) element counts of the matrices the modules multiply
    activations by: their 2-D parameters (the embedding as the tied LM
    head; not RG-LRU's depthwise conv or whisper's positions, which are
    elementwise)."""
    import torch
    n = {torch.bfloat16: 0, torch.float32: 0}
    for m in modules:
        for name, p in m.named_parameters():
            if p.dim() == 2 and not name.endswith(("conv", "dec_pos")):
                n[p.dtype] += p.numel()
    return n[torch.bfloat16], n[torch.float32]


def _state_bytes(tree) -> int:
    """Bytes of every tensor in a cache or state tree."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_state_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_state_bytes(v) for v in tree)
    return 0


def _phase10_report(name, b, s, pre_ms, flops16, flops32, dec_ms,
                    dec_bytes, k5_ms, prof, extra="") -> dict:
    """Prints the prefill and decode a token beside their bounds (bf16
    operations / 989 TFLOP/s + f32 operations / 67 TFLOP/s; the bytes a
    token reads / 3.35 TB/s), K5's share and the idle share."""
    pre_bound = (flops16 / BF16_OPS_PER_S + flops32 / FP32_OPS_PER_S) * 1e3
    dec_bound = dec_bytes / HBM_BYTES_PER_S * 1e3
    busy = prof.get("busy_ms")
    idle = None if busy is None else 1 - busy / prof["wall_ms"]
    print(f"[lm10] {_card_line()}")
    print(f"[lm10] {name} prefill B={b} S={s}: {pre_ms:.3f} ms, bound "
          f"{pre_bound:.3f} ms ({flops16 / 1e12:.3f} bf16 TFLOP / 989 + "
          f"{flops32 / 1e12:.4f} f32 TFLOP / 67 TFLOP/s; {pre_bound / pre_ms:.3f}"
          f" of the bound); K5 {k5_ms:.3f} ms of it ({k5_ms / pre_ms:.4f}); "
          f"idle share {'not measured' if idle is None else f'{idle:.3f}'}"
          f"{extra}")
    print(f"[lm10] {name} decode B={b}: {dec_ms:.3f} ms a token (mean of "
          f"tokens 1..{LM_DECODE - 1}); bound {dec_bound:.4f} ms ({dec_bytes} "
          f"weight and state bytes / 3.35 TB/s; {dec_bound / dec_ms:.4f} of "
          f"it)")
    return dict(prefill_ms=pre_ms, prefill_bound_ms=pre_bound,
                prefill_bf16_tflop=flops16 / 1e12,
                prefill_f32_tflop=flops32 / 1e12, decode_ms=dec_ms,
                decode_bound_ms=dec_bound, decode_bytes=dec_bytes,
                k5_ms=k5_ms, k5_share=k5_ms / pre_ms, idle_share=idle,
                profile_prefill=prof)


def drive_recurrentgemma(dev, err: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_mha)
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as B
    from repro_torch.models import recurrent as R
    from repro_torch.models import transformer as T
    name = "recurrentgemma-2b"
    b, s, n_k5 = LM_PHASE10[name]
    cfg, model, w_bytes = _build_lm(dev, name, None, tag="lm10")
    rng = np.random.default_rng(SEED + 13)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    logits, counts = _counted_prefill(model, cfg, b, s, want=n_k5,
                                      tag="lm10", toks=toks)

    # The first local-attention layer (block 2), its input from blocks 0-1:
    # K5 with the window, at d 256 with the KV head repeated 10 times,
    # against its plain version.
    li = model.kinds.index("attn")
    x = B.embed(model.embedding, toks)
    x0 = x
    for kind, p in zip(model.kinds[:li], model.layers[:li]):
        x, _ = T.block_apply(kind, p, x, cfg, None)
    lp = model.layers[li]
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    q, k, v = A._qkv(lp["attn"], T._norm(cfg, lp["ln1"], x),
                     T._attn_cfg(cfg), pos)
    got = flash_mha(q, k, v, window=cfg.window)
    want = mha_plain(q, k, v, window=cfg.window)
    e = _close(got, want, FLASH_TOL["bfloat16"])
    err["flash_attn_bfloat16"] = max(err["flash_attn_bfloat16"], e)
    free = mha_plain(q, k, v)
    binds = float((free.float() - want.float()).abs()[:, cfg.window:].max())
    print(f"[lm10] {name} K5 in block {li} with the window {cfg.window} (q "
          f"{tuple(q.shape)}, k/v {tuple(k.shape)} bf16, the KV head "
          f"repeated {cfg.n_heads} times): max |err| {e:.3e} against the "
          f"plain version (tolerance {FLASH_TOL['bfloat16']}); "
          f"{_where_err(got, want, 'bfloat16', scaled=True)}; the window moves rows >= "
          f"{cfg.window} by up to {binds:.3e}")
    del got, want, free

    # Decode into the RG-LRU states and ring caches of the window.
    dec, _ = _decode(model, toks, LM_DECODE, max_len=s)
    chk = _decode_check(name, dec, logits)
    print(f"[lm10] {name} decode of the first {LM_DECODE} tokens (RG-LRU "
          f"states, ring caches of {cfg.window}) against the forward's "
          f"logits: max |diff| / max |logit| {chk['rel']:.4e} (bound "
          f"{LM_DECODE_TOL}), top-1 agreement {chk['top1']:.4f}")
    del dec, logits

    # Times: the prefill, K5's call and the kernel alone (the wrapper's
    # repeat_interleave and layout copies between), the RG-LRU block and
    # its scan alone, at layer shapes.
    pre_ms, dec_ms, cache = _lm_times(model, toks, LM_DECODE, max_len=s)
    call = _time_ms(lambda: flash_mha(q, k, v, window=cfg.window), iters=5,
                    warmup=1, graph=False)
    qf = _heads(q, b, cfg.n_heads, s, cfg.hd)
    kf, vf = (_heads(t.repeat_interleave(cfg.n_heads, dim=2), b,
                     cfg.n_heads, s, cfg.hd) for t in (k, v))
    kern = _time_ms(lambda: flash_attention(qf, kf, vf, block_q=s,
                                            block_k=s, window=cfg.window),
                    iters=5, warmup=1, graph=False)
    l0 = model.layers[0]
    h0 = T._norm(cfg, l0["ln1"], x0)
    rg = _time_ms(lambda: R.rglru_block(l0["rglru"], h0, T._rglru_cfg(cfg)),
                  iters=3, warmup=1, graph=False)
    a_, g_ = R._rglru_gates(l0["rglru"], R._causal_depthwise_conv(
        B.dense(l0["rglru"]["wx"], h0), l0["rglru"]["conv"]))
    scan = _time_ms(lambda: R.linear_scan(a_, g_), iters=3, warmup=1,
                    graph=False)
    n_rg = model.kinds.count("rglru")
    w16, w32 = _weight_counts([model])
    flops16 = (2.0 * b * s * w16 + 4.0 * cfg.hd * cfg.n_heads * b
               * _visible_pairs(s, cfg.window) * n_k5)
    prof = _profile(lambda: model(toks), f"{name} prefill B={b} S={s}")
    out = _phase10_report(
        name, b, s, pre_ms, flops16, 2.0 * b * s * w32, dec_ms,
        w_bytes + _state_bytes(cache), n_k5 * call["ms"], prof,
        extra=(f"; K5's call {call['ms']:.4f} ms a layer, the kernel alone "
               f"{kern['ms']:.4f} ms (the wrapper's KV repeat and copies "
               f"{call['ms'] - kern['ms']:.4f} ms); the RG-LRU block "
               f"{rg['ms']:.3f} ms x {n_rg} = {n_rg * rg['ms'] / pre_ms:.4f} "
               f"of the prefill, its f32 scan alone {scan['ms']:.3f} ms x "
               f"{n_rg} = {n_rg * scan['ms'] / pre_ms:.4f}"))
    out.update(launches=counts["flash_attn"], decode_rel_err=chk["rel"],
               decode_top1=chk["top1"], weight_bytes=w_bytes,
               k5_call_ms=call["ms"], k5_kernel_ms=kern["ms"],
               rglru_block_ms=rg["ms"], rglru_scan_ms=scan["ms"],
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    print(f"[lm10] {name} peak memory {out['peak_gb']:.3f} GB")
    return out


def drive_xlstm(dev, err: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.models import blocks as B
    from repro_torch.models import transformer as T
    name = "xlstm-350m"
    b, s, n_k5 = LM_PHASE10[name]
    cfg, model, w_bytes = _build_lm(dev, name, None, tag="lm10")
    rng = np.random.default_rng(SEED + 14)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    logits, counts = _counted_prefill(model, cfg, b, s, want=n_k5,
                                      tag="lm10", toks=toks)
    dec, _ = _decode(model, toks, LM_DECODE)
    chk = _decode_check(name, dec, logits)
    print(f"[lm10] {name} decode of the first {LM_DECODE} tokens (mLSTM and "
          f"sLSTM states) against the forward's logits: max |diff| / max "
          f"|logit| {chk['rel']:.4e} (bound {LM_DECODE_TOL}), top-1 "
          f"agreement {chk['top1']:.4f}")
    del dec, logits

    pre_ms, dec_ms, cache = _lm_times(model, toks, LM_DECODE)
    # Each block kind's time at layer shapes (the residual and norm
    # included), and its share of the prefill: the sLSTM's loop over 2048
    # steps against the mLSTM's four chunks.
    x = B.embed(model.embedding, toks)
    times = {}
    for kind in ("mlstm", "slstm"):
        i = model.kinds.index(kind)
        times[kind] = _time_ms(lambda: T.block_apply(
            kind, model.layers[i], x, cfg, None), iters=2, warmup=1,
            graph=False)["ms"]
    n = {k: model.kinds.count(k) for k in times}
    w16, w32 = _weight_counts([model])
    m = T._mlstm_cfg(cfg)
    q_len, hd = min(m.chunk, s), m.head_dim
    # mLSTM's chunkwise arithmetic in f32: in a chunk and head, the scores
    # and their value product (dense over the chunk) and the inter-chunk
    # product and state update.
    mlstm_ops = (n["mlstm"] * b * m.n_heads * (s // q_len)
                 * (4.0 * q_len * q_len * hd + 4.0 * q_len * hd * hd))
    prof = _profile(lambda: model(toks), f"{name} prefill B={b} S={s}")
    share = {k: n[k] * times[k] / pre_ms for k in times}
    out = _phase10_report(
        name, b, s, pre_ms, 2.0 * b * s * w16, 2.0 * b * s * w32 + mlstm_ops,
        dec_ms, w_bytes + _state_bytes(cache), 0.0, prof,
        extra=(f"; the mLSTM block {times['mlstm']:.3f} ms x {n['mlstm']} = "
               f"{share['mlstm']:.4f} of the prefill, the sLSTM block (a loop"
               f" of {s} steps) {times['slstm']:.3f} ms x {n['slstm']} = "
               f"{share['slstm']:.4f}"))
    out.update(launches=counts["flash_attn"], decode_rel_err=chk["rel"],
               decode_top1=chk["top1"], weight_bytes=w_bytes,
               mlstm_block_ms=times["mlstm"], slstm_block_ms=times["slstm"],
               slstm_share=share["slstm"], mlstm_share=share["mlstm"],
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    print(f"[lm10] {name} peak memory {out['peak_gb']:.3f} GB")
    return out


def drive_whisper(dev, err: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attn import flash_mha
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as B
    from repro_torch.models import encdec as E
    name = "whisper-base"
    b, s, n_k5 = LM_PHASE10[name]
    t_enc = WHISPER_FRAMES
    cfg, model, w_bytes = _build_lm(dev, name, None, tag="lm10")
    rng = np.random.default_rng(SEED + 15)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    frames = torch.randn((b, t_enc, cfg.d_model), generator=gen, device=dev,
                         dtype=torch.float32).to(torch.bfloat16)
    logits, counts = _counted_prefill(model, cfg, b, s, want=n_k5,
                                      tag="lm10", toks=toks, frames=frames)
    H, hd = cfg.n_heads, cfg.hd

    # Encoder layer 0's attention and decoder layer 0's cross attention
    # through K5 without the mask, against their plain versions; T = 1500
    # is off K5's key tiles.
    e0, d0 = model.enc[0], model.dec[0]
    qe, ke, ve = A._qkv(e0["attn"], B.layernorm(e0["ln1"], frames),
                        E._acfg(cfg, False), None)
    enc = model.encode(frames)
    x = B.embed(model.embedding, toks) + model.dec_pos[:s].to(
        torch.bfloat16)[None]
    qs, ks, vs = A._qkv(d0["self"], B.layernorm(d0["ln1"], x),
                        E._acfg(cfg, True), None)
    x = x + A.attention(d0["self"], B.layernorm(d0["ln1"], x),
                        E._acfg(cfg, True))
    hq = B.layernorm(d0["ln2"], x)
    qc = B.dense(d0["cross"]["wq"], hq).reshape(b, s, H, hd)
    kc, vc = (B.dense(d0["cross"][w], enc).reshape(b, t_enc, cfg.n_kv, hd)
              for w in ("wk", "wv"))
    calls = {"encoder": (qe, ke, ve, False), "cross": (qc, kc, vc, False),
             "decoder self": (qs, ks, vs, True)}
    for key in ("encoder", "cross"):
        q, k, v, _ = calls[key]
        got = flash_mha(q, k, v, causal=False)
        want = mha_plain(q, k, v, causal=False)
        e = _close(got, want, FLASH_TOL["bfloat16"])
        err["flash_attn_bfloat16"] = max(err["flash_attn_bfloat16"], e)
        print(f"[lm10] {name} K5 in the {key} attention of layer 0 (q "
              f"{tuple(q.shape)}, k/v {tuple(k.shape)} bf16, no mask): max "
              f"|err| {e:.3e} against the plain version (tolerance "
              f"{FLASH_TOL['bfloat16']}); {_where_err(got, want, 'bfloat16', scaled=True)}")
        del got, want

    # Decode from the encoder's cross K/V and empty self caches.
    cache = model.init_cache(frames, LM_CACHE)
    dec = []
    for t in range(LM_DECODE):
        lg, cache = model.decode_step(toks[:, t:t + 1], cache)
        dec.append(lg)
    torch.cuda.synchronize()
    chk = _decode_check(name, torch.cat(dec, dim=1), logits)
    print(f"[lm10] {name} decode of the first {LM_DECODE} tokens (cross K/V "
          f"of {t_enc} frames, self caches of {LM_CACHE}) against the "
          f"forward's logits: max |diff| / max |logit| {chk['rel']:.4e} "
          f"(bound {LM_DECODE_TOL}), top-1 agreement {chk['top1']:.4f}")
    del dec, logits

    pre = _time_ms(lambda: model(toks, frames), iters=2, warmup=1,
                   graph=False)
    cache = model.init_cache(frames, LM_CACHE)
    steps = iter(range(LM_DECODE))

    def step():
        nonlocal cache
        t = next(steps)
        _, cache = model.decode_step(toks[:, t:t + 1], cache)

    step()
    dec_ms = _time_ms(step, iters=LM_DECODE - 1, warmup=0, graph=False)["ms"]
    k5 = {key: _time_ms(lambda: flash_mha(q, k, v, causal=causal), iters=5,
                        warmup=1, graph=False)["ms"]
          for key, (q, k, v, causal) in calls.items()}
    k5_ms = sum(k5.values()) * cfg.n_layers     # enc_layers == n_layers == 6
    # The encoder's matrices multiply 1500 frames a sequence, the cross
    # attention's K/V projections too; the decoder's the 448 tokens.
    enc16, _ = _weight_counts(list(model.enc))
    kv16 = sum(p["cross"][w]["w"].numel() for p in model.dec
               for w in ("wk", "wv"))
    dec16, _ = _weight_counts(list(model.dec) + [model.embedding])
    pairs = (cfg.enc_layers * t_enc * t_enc + cfg.n_layers
             * (_visible_pairs(s) + s * t_enc))
    flops16 = (2.0 * b * t_enc * (enc16 + kv16) + 2.0 * b * s * (dec16 - kv16)
               + 4.0 * hd * H * b * pairs)
    # A decode step reads the decoder's matrices but the cross K/V
    # projections (applied once, in init_cache), the LM head, and the
    # cross K/V and self caches.
    dec_bytes = 2 * (dec16 - kv16) + _state_bytes(cache["dec"])
    prof = _profile(lambda: model(toks, frames),
                    f"{name} prefill B={b} S={s} frames {t_enc}")
    out = _phase10_report(
        name, b, s, pre["ms"], flops16, 0.0, dec_ms, dec_bytes, k5_ms, prof,
        extra="; K5 a layer: " + ", ".join(
            f"{key} {ms:.4f} ms" for key, ms in k5.items()))
    out.update(launches=counts["flash_attn"], decode_rel_err=chk["rel"],
               decode_top1=chk["top1"], weight_bytes=w_bytes,
               k5_call_ms={key: ms for key, ms in k5.items()},
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    print(f"[lm10] {name} peak memory {out['peak_gb']:.3f} GB")
    return out


def drive_phase10(dev, err: dict) -> dict:
    """Phase 10: each model built, driven and freed in turn; a failure in
    one is reported after the others have run, and fails the phase."""
    import gc
    import traceback
    import torch
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out, failed = {}, []
    for name, fn in (("recurrentgemma-2b", drive_recurrentgemma),
                     ("xlstm-350m", drive_xlstm),
                     ("whisper-base", drive_whisper)):
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            out[name] = fn(dev, err)
        except Exception as exc:                # reported below, then raised
            traceback.print_exc()
            failed.append(f"{name}: {exc}")
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("phase 10 failed: " + "; ".join(failed))
    return out


# -- phase 11: the training path --------------------------------------------------

# recurrentgemma-2b (src/repro/configs/archs.py:119) whole at its published
# widths, f32 weights, grads and two f32 moments: 16 bytes x 2.50 G = 40 GB,
# the largest whole model of configs that fits one card so (minicpm3-4b
# would need 65 GB before any activation). B x S from the bigram sampler;
# B is cut to 1 only where the peak passes TRAIN_PEAK_GB.
TRAIN_ARCH = "recurrentgemma-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 4
TRAIN_PEAK_GB = 75.0
TRAIN_LR = 3e-3                 # launch.train's default --lr
# Phase 11b: launch.train's default arch at --full, run twice into one
# checkpoint directory under build/ (gitignored), deleted after.
LAUNCH_TRAIN = ["--arch", "xlstm-350m", "--full", "--batch", "8", "--seq",
                "128", "--ckpt-every", "100", "--log-every", "1"]


def _train_flops(cfg, n_params: int, b: int, s: int) -> float:
    """A train step's operations: 6 a weight a token (forward 2, backward
    4; the embedding counted once, as the tied head's product; remat's
    recompute not counted), and the attention's 12 * hd a visible (query,
    key) pair a head a layer (forward 4 * hd, backward 8 * hd)."""
    n_attn = sum(k in ("attn", "attn_moe") for k in
                 list(cfg.pattern) * cfg.n_groups + list(cfg.pattern_tail))
    return (6.0 * n_params * b * s + 12.0 * cfg.hd * cfg.n_heads * b
            * _visible_pairs(s, cfg.window) * n_attn)


def drive_train(dev, err: dict) -> dict:
    """Phase 11a. Fails on a gradient leaf that is not finite or is 0, a
    K5 launch inside the train steps, a loss, ce or grad norm that is not
    finite, a peak past TRAIN_PEAK_GB, a prefill of the trained weights
    that launches K5 other than once an attention layer, or K5 in that
    prefill's first attention layer off its plain version."""
    import gc
    import torch
    from repro_torch import configs, optim
    from repro_torch._tree import flatten_with_paths
    from repro_torch.data import BigramSampler, LMDataConfig
    from repro_torch.distributed import steps
    from repro_torch.kernels import launches
    from repro_torch.kernels.flash_attn import flash_mha
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as B
    from repro_torch.models import build
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = configs.get(TRAIN_ARCH)
    b, s = TRAIN_BATCH, TRAIN_SEQ
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build(cfg, device=dev, seed=SEED, remat=True,
                  weight_dtype=torch.float32)
    opt = optim.init(model.params())
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] {_card_line()}")
    print(f"[train] {TRAIN_ARCH} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads, {cfg.n_kv} KV, window {cfg.window}, vocab "
          f"{cfg.vocab}): {n_params} f32 weights and two f32 moments, "
          f"{16 * n_params / 1e9:.3f} GB with the gradients, random from seed "
          f"{SEED} in {time.perf_counter() - t0:.2f} s")
    data = BigramSampler(LMDataConfig(vocab=cfg.vocab, seq_len=s, seed=SEED))
    stream = data.stream(b, start_seed=1)
    batches = [{"tokens": torch.from_numpy(t).to(dev),
                "labels": torch.from_numpy(l).to(dev)}
               for t, l in (next(stream) for _ in range(TRAIN_STEPS))]

    # One gradient of every leaf, on the first batch.
    loss, ce, grads = steps.loss_and_grads(cfg, model, batches[0])
    norms = torch.stack([g.float().norm() for g in grads]).cpu()
    names = ["/".join(p) for p, _ in flatten_with_paths(model.params())]
    bad = [n for n, v in zip(names, norms.tolist())
           if not math.isfinite(v) or v == 0.0]
    compressed = drive_compression(dev, grads)
    del grads
    if bad or not bool(torch.isfinite(loss)):
        raise AssertionError(f"{TRAIN_ARCH}: loss {float(loss)}; gradient "
                             f"leaves not finite or 0: {bad[:8]}")
    print(f"[train] {TRAIN_ARCH} gradient on batch 1 (B={b} S={s}): loss "
          f"{float(loss):.4f}, ce {float(ce):.4f}; all {len(names)} leaves "
          f"finite and nonzero (smallest norm {float(norms.min()):.3e} at "
          f"{names[int(norms.argmin())]})")

    ocfg = optim.AdamWConfig(lr=TRAIN_LR, warmup_steps=20,
                             total_steps=TRAIN_STEPS)
    train_step = steps.make_train_step(cfg, ocfg, device=dev)
    times, metrics, prof = [], [], None
    launches.reset()
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if i == len(batches) - 1:         # the last step, traced
            box = {}

            def traced():
                box["out"] = train_step(model, opt, batch)
            prof = _profile(traced, f"{TRAIN_ARCH} train step {i + 1}",
                            top=8, tag="train")
            model, opt, m = box.pop("out")
        else:
            model, opt, m = train_step(model, opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        m = {k: float(v) for k, v in m.items()}
        metrics.append(m)
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{TRAIN_ARCH} step {i + 1}: {m}")
        print(f"[train] {TRAIN_ARCH} step {i + 1}: loss {m['loss']:.4f} ce "
              f"{m['ce']:.4f} grad norm {m['grad_norm']:.4f} lr "
              f"{m['lr']:.3e}; {times[-1]:.1f} ms"
              + (" (traced)" if i == len(batches) - 1 else ""))
    counts = launches.snapshot()
    if counts.get("flash_attn", 0) != 0:
        raise AssertionError(f"the train steps launched {counts}")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    if peak > TRAIN_PEAK_GB:
        raise AssertionError(f"peak {peak:.2f} GB > {TRAIN_PEAK_GB} GB: cut "
                             f"TRAIN_BATCH to 1")
    step_ms = sum(times[1:-1]) / len(times[1:-1])
    flops = _train_flops(cfg, n_params, b, s)
    state_bytes = 16 * n_params
    bound = max(flops / BF16_OPS_PER_S, state_bytes / HBM_BYTES_PER_S) * 1e3
    busy = prof.get("busy_ms")
    idle = None if busy is None else 1 - busy / prof["wall_ms"]
    print(f"[train] {_card_line()}")
    print(f"[train] {TRAIN_ARCH} train step B={b} S={s}: {step_ms:.1f} ms "
          f"(mean of steps 2..{TRAIN_STEPS - 1}; step 1 {times[0]:.1f} ms), "
          f"launches in the {TRAIN_STEPS} steps {counts or 'none'}; bound "
          f"{bound:.3f} ms (max of {flops / 1e12:.2f} TFLOP / 989 TFLOP/s = "
          f"{flops / BF16_OPS_PER_S * 1e3:.3f} ms and {state_bytes / 1e9:.2f}"
          f" GB of weights, gradients and moments / 3.35 TB/s = "
          f"{state_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; "
          f"{bound / step_ms:.4f} of it); {b * s / step_ms * 1e3:.0f} tokens/s;"
          f" peak memory {peak:.2f} GB; idle share "
          f"{'not measured' if idle is None else f'{idle:.3f}'}")

    # The trained weights as serving holds them, prefilled through K5.
    del opt, train_step
    serving = model.cast(torch.bfloat16)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    prefill = steps.make_prefill(cfg, device=dev)
    n_k5 = sum(k == "attn" for k in serving.kinds)
    launches.reset()
    logits = prefill(serving, {"tokens": batches[0]["tokens"]})
    torch.cuda.synchronize()
    pcounts = launches.snapshot()
    if pcounts != {"flash_attn": n_k5} or n_k5 != LM_PHASE10[TRAIN_ARCH][2]:
        raise AssertionError(f"the prefill of the trained weights launched "
                             f"{pcounts}; want flash_attn x {n_k5}")
    if (logits.shape != (b, s, cfg.vocab)
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")
    ce_served = float(steps.softmax_xent(logits, batches[0]["labels"]))
    print(f"[train] {TRAIN_ARCH} prefill of the trained weights in bf16 "
          f"(make_prefill, B={b} S={s}): launches {pcounts}; logits finite; "
          f"ce on batch 1 {ce_served:.4f} (step 1's f32 training ce "
          f"{metrics[0]['ce']:.4f})")
    del logits

    # K5 at this prefill's shapes (B = 2, the window) in its first
    # attention layer, its input from the trained blocks before it,
    # against its plain version (after the counted prefill).
    toks = batches[0]["tokens"]
    with torch.inference_mode():
        li = serving.kinds.index("attn")
        x = B.embed(serving.embedding, toks)
        for kind, p in zip(serving.kinds[:li], serving.layers[:li]):
            x, _ = T.block_apply(kind, p, x, cfg, None)
        lp = serving.layers[li]
        pos = torch.arange(s, device=dev)[None].expand(b, s)
        q, k, v = A._qkv(lp["attn"], T._norm(cfg, lp["ln1"], x),
                         T._attn_cfg(cfg), pos)
        got = flash_mha(q, k, v, window=cfg.window)
        want = mha_plain(q, k, v, window=cfg.window)
    e = _close(got, want, FLASH_TOL["bfloat16"])
    err["flash_attn_bfloat16"] = max(err["flash_attn_bfloat16"], e)
    print(f"[train] {TRAIN_ARCH} K5 in the trained block {li} with the "
          f"window {cfg.window} (q {tuple(q.shape)}, k/v {tuple(k.shape)} "
          f"bf16): max |err| {e:.3e} against the plain version (tolerance "
          f"{FLASH_TOL['bfloat16']}); "
          f"{_where_err(got, want, 'bfloat16', scaled=True)}")
    del serving, x, q, k, v, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arch=TRAIN_ARCH, batch=b, seq=s, params=n_params,
                step_ms=step_ms, step_times_ms=times, bound_ms=bound,
                bound_tflop=flops / 1e12, state_gb=state_bytes / 1e9,
                peak_gb=peak, idle_share=idle, profile=prof,
                metrics=metrics, train_k5_launches=counts.get(
                    "flash_attn", 0),
                prefill_k5_launches=pcounts["flash_attn"],
                served_ce=ce_served, compression=compressed)


def drive_launch_train(dev) -> dict:
    """Phase 11b. Fails unless run 2 resumes from step 4 with exactly the
    state run 1 saved (``torch.equal``, every leaf), both runs' losses are
    finite, and step 6 is committed."""
    import gc
    import shutil
    import torch
    from repro_torch import ckpt
    from repro_torch._tree import leaves
    from repro_torch.launch import train
    from repro_torch.models import state_to_reference, to_reference

    tmp = ROOT / "build" / "phase11_ckpt"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    print(f"[train] launch.train: {shutil.disk_usage(tmp).free / 1e9:.1f} GB"
          f" free under {tmp}")
    argv = LAUNCH_TRAIN + ["--ckpt-dir", str(tmp), "--device", str(dev)]
    try:
        t0 = time.perf_counter()
        r1 = train.main(argv + ["--steps", "4"])
        t1 = time.perf_counter()
        cfg = r1["model"].cfg
        saved = (to_reference(cfg, r1["model"].params()),
                 state_to_reference(cfg, r1["opt_state"]))
        del r1["model"], r1["opt_state"]
        gc.collect()
        torch.cuda.empty_cache()
        r2 = train.main(argv + ["--steps", "6"])
        t2 = time.perf_counter()
        got, want = leaves(r2["restored"]), leaves(saved)
        same = len(got) == len(want) and all(
            a.dtype == w.dtype and torch.equal(a, w)
            for a, w in zip(got, want))
        losses = r1["losses"] + r2["losses"]
        ok = (r1["saved_steps"] == [4] and r2["resumed_from"] == 4 and same
              and len(losses) == 6 and all(math.isfinite(x) for x in losses)
              and r2["saved_steps"] == [6] and ckpt.latest_step(str(tmp)) == 6)
        n_bytes = sum(f.stat().st_size for f in tmp.rglob("*") if f.is_file())
        print(f"[train] launch.train xlstm-350m --full: run 1 steps 1-4 in "
              f"{t1 - t0:.1f} s, saved {r1['saved_steps']}, stragglers "
              f"{r1['stragglers']}; run 2 resumed from step "
              f"{r2['resumed_from']} ({len(want)} leaves equal to run 1's: "
              f"{same}), steps 5-6 in {t2 - t1:.1f} s, saved "
              f"{r2['saved_steps']}, stragglers {r2['stragglers']}; losses "
              f"{[round(x, 4) for x in losses]}; latest committed step "
              f"{ckpt.latest_step(str(tmp))}, {n_bytes / 1e9:.2f} GB on disk")
        if not ok:
            raise AssertionError("phase 11b: launch.train did not resume as "
                                 "it must")
        out = dict(run1_s=t1 - t0, run2_s=t2 - t1, losses=losses,
                   resumed_from=r2["resumed_from"], restored_equal=same,
                   stragglers=[r1["stragglers"], r2["stragglers"]],
                   ckpt_gb=n_bytes / 1e9)
        del r2, saved
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 12: the mesh -------------------------------------------------------------

# The dry run's cells (python -m repro_torch.launch.dryrun): a dense arch's
# train step on the one-pod mesh, the MoE arch's on the two-pod mesh
# (FSDP over the pod axis; mixtral's 8 experts over 16 run token-parallel),
# and three decode steps: qwen1.5-32b's, whose int8 cache is the largest a
# rank holds (10.7 GB), mixtral's at 524k tokens on the two-pod mesh (the
# ring buffer, B = 1, the MoE in decode), and llama4's (128 experts over
# 16: expert-parallel, each rank multiplying its own 8 experts where they
# lie), and llama4's prefill of 32k tokens (its 40 heads over 16: each rank
# attends on its own 3, in query blocks of K5's plain version). Each runs
# on the CPU alone, under FakeTensorMode.
DRYRUN_CELLS = (("qwen3-14b", "train_4k", "single"),
                ("mixtral-8x7b", "train_4k", "multi"),
                ("qwen1.5-32b", "decode_32k", "single"),
                ("mixtral-8x7b", "long_500k", "multi"),
                ("llama4-maverick-400b-a17b", "decode_32k", "single"),
                ("llama4-maverick-400b-a17b", "train_4k", "single"),
                ("llama4-maverick-400b-a17b", "prefill_32k", "single"))
DRYRUN_TIMEOUT_S = 600
# Upper bounds on a cell's record (name -> (path in the record, bound)).
# llama4's decode with the experts where they lie multiplies each rank's 8
# experts on the rows of its 16 data peers (3.9e11 FLOP) and moves rows
# and partial sums, no expert weight (3.7e8 bytes); every rank multiplying
# all 128 experts, each fetched from its owner, read 6.2e12 FLOP and
# 8.2e10 bytes. Its train step reduce-scatters a rank's own 8 experts'
# gradient over data (6.97e11 bytes in all), where gathering the whole
# stack to every rank reduce-scattered 6.9e12, and its peak fits the
# card's 80 GB, where the whole f32 stack and its gradient took 157 GiB.
# Its prefill attends on a rank's 3 of 40 heads (2.74e14 FLOP a rank; all
# 40 on every rank read 2.2264e15) and holds one query block of scores at a
# time (all 40 heads' (32768, 32768) f32 scores, twice, peaked at 647 GiB).
DRYRUN_LIMITS = {
    ("llama4-maverick-400b-a17b", "decode_32k", "single"): {
        "FLOP a rank": (("hlo", "flops_per_device"), 1e12),
        "collective bytes a rank": (("hlo", "collective_bytes_per_device"),
                                    1e9)},
    ("llama4-maverick-400b-a17b", "train_4k", "single"): {
        "reduce-scatter bytes a rank": (
            ("roofline", "collectives", "reduce-scatter", "bytes"), 1e12),
        "peak live bytes a rank": (("memory_per_device", "live_bytes"),
                                   80e9)},
    ("llama4-maverick-400b-a17b", "prefill_32k", "single"): {
        "FLOP a rank": (("hlo", "flops_per_device"), 5e14),
        "peak live bytes a rank": (("memory_per_device", "live_bytes"),
                                   80e9)}}


def start_dryruns() -> list:
    """Phase 12e's subprocesses, started now (they use no card: no CUDA
    device is visible to them, one thread each) and read by
    ``finish_dryruns``."""
    import os
    out = ROOT / "build" / "phase12_dryrun"
    out.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    procs = []
    for arch, shape, mesh in DRYRUN_CELLS:
        rec, log = (out / f"{mesh}__{arch}__{shape}.{x}" for x in
                    ("json", "log"))
        rec.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out", str(rec)]
        with open(log, "w") as f:
            p = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                 env=env, cwd=ROOT)
        procs.append((arch, shape, mesh, rec, log, time.perf_counter(), p))
    return procs


def _weight_share(arch: str, mesh: str) -> float:
    """A rank's share of an arch's bf16 weights, in bytes: 2 bytes a weight
    over the ranks that split the weights (the data and model axes; the pod
    axis too above 100B weights, as the dry run plans them)."""
    from repro_torch.configs import get
    n = get(arch).param_count()
    pods = 2 if mesh == "multi" else 1
    return 2 * n / (256 * (pods if n > 100e9 else 1))


def _decode_floor(arch: str, shape_name: str, mesh: str) -> tuple:
    """(a rank's share of a decode cell's bf16 weights and of its cache,
    in bytes): ``_weight_share``, and the cache (``steps.cache_specs`` in
    the reference's KV dtype) over the ranks that split it (every rank
    where the batch splits over the data axes; the model axis alone at
    B = 1)."""
    import dataclasses
    import torch
    from repro_torch.configs import SHAPES_BY_NAME, get
    from repro_torch.distributed import steps
    from repro_torch.launch.dryrun import kv_dtype_rule
    from repro_torch._tree import leaves
    cfg, shape = get(arch), SHAPES_BY_NAME[shape_name]
    cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype_rule(cfg))
    dp = 16 * (2 if mesh == "multi" else 1)
    c_split = 16 * (dp if shape.global_batch % dp == 0 else 1)
    cache = sum(t.numel() * t.element_size()
                for t in leaves(steps.cache_specs(cfg, shape))
                if isinstance(t, torch.Tensor))
    return _weight_share(arch, mesh), cache / c_split


def finish_dryruns(procs: list) -> list:
    """Phase 12e. Fails if a cell's process fails or runs past
    DRYRUN_TIMEOUT_S (``main`` stops any still running), or if a record's
    argument bytes fall short of 90% of what a rank must hold (the leaves a
    rank holds whole only add to it): for a train cell its share of the
    f32 weights and their two moments (in the record's moment dtype: f32,
    12 bytes a weight, or bf16 for llama4, 8), over the ranks; for a
    prefill cell its share of the bf16 weights (``_weight_share``); for a
    decode cell that and its share of the cache (``_decode_floor``). A decode record also fails if its cache
    bytes are not that share, or if its peak reaches its arguments plus
    its cache: that would be a second copy of the cache (the step writes
    it in place, as the reference donates it)."""
    from repro_torch.configs import get
    recs, failed = [], []
    if procs:
        print(f"[mesh] dryrun: phases 8-11 took "
              f"{time.perf_counter() - procs[0][5]:.1f} s from the cells' "
              f"start; "
              f"{sum(p.poll() is None for *_, p in procs)} of {len(procs)} "
              f"cells still running")
    for arch, shape, mesh, rec, log, t0, p in procs:
        started = time.time() - (time.perf_counter() - t0)
        left = max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0))
        try:
            code = p.wait(timeout=left)
        except subprocess.TimeoutExpired:
            code = "timeout"
        # the cell's own wall: from its start to its record's write
        wall = (rec.stat().st_mtime - started if rec.exists()
                else time.perf_counter() - t0)
        if code != 0 or not rec.exists():
            tail = log.read_text()[-1500:] if log.exists() else ""
            failed.append(f"{arch} x {shape} x {mesh}: exit {code}\n"
                          f"{tail}")
            continue
        r = json.loads(rec.read_text())
        m, roof = r["memory_per_device"], r["roofline"]
        cache = ""
        if shape.startswith("train"):
            moment = 2 if r["moment_dtype"] == "bfloat16" else 4
            floor = (0.9 * (4 + 2 * moment) * get(arch).param_count()
                     / r["n_chips"])
        elif shape.startswith("prefill"):
            floor = 0.9 * _weight_share(arch, mesh)
        else:
            w_share, c_share = _decode_floor(arch, shape, mesh)
            floor = 0.9 * (w_share + c_share)
            if abs(m["cache_bytes"] - c_share) > 1e-6 * c_share:
                failed.append(f"{arch} x {shape} x {mesh}: cache "
                              f"{m['cache_bytes']} bytes a rank, not its "
                              f"share {c_share:.0f}")
            if m["live_bytes"] >= m["argument_bytes"] + m["cache_bytes"]:
                failed.append(f"{arch} x {shape} x {mesh}: peak "
                              f"{m['live_bytes']} reaches the arguments "
                              f"{m['argument_bytes']} plus the cache "
                              f"{m['cache_bytes']}")
            cache = (f" (its {r['kv_dtype']} cache "
                     f"{m['cache_bytes'] / 2**30:.3f} GiB)")
        if m["argument_bytes"] < floor:
            failed.append(f"{arch} x {shape} x {mesh}: arguments "
                          f"{m['argument_bytes']} bytes a rank, under "
                          f"{floor:.0f}")
        for what, (path, limit) in DRYRUN_LIMITS.get((arch, shape, mesh),
                                                    {}).items():
            got = r
            for key in path:
                got = got[key]
            if got >= limit:
                failed.append(f"{arch} x {shape} x {mesh}: {what} "
                              f"{got:.4e}, not below {limit:.0e}")
        print(f"[mesh] dryrun {arch} x {shape} x {mesh} ({r['n_chips']} "
              f"fake ranks, torch {r['torch']}, on the host CPU, "
              f"{wall:.1f} s from start): memory a device: arguments "
              f"{m['argument_bytes'] / 2**30:.2f} GiB{cache}, peak "
              f"{m['live_bytes'] / 2**30:.2f} GiB (fits 80 GB: "
              f"{m['fits_hbm_80g']}); per device {r['hlo']['flops_per_device']:.4e}"
              f" FLOP, {r['hlo']['hbm_bytes_per_device']:.4e} op-boundary "
              f"bytes, {r['hlo']['collective_bytes_per_device']:.4e} "
              f"collective bytes; roofline (data-sheet rates: 989 TFLOP/s, "
              f"3.35 TB/s, NVLink 450 GB/s) compute "
              f"{roof['compute_s'] * 1e3:.2f} ms, memory "
              f"{roof['memory_s'] * 1e3:.2f} ms, collective "
              f"{roof['collective_s'] * 1e3:.2f} ms -> {roof['dominant']};"
              f" useful-FLOP ratio {roof['useful_flop_ratio']:.3f}")
        print(f"[mesh] dryrun {arch} x {shape} x {mesh}: collectives "
              + ", ".join(f"{k} {int(v['count'])} calls {v['bytes']:.4e} "
                          f"bytes" for k, v in roof["collectives"].items()))
        recs.append(dict(arch=arch, shape=shape, mesh=mesh, wall_s=wall,
                         kv_dtype=r.get("kv_dtype"),
                         memory_per_device=m, hlo=r["hlo"],
                         roofline={k: v for k, v in roof.items()
                                   if k != "collectives"},
                         collectives=roof["collectives"]))
    if failed:
        raise AssertionError("phase 12e: dry-run cells failed:\n"
                             + "\n".join(failed))
    return recs


def drive_mesh_prefill(dev, model, cfg, toks, want, plain_ms: float) -> dict:
    """Phase 12 (a) and (b), on phase 8's model and logits. Fails unless
    the host mesh is one nccl rank of shape (1, 1), the mesh prefill
    launches K5 exactly once a layer, and its logits equal phase 8's (or
    lie within FLASH_TOL of them). The model's weights are DTensors after."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import steps
    from repro_torch.distributed.planner import shard_model
    from repro_torch.kernels import launches
    from repro_torch.launch.mesh import axis_sizes, make_host_mesh

    mesh = make_host_mesh(device=dev)
    shape = tuple(axis_sizes(mesh).items())
    print(f"[mesh] make_host_mesh(): {mesh.size()} rank, axes "
          f"{dict(shape)}, backend {dist.get_backend()}")
    if dist.get_backend() != "nccl" or shape != (("data", 1), ("model", 1)):
        raise AssertionError(f"phase 12a: host mesh {shape} on "
                             f"{dist.get_backend()}")
    before = torch.cuda.memory_allocated(dev)
    shard_model(model, mesh)
    grown = torch.cuda.memory_allocated(dev) - before
    prefill = steps.make_prefill(cfg, mesh=mesh, device=dev)
    batch = {"tokens": toks}
    prefill(model, batch)                   # first call: sharding rules
    torch.cuda.synchronize()
    launches.reset()
    got = prefill(model, batch)
    torch.cuda.synchronize()
    counts = launches.snapshot()
    if counts != {"flash_attn": cfg.n_layers}:
        raise AssertionError(f"phase 12b: the mesh prefill launched {counts};"
                             f" want flash_attn x {cfg.n_layers}")
    got = got.full_tensor()
    same = bool(torch.equal(got, want))
    diff = 0.0 if same else _close(got, want, FLASH_TOL["bfloat16"])
    t = _time_ms(lambda: prefill(model, batch), iters=5, warmup=1,
                 graph=False)
    print(f"[mesh] {_card_line()}")
    print(f"[mesh] make_prefill(mesh=...) of {LM_ARCH}, phase 8's weights "
          f"placed by params_sharding as DTensors ({grown / 1e9:.3f} GB "
          f"allocated by the placing), B={toks.shape[0]} S={toks.shape[1]}: "
          f"launches {counts}; logits "
          + ("equal to phase 8's (torch.equal)" if same else
             f"within FLASH_TOL of phase 8's (max |diff| {diff:.3e}: the "
             f"DTensor path rounds differently)")
          + f"; {t['ms']:.3f} ms a prefill beside phase 8's {plain_ms:.3f} ms"
          f" (+{t['ms'] - plain_ms:.3f} ms, "
          f"{(t['ms'] - plain_ms) / cfg.n_layers:.3f} ms a layer of DTensor "
          f"host cost)")
    return dict(mesh_shape=dict(shape), backend=dist.get_backend(),
                launches=counts["flash_attn"], equal=same, max_diff=diff,
                ms=t["ms"], phase8_ms=plain_ms, placed_bytes=grown)


def drive_mesh_decode(dev, model, cfg, toks, want: list,
                      plain_ms: float) -> dict:
    """Phase 12f, on phase 8's model (its weights DTensors on the one-rank
    nccl mesh since 12b): ``make_decode_step`` with an empty cache placed
    by ``cache_sharding``, over phase 8's decode tokens. Fails unless every
    cache tensor is a DTensor on the mesh before and after, no kernel
    launches (decode attends in plain PyTorch, as the reference), every
    step's logits equal phase 8's (torch.equal) or lie within
    MESH_DECODE_TOL of them as max |diff| / max |logit| (on one rank the
    products are phase 8's own, but the mesh's attention is the
    flash-decode, which normalizes after the p.v product in f32 where
    phase 8's ``_sdpa`` rounds the softmax weights to bf16 before it), and
    every row's top-1 token is phase 8's."""
    import torch
    from repro_torch._tree import flatten_with_paths, leaves, unflatten
    from repro_torch.distributed import shardctx, steps
    from repro_torch.distributed.planner import cache_sharding, shard_tensor
    from repro_torch.kernels import launches

    mesh = model.embedding["emb"].device_mesh
    b = toks.shape[0]

    def placed_cache():
        cache = model.init_cache(b, LM_CACHE)
        specs = flatten_with_paths(cache_sharding(cache, mesh, batch_size=b,
                                                  cfg=cfg))
        return unflatten(cache, [
            shard_tensor(t, sh) if isinstance(t, torch.Tensor) else t
            for (_, t), (_, sh) in zip(flatten_with_paths(cache), specs)])

    step = steps.make_decode_step(cfg)
    cache = placed_cache()
    placed = [t for t in leaves(cache) if isinstance(t, torch.Tensor)]
    if not all(shardctx.is_dtensor(t) and t.device_mesh is mesh
               for t in placed):
        raise AssertionError("phase 12f: a cache tensor is not on the mesh")
    launches.reset()
    got = []
    for t in range(LM_DECODE):
        lg, cache = step(model, toks[:, t:t + 1], cache)
        got.append(lg.full_tensor())
    torch.cuda.synchronize()
    counts = launches.snapshot()
    if counts or not all(shardctx.is_dtensor(t) for t in leaves(cache)
                         if isinstance(t, torch.Tensor)):
        raise AssertionError(f"phase 12f: launches {counts}, or the cache "
                             f"left the mesh")
    equal = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
    rel = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(got, want))
    top1 = float(torch.cat([(g.argmax(-1) == w.argmax(-1)).float()
                            for g, w in zip(got, want)]).mean())
    if not all(bool(torch.isfinite(g).all()) for g in got) or (
            not equal and rel > MESH_DECODE_TOL) or top1 < 1.0:
        raise AssertionError(f"phase 12f: mesh decode off phase 8's: max "
                             f"|diff| / max |logit| {rel:.4e} (bound "
                             f"{MESH_DECODE_TOL}), top-1 agreement "
                             f"{top1:.4f} (bound 1)")
    cache = placed_cache()
    it = iter(range(LM_DECODE))

    def one():
        nonlocal cache
        t = next(it)
        _, cache = step(model, toks[:, t:t + 1], cache)

    one()
    ms = _time_ms(one, iters=LM_DECODE - 1, warmup=0, graph=False)["ms"]
    print(f"[mesh] {_card_line()}")
    print(f"[mesh] make_decode_step on the mesh ({LM_ARCH}, phase 8's "
          f"weights as DTensors, a {LM_CACHE}-token cache placed by "
          f"cache_sharding, B={b}, {LM_DECODE} steps from empty): launches "
          f"{counts or 'none'}; logits "
          + ("equal to phase 8's at every step (torch.equal)" if equal else
             f"within MESH_DECODE_TOL of phase 8's (max |diff| / max "
             f"|logit| {rel:.4e}, bound {MESH_DECODE_TOL}: the flash-decode "
             f"normalizes after p.v)")
          + f"; top-1 agreement {top1:.4f} (bound 1)"
          + f"; {ms:.3f} ms a token (mean of tokens 1..{LM_DECODE - 1}) "
          f"beside phase 8's {plain_ms:.3f} ms (+{ms - plain_ms:.3f} ms of "
          f"DTensor host cost)")
    return dict(equal=equal, rel_err=rel, top1=top1, ms=ms,
                phase8_ms=plain_ms, steps=LM_DECODE, cache=LM_CACHE)


def drive_compression(dev, grads) -> dict:
    """Phase 12c, on phase 11a's gradients (one a leaf): ``compressed_psum``
    over a one-rank ``pod`` group, a leaf a call. Fails unless every
    element of the result lies within half its scale step of the gradient
    and the new error equals the gradient less q times the scale (as
    ``compress`` gives them)."""
    import torch
    from repro_torch.distributed import compression
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1,), ("pod",), device=dev)
    group = mesh.get_group("pod")
    warm = [torch.ones(8, device=dev)]
    compression.compressed_psum(warm, [torch.zeros(8, device=dev)], group)
    ms, n_el, worst_step = 0.0, 0, 0.0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for g in grads:
        err = torch.zeros_like(g, dtype=torch.float32)
        torch.cuda.synchronize()
        start.record()
        (g2,), (e2,) = compression.compressed_psum([g], [err], group)
        end.record()
        torch.cuda.synchronize()
        ms += start.elapsed_time(end)
        q, s, e_ref = compression.compress(g, err)
        off = float((g2.float() - g.float()).abs().max() / s)
        if off > 0.5 or not torch.equal(e2, e_ref):
            raise AssertionError(f"phase 12c: compressed_psum off its input "
                                 f"by {off} scale steps, or its error is not "
                                 f"g - q*s")
        worst_step = max(worst_step, off)
        n_el += g.numel()
        del err, g2, e2, q, e_ref
    # read the gradient and the carried error, write the mean and the new
    # error (f32 each), as one pass would
    nbytes = 16 * n_el
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[mesh] {_card_line()}")
    print(f"[mesh] compressed_psum over a one-rank pod group on {len(grads)} "
          f"gradient leaves of {TRAIN_ARCH} ({n_el} f32 elements): every "
          f"element within {worst_step:.3f} of a scale step of its input "
          f"(limit 0.5), the new error equal to g - q*s; {ms:.3f} ms in all "
          f"(a leaf a call), bound {bound:.3f} ms ({nbytes / 1e9:.2f} GB "
          f"read and written / 3.35 TB/s; {bound / ms:.4f} of it)")
    return dict(leaves=len(grads), elements=n_el, ms=ms, bound_ms=bound,
                worst_scale_steps=worst_step)


def lm_path(kernels: list, lm: dict, err: dict) -> None:
    """K5 bf16's entry of the kernels line takes its main path's numbers,
    phase 8's prefill (launches, and time at a layer's shapes); its numbers
    at the phase-5/6 entry point (S = 4096) move under ``entry_point``, and
    each phase-9 and phase-10 model's counted prefill (its own run, the counts set to 0
    before it) and its K5 times under ``paths[name]``."""
    k5 = next(k for k in kernels if k["name"] == "flash_attn_bfloat16")
    entry = {key: k5.pop(key) for key in
             ("launches", "ms", "eager_ms", "plain_ms", "library_ms",
              "library_max_abs_err", "bound_ms", "bound_by", "bytes", "ops",
              "tflops", "bound_share", "shape")}
    families = lm.pop("families")
    shapes = lm.pop("k5_model_shapes")
    k5.update(lm.pop("k5"), max_abs_err=err["flash_attn_bfloat16"],
              entry_point=entry, lm=lm)
    k5["paths"] = {LM_ARCH: {"launches": k5["launches"]}}
    for name, f in families.items():
        k5["paths"][name] = {"launches": f["launches"]}
        for key, t in shapes.items():
            if key.startswith(name) and isinstance(t, dict):
                k5["paths"][name][key] = t
        if name + " windowed / causal" in shapes:
            k5["paths"][name]["windowed_over_causal"] = shapes[
                name + " windowed / causal"]
    k5["families"] = families


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
    shapes = time_flash_models(dev)
    kernels.append(time_moe_grouped(dev))
    check_model(dev)
    dryruns = start_dryruns()
    try:
        return _phases_8_to_12(dev, err, kernels, shapes, dryruns)
    finally:
        for *_, p in dryruns:
            if p.poll() is None:
                p.kill()
                p.wait()


def _phases_8_to_12(dev, err: dict, kernels: list, shapes: dict,
                    dryruns: list) -> int:
    import torch
    lm = drive_lm(dev, err)
    lm["families"] = drive_lm_families(dev, err)
    lm["families"].update(drive_phase10(dev, err))
    lm["k5_model_shapes"] = shapes
    train = drive_train(dev, err)
    train["launch_train"] = drive_launch_train(dev)
    mesh = lm.pop("mesh")
    mesh["compression"] = train.pop("compression")
    mesh["dryrun"] = finish_dryruns(dryruns)
    lm_path(kernels, lm, err)
    k5 = next(k for k in kernels if k["name"] == "flash_attn_bfloat16")
    k5["paths"][TRAIN_ARCH + " trained"] = {
        "launches": train["prefill_k5_launches"],
        "train_step_launches": train["train_k5_launches"]}
    k5["paths"][LM_ARCH + " mesh prefill"] = {"launches": mesh["launches"],
                                              "ms": mesh["ms"]}
    ep = k5["families"]["llama4-maverick-400b-a17b"]["mesh"]
    k5["paths"]["llama4-maverick-400b-a17b mesh prefill"] = {
        "launches": ep["launches"], "ms": ep["prefill_ms"]}
    k5["train"] = train
    k5["mesh"] = mesh

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
