"""Multi-pod dry run: the JAX package's ``src/repro/launch/dryrun.py``.

Proves the distribution config is coherent without hardware: for an
(architecture x input shape x mesh) cell, the port's step (``steps``) runs
once on the production mesh — (16, 16) or (2, 16, 16) ranks of the ``fake``
process group (``launch.mesh``), in one process — under
``FakeTensorMode``, so that no weight, batch or activation is allocated,
and every rank-0 op and collective is counted (``hlo_analysis``). That
gives the per-device FLOPs, HBM bytes and collective bytes of the
reference's roofline, and the per-device memory: the arguments (weights,
optimizer state, batch: the local shards) and the peak of the live bytes
while the step runs. It uses no card and runs anywhere.

What has no counterpart, and is left out: the reference's
``xla_cost_analysis`` (XLA's own one-iteration count), ``hlo_chars`` and
``hlo_path`` (there is no HLO text), and the ``*_bf16adj`` memory figures
(they undo the CPU backend's f32 copies of bf16 operands, which an eager
op stream does not make). The memory keys name the H100's 80 GB
(``fits_hbm_80g``). A prefill cell's attention is K5's plain version here
(no card), on each rank's own heads (``shardctx.heads_local``: ceil(H/tp)
query heads at most, as the reference's scan runs on its padded share of
the heads), in query blocks of at most 512 rows against all T keys: the
scores live at a time are one (B*H_local, 512, T) f32 block, as the
reference's scan holds one tile and K5 none, and its FLOPs are the dense
count, every (s, t) pair, as the scan's are. A decode cell takes the reference's KV dtype rule (int8
for ``n_kv >= 32`` or ``n_experts >= 64``: qwen1.5-32b and llama4, and
minicpm3-4b, whose MLA latent cache stays bf16 all the same), bf16
weights, and its cache (``steps.cache_specs``) placed by
``cache_sharding``; the step writes the cache in place, the counterpart
of the reference's donated cache, so its arguments are the weights' and
the cache's shards and the token, and its peak holds no second cache
(``memory_per_device.cache_bytes`` is the rank's share of the cache). A
fake tensor holds no routing to count, so the MoE layer dispatches
statically here (``_full_capacity``): every expert computes its full
capacity, as the reference's (E, G, C) dispatch does.

The roofline divides by the H100's data-sheet rates (``core.h100_model``:
bf16 tensor cores, HBM, and NVLink 4 one way for the collective term),
not by measurements.

Usage:
    # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen3-14b --shape train_4k --mesh single --out cell.json
    # the sweep on both meshes (a subprocess a cell; decode cells included)
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep \\
        --outdir build/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch import optim
from repro_torch._tree import flatten_with_paths, leaves, unflatten
from repro_torch.configs import (ARCH_NAMES, SHAPES, SHAPES_BY_NAME,
                                 cell_runnable, get)
from repro_torch.core import h100_model
from repro_torch.distributed import steps
from repro_torch.distributed.planner import (PlanConfig, cache_sharding,
                                             shard_model, shard_tensor)
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import axis_names, make_production_mesh
from repro_torch.models import build

HBM_PER_CHIP = h100_model.HBM_BYTES          # H100 SXM: 80 GB


# ---------------------------------------------------------------------------
# lowering one cell
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _fake_mode(mode):
    """``mode`` entered, with DTensor's ``_StridedShard`` computing its shard
    offsets on real tensors: it builds an index tensor and reads it back
    (``tolist``), which a FakeTensorMode would fake and refuse to read. A
    sequence-parallel activation meets it at every matmul."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    cls = getattr(placement_types, "_StridedShard", None)
    orig = cls.__dict__.get("local_shard_size_and_offset") if cls else None

    def real(*a, **k):
        with unset_fake_temporarily():
            return orig.__get__(None, cls)(*a, **k) if isinstance(
                orig, staticmethod) else orig(*a, **k)

    if orig is not None:
        setattr(cls, "local_shard_size_and_offset",
                staticmethod(real) if isinstance(orig, staticmethod)
                else real)
    try:
        with mode:
            yield
    finally:
        if orig is not None:
            setattr(cls, "local_shard_size_and_offset", orig)


def _full_capacity(r, x, cfg):
    """``moe.dispatch`` for fake tensors, which hold no routing to count:
    every expert takes its full queue, C slots a group, as the reference's
    static (E, G, C) dispatch computes them all. Only the fields the loop
    reads are real: ``counts`` (E,) and the E·G·C rows' tokens and
    weights."""
    from repro_torch.models import moe
    n = x.shape[0] * r.capacity
    counts = torch.full((cfg.n_experts,), n, dtype=torch.long,
                        device=x.device)
    token = torch.zeros(cfg.n_experts * n, dtype=torch.long, device=x.device)
    return moe.Dispatch(counts, counts, token,
                        torch.zeros(token.shape, device=x.device), token)


def _full_counts(d):
    """``moe.held_counts`` for ``_full_capacity``'s dispatch: its counts
    are known without reading the (fake) tensor."""
    E = d.counts.shape[0]
    return [d.token.shape[0] // E] * E


@contextlib.contextmanager
def _static_moe_dispatch():
    """``models.moe`` dispatches by ``_full_capacity`` while entered."""
    from repro_torch.models import moe
    saved = moe.dispatch, moe.held_counts
    moe.dispatch, moe.held_counts = _full_capacity, _full_counts
    try:
        yield
    finally:
        moe.dispatch, moe.held_counts = saved


@dataclasses.dataclass
class Lowered:
    """A cell's step with its fake arguments, ready to run once."""
    fn: Any
    args: tuple
    fake_mode: Any

    def run(self, peak_tensors: int = 0):
        """(HLOAnalysis, argument bytes, peak live bytes, what was live at
        the peak or None) of one run. The arguments are the weights and
        every other argument (the optimizer state and the batch; the token
        and the cache). With ``peak_tensors`` the largest that many
        storages live at the peak are listed (``OpCounter.at_peak``)."""
        model, *rest = self.args
        with _fake_mode(self.fake_mode), _static_moe_dispatch(), \
                hlo_analysis.OpCounter(at_peak=peak_tensors > 0) as c:
            c.track((model.params(), *rest))
            arg_bytes = c.live
            self.fn(*self.args)
        return (c.analysis(), arg_bytes, c.peak,
                c.at_peak(peak_tensors) if peak_tensors else None)


def kv_dtype_rule(cfg) -> str:
    """The reference's decode KV dtype: int8 (the paper's power-of-two
    scheme) for the caches whose bf16 size exceeds a pod's HBM."""
    return "int8" if cfg.n_kv >= 32 or cfg.n_experts >= 64 else "bfloat16"


def _local_bytes(tree) -> int:
    """The bytes of this rank's shards of a tree's tensors."""
    return sum(t.to_local().numel() * t.element_size()
               if hasattr(t, "to_local") else t.numel() * t.element_size()
               for t in leaves(tree) if isinstance(t, torch.Tensor))


def lower_cell(arch: str, shape_name: str, mesh, *,
               seq_shard: bool = True, remat: bool = True,
               moment_dtype: str = "float32", accum: int = 1,
               kv_dtype: Optional[str] = None, cfg=None, shape=None):
    """Build the cell's step and its arguments on ``mesh`` under
    ``FakeTensorMode``. Returns (lowered, meta). ``cfg`` and ``shape``
    override the config and the ShapeSpec (tests use reduced ones);
    ``kv_dtype`` a decode cell's ``kv_dtype_rule``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    shape = shape or SHAPES_BY_NAME[shape_name]
    cfg = cfg or get(arch)
    if shape.kind == "decode":
        cfg = dataclasses.replace(
            cfg, kv_cache_dtype=kv_dtype or kv_dtype_rule(cfg))
    # >=100B params: extend ZeRO-3 sharding across the pod axis
    if "pod" in axis_names(mesh) and cfg.param_count() > 100e9:
        plan = PlanConfig(fsdp_axis=("pod", "data"))
    else:
        plan = PlanConfig()
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with _fake_mode(fake):
        # serving tiers deploy bf16 weights; training holds f32
        model = build(cfg, device="cpu", remat=remat,
                      weight_dtype=(torch.float32 if shape.kind == "train"
                                    else torch.bfloat16))
        shard_model(model, mesh, plan)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                 for k, v in steps.input_specs(cfg, shape).items()}
        b_sh = steps.batch_shardings(cfg, shape, mesh, plan)
        batch = {k: shard_tensor(v, b_sh[k]) for k, v in batch.items()}
        if shape.kind == "train":
            ocfg = optim.AdamWConfig(moment_dtype=moment_dtype)
            opt = optim.init(model.params(), getattr(torch, moment_dtype))
            fn = steps.make_train_step(cfg, ocfg, mesh=mesh, plan=plan,
                                       seq_shard=seq_shard, accum=accum,
                                       device="cpu")
            args = (model, opt, batch)
        elif shape.kind == "prefill":
            fn = steps.make_prefill(cfg, mesh=mesh, plan=plan,
                                    seq_shard=seq_shard, device="cpu")
            args = (model, batch)
        else:
            cache = steps.cache_specs(cfg, shape)
            specs = flatten_with_paths(cache_sharding(
                cache, mesh, plan, batch_size=shape.global_batch, cfg=cfg))
            cache = unflatten(cache, [
                shard_tensor(torch.zeros(t.shape, dtype=t.dtype), sh)
                if isinstance(t, torch.Tensor) else t
                for (_, t), (_, sh) in zip(flatten_with_paths(cache), specs)])
            fn = steps.make_decode_step(cfg)
            args = (model, batch["token"], cache)
    return Lowered(fn, args, fake), {"cfg": cfg, "shape": shape}


# ---------------------------------------------------------------------------
# roofline terms from the counted run
# ---------------------------------------------------------------------------

def roofline_terms(hlo: hlo_analysis.HLOAnalysis, n_chips: int,
                   cfg, shape) -> Dict[str, Any]:
    compute_s = hlo.flops / h100_model.PEAK_BF16_FLOPS
    memory_s = hlo.hbm_bytes / h100_model.HBM_BW
    collective_s = hlo.collective_bytes / h100_model.NVLINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens, factor = shape.global_batch * shape.seq_len, 6
    elif shape.kind == "prefill":
        tokens, factor = shape.global_batch * shape.seq_len, 2
    else:
        tokens, factor = shape.global_batch, 2
    model_flops = factor * n_active * tokens
    hlo_flops_global = hlo.flops * n_chips
    bound_s = max(terms.values())
    ideal_s = model_flops / (n_chips * h100_model.PEAK_BF16_FLOPS)
    return {
        **terms,
        "dominant": dominant,
        "model_flops": model_flops,
        "hlo_flops_global": hlo_flops_global,
        "useful_flop_ratio": (model_flops / hlo_flops_global
                              if hlo_flops_global else None),
        "step_time_bound_s": bound_s,
        #: fraction of pure-compute roofline achieved if the step runs at
        #: its dominant-term bound
        "roofline_fraction": ideal_s / bound_s if bound_s else None,
        "collectives": hlo.collectives,
        "unknown_trip_whiles": hlo.unknown_trip_whiles,
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             seq_shard: bool = True, remat: bool = True,
             moment_dtype: str = "float32", accum: int = 1,
             kv_dtype: Optional[str] = None, peak_tensors: int = 0,
             mesh=None, cfg=None, shape=None) -> Dict[str, Any]:
    """One cell's record. ``mesh`` (default: the production mesh of
    ``mesh_kind``), ``cfg`` and ``shape`` override the cell's. A decode
    record adds ``kv_dtype`` and the rank's cache bytes; ``peak_tensors``
    adds ``memory_per_device.at_peak``, the largest that many storages
    live at the peak."""
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=(mesh_kind == "multi"))
    n_chips = mesh.size()
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind, "n_chips": n_chips,
                           "seq_shard": seq_shard, "remat": remat,
                           "moment_dtype": moment_dtype, "accum": accum}
    t0 = time.time()
    lowered, meta = lower_cell(arch, shape_name, mesh, seq_shard=seq_shard,
                               remat=remat, moment_dtype=moment_dtype,
                               accum=accum, kv_dtype=kv_dtype, cfg=cfg,
                               shape=shape)
    rec["lower_s"] = round(time.time() - t0, 2)
    t0 = time.time()
    hlo, arg_bytes, peak, at_peak = lowered.run(peak_tensors)
    rec["run_s"] = round(time.time() - t0, 2)
    rec["memory_per_device"] = {
        "argument_bytes": int(arg_bytes),
        "temp_bytes": int(peak - arg_bytes),
        "live_bytes": int(peak),
        "fits_hbm_80g": bool(peak <= HBM_PER_CHIP)}
    if at_peak is not None:
        rec["memory_per_device"]["at_peak"] = at_peak
    if meta["shape"].kind == "decode":
        rec["kv_dtype"] = meta["cfg"].kv_cache_dtype
        with _fake_mode(lowered.fake_mode):
            rec["memory_per_device"]["cache_bytes"] = _local_bytes(
                lowered.args[2])
    rec["hlo"] = {"flops_per_device": hlo.flops,
                  "hbm_bytes_per_device": hlo.hbm_bytes,
                  "collective_bytes_per_device": hlo.collective_bytes}
    rec["roofline"] = roofline_terms(hlo, n_chips, meta["cfg"], meta["shape"])
    rec["torch"] = torch.__version__
    return rec


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _print_summary(rec: Dict[str, Any]) -> None:
    r = rec.get("roofline", {})
    mem = rec.get("memory_per_device", {})
    print(f"[dryrun] {rec['arch']} x {rec['shape']} x {rec['mesh']}"
          f" ({rec['n_chips']} chips):"
          f" lower {rec.get('lower_s')}s run {rec.get('run_s')}s")
    if mem:
        cache = (f" (cache {mem['cache_bytes']/2**30:.2f} GiB,"
                 f" {rec['kv_dtype']})" if "cache_bytes" in mem else "")
        print(f"  mem/device: args {mem['argument_bytes']/2**30:.2f} GiB"
              f"{cache}, temps {mem['temp_bytes']/2**30:.2f} GiB,"
              f" fits 80G HBM: {mem['fits_hbm_80g']}")
        for d in mem.get("at_peak", {}).get("largest", []):
            print(f"    at peak: {d['bytes']/2**30:.3f} GiB {d['dtype']}"
                  f" {tuple(d['shape'])} from {d['op']}")
    if r:
        print(f"  roofline: compute {r['compute_s']*1e3:.3f} ms,"
              f" memory {r['memory_s']*1e3:.3f} ms,"
              f" collective {r['collective_s']*1e3:.3f} ms"
              f" -> dominant: {r['dominant']}")
        print(f"  useful-FLOP ratio {r['useful_flop_ratio']:.3f},"
              f" roofline fraction {r['roofline_fraction']:.3f}")


def _sweep(outdir: str, mesh_kinds, archs, shapes) -> int:
    os.makedirs(outdir, exist_ok=True)
    failures = 0
    for mesh_kind in mesh_kinds:
        for arch in archs:
            for shape in shapes:
                cfg = get(arch)
                ok, reason = cell_runnable(cfg, SHAPES_BY_NAME[shape])
                out = os.path.join(
                    outdir, f"{mesh_kind}__{arch}__{shape}.json")
                if not ok:
                    with open(out, "w") as f:
                        json.dump({"arch": arch, "shape": shape,
                                   "mesh": mesh_kind, "skipped": reason},
                                  f, indent=1)
                    print(f"[dryrun] SKIP {arch} x {shape}: {reason}")
                    continue
                if os.path.exists(out):
                    with open(out) as f:
                        prev = json.load(f)
                    if prev.get("ok"):
                        print(f"[dryrun] cached {arch} x {shape} x "
                              f"{mesh_kind}")
                        continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape,
                       "--mesh", mesh_kind, "--out", out]
                print(f"[dryrun] RUN {' '.join(cmd[3:])}", flush=True)
                r = subprocess.run(cmd, capture_output=True, text=True)
                if r.returncode != 0:
                    failures += 1
                    err = (r.stderr or "")[-3000:]
                    with open(out, "w") as f:
                        json.dump({"arch": arch, "shape": shape,
                                   "mesh": mesh_kind, "ok": False,
                                   "error": err}, f, indent=1)
                    print(f"[dryrun] FAIL {arch} x {shape} x {mesh_kind}:\n"
                          f"{err}", flush=True)
                else:
                    sys.stdout.write(r.stdout)
                    sys.stdout.flush()
    return failures


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list(ARCH_NAMES))
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--out", default=None, help="write the cell JSON here")
    ap.add_argument("--sweep", action="store_true",
                    help="run every runnable (arch x shape) cell")
    ap.add_argument("--meshes", default="single,multi",
                    help="sweep mesh kinds, comma-separated")
    ap.add_argument("--archs", default=None,
                    help="sweep subset, comma-separated")
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--outdir", default="build/dryrun")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--moment-dtype", default=None,
                    help="override Adam moment dtype (default: f32; "
                    "llama4 train uses bf16)")
    ap.add_argument("--accum", type=int, default=0,
                    help="gradient-accumulation microbatches for train "
                    "cells (0 = per-arch default)")
    ap.add_argument("--kv-dtype", choices=["bfloat16", "int8"], default=None,
                    help="override a decode cell's KV cache dtype (default: "
                    "the reference's rule, kv_dtype_rule)")
    ap.add_argument("--peak-tensors", type=int, default=0,
                    help="list the largest N storages live at the peak "
                    "(memory_per_device.at_peak)")
    args = ap.parse_args(argv)

    if args.sweep:
        archs = args.archs.split(",") if args.archs else list(ARCH_NAMES)
        shapes = (args.shapes.split(",") if args.shapes
                  else [s.name for s in SHAPES])
        n_fail = _sweep(args.outdir, args.meshes.split(","), archs, shapes)
        sys.exit(1 if n_fail else 0)

    assert args.arch and args.shape, "--arch/--shape required (or --sweep)"
    # default moment dtype: bf16 for the 400B MoE, f32 else
    mdt = args.moment_dtype or (
        "bfloat16" if args.arch == "llama4-maverick-400b-a17b" else "float32")
    # per-arch default accumulation: wide/deep archs microbatch 4x, mid 2x
    cfg = get(args.arch)
    if args.accum:
        accum = args.accum
    elif cfg.d_model >= 8192 or cfg.n_experts >= 64:
        accum = 4
    elif cfg.d_model >= 2048:
        accum = 2
    else:
        accum = 1
    try:
        rec = run_cell(args.arch, args.shape, args.mesh,
                       seq_shard=not args.no_seq_shard,
                       remat=not args.no_remat, moment_dtype=mdt,
                       accum=accum, kv_dtype=args.kv_dtype,
                       peak_tensors=args.peak_tensors)
        rec["ok"] = True
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "ok": False, "error": traceback.format_exc()[-4000:]}
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rec, f, indent=1)
        raise
    _print_summary(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
