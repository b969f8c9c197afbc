"""The port's dry run (``launch.dryrun``) and its op-stream count
(``launch.hlo_analysis``) against the JAX package's, each in a subprocess
(the port's fake process group is process-wide; the reference needs its
host devices set before jax starts).

  * the op counter: a plain matmul's FLOPs are 2MKN, an L-layer loop's
    2MKN * L (exact; the reference's trip-count test), and one all-reduce's
    and one all-gather's operand bytes on a 4-rank fake group equal the
    reference's ``_collective_operand_bytes`` of the same op (exact).
  * ``run_cell`` of reduced qwen3-14b's train step (B 8 x S 64) on a (2, 2)
    fake mesh: per-device FLOPs within 5% of the reference's
    ``analyze_hlo`` of the same cell lowered on a (2, 2) mesh of host
    devices (the bound the port was asked to meet; both count the same
    matmuls, remat's recomputation included), its argument bytes equal
    (exact) to rank 0's shards of the weights, the two Adam moments, the
    step count and the batch, counted here from the planner's specs, and
    the record's keys.

  * ``run_cell`` of reduced qwen3-14b's decode step (B 8, a cache of
    T 4096) on the same fake mesh: per-device FLOPs within 5% of the
    reference's ``analyze_hlo`` of the same cell (its decode lowering:
    ``cache_sharding``, the cache donated); its argument bytes equal
    (exact) to rank 0's shards of the bf16 weights, the cache and the
    token, counted here from the planner's specs; its peak below the
    arguments plus the rank's cache (the cache is written in place, never
    copied); and a reduced mixtral-8x7b ``long_500k`` cell (B 1, the
    window set to 32 so that the ring splits on its sequence as at full
    size) runs.

  * reduced qwen3-14b's prefill cells at S 8192 (B 2) on the same fake
    mesh with head counts tp = 2 does not divide, (H, KV) = (5, 5) and
    (6, 3) (``test_uneven_heads_prefill_counts_the_references_share``):
    FLOPs a rank against the reference's ``analyze_hlo`` of the same cell
    (its q-chunked scan, heads over tp as GSPMD pads them), and a peak
    with no (B·H, S, S) score storage.

  * reduced llama4's cells on the same fake mesh run the MoE
    expert-parallel: a decode cell's MoE FLOPs a rank are the pick's count
    from the shapes (exact), and a prefill and a train cell count their
    all-to-alls (``test_expert_parallel_cells_count_what_they_run``).

In this process: the op counter's live and peak bytes follow the
tensors' lifetimes, on real and on fake tensors (exact).
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch

FLOP_RTOL = 0.05
S, B = 64, 8

PORT = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.configs import ShapeSpec, get_reduced
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import init_group, make_mesh
    out = {}
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    out["mm"] = hlo_analysis.analyze(torch.matmul, a, b)[1].flops

    def loop(x, w, L):
        for _ in range(L):
            x = torch.tanh(x @ w)
        return x

    out["loop"] = hlo_analysis.analyze(loop, torch.randn(8, 16),
                                       torch.randn(16, 16), 5)[1].flops
    init_group("fake", world_size=4)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    import torch.distributed._functional_collectives as fc
    with hlo_analysis.OpCounter() as c:
        fc.all_reduce(torch.ones(1024), "sum", mesh.get_group("data"))
        fc.all_gather_tensor(torch.ones(256), 0, mesh.get_group("model"))
    out["coll"] = c.analysis().collectives
    out["cell"] = dryrun.run_cell(
        "qwen3-14b", "t", "single", mesh=mesh, cfg=get_reduced("qwen3-14b"),
        shape=ShapeSpec("t", %d, %d, "train"))

    # rank 0's argument bytes, from the specs alone
    from repro_torch._tree import flatten_with_paths
    from repro_torch.distributed import steps
    from repro_torch.distributed.planner import params_sharding
    from repro_torch.models import build
    cfg, shape = get_reduced("qwen3-14b"), ShapeSpec("t", %d, %d, "train")
    sizes = {"data": 2, "model": 2}

    def shard_numel(t, spec):
        n = 1
        spec = tuple(spec) + (None,) * (t.dim() - len(spec))
        for dim, e in zip(t.shape, spec):
            k = 1
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                k *= sizes[a]
            n *= -(-dim // k)
        return n

    params = build(cfg, device="cpu", weight_dtype=torch.float32).params()
    specs = dict(flatten_with_paths(params_sharding(params, mesh, cfg=cfg)))
    total = 4                                      # Adam's int32 step
    for path, t in flatten_with_paths(params):
        # the weight in its dtype, mu and nu in f32
        total += shard_numel(t, specs[path].spec) * (t.element_size() + 8)
    b_sh = steps.batch_shardings(cfg, shape, mesh)
    for k, v in steps.input_specs(cfg, shape).items():
        total += shard_numel(v, b_sh[k].spec) * v.element_size()
    out["arg_bytes"] = total
    print("RESULT" + json.dumps(out))
""") % (S, B, S, B)

REF = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.devices()
    from repro.configs import ShapeSpec, get_reduced
    from repro.launch import dryrun, hlo_analysis
    from repro.launch.hlo_analysis import Op, _collective_operand_bytes
    from repro.launch.mesh import make_mesh
    dryrun.get = get_reduced
    dryrun.SHAPES_BY_NAME = {"t": ShapeSpec("t", %d, %d, "train")}
    lowered, _ = dryrun.lower_cell("qwen3-14b", "t",
                                   make_mesh((2, 2), ("data", "model")))
    h = hlo_analysis.analyze_hlo(lowered.compile().as_text())
    groups = "replica_groups={{0,2},{1,3}}"
    ar = Op("x", "f32[1024]", "all-reduce", [], groups)
    ag = Op("y", "f32[512]", "all-gather", [], groups)
    print("RESULT" + json.dumps({
        "flops": h.flops, "all-reduce": _collective_operand_bytes(ar),
        "all-gather": _collective_operand_bytes(ag)}))
""") % (S, B)


DEC_S, DEC_B = 4096, 8

PORT_DECODE = textwrap.dedent("""
    import dataclasses, json
    import torch
    from repro_torch._tree import flatten_with_paths
    from repro_torch.configs import ShapeSpec, get_reduced
    from repro_torch.distributed import steps
    from repro_torch.distributed.planner import (cache_sharding,
                                                 params_sharding)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_group, make_mesh
    from repro_torch.models import build
    init_group("fake", world_size=4)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    cfg, shape = get_reduced("qwen3-14b"), ShapeSpec("d", %d, %d, "decode")
    out = {"cell": dryrun.run_cell("qwen3-14b", "d", "single", mesh=mesh,
                                   cfg=cfg, shape=shape)}
    sizes = {"data": 2, "model": 2}

    def shard_bytes(t, spec):
        n = 1
        spec = tuple(spec) + (None,) * (t.dim() - len(spec))
        for dim, e in zip(t.shape, spec):
            k = 1
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                k *= sizes[a]
            n *= -(-dim // k)
        return n * t.element_size()

    total = 0
    # the serving weights: bf16 matmuls, the f32 leaves f32
    params = build(cfg, device="cpu").params()
    specs = dict(flatten_with_paths(params_sharding(params, mesh, cfg=cfg)))
    for path, t in flatten_with_paths(params):
        total += shard_bytes(t, specs[path].spec)
    cache = steps.cache_specs(cfg, shape)
    c_specs = dict(flatten_with_paths(cache_sharding(
        cache, mesh, batch_size=shape.global_batch, cfg=cfg)))
    cache_bytes = 0
    for path, t in flatten_with_paths(cache):
        if isinstance(t, torch.Tensor):
            cache_bytes += shard_bytes(t, c_specs[path].spec)
    tok = steps.input_specs(cfg, shape)["token"]
    total += cache_bytes + shard_bytes(
        tok, steps.batch_shardings(cfg, shape, mesh)["token"].spec)
    out["arg_bytes"], out["cache_bytes"] = total, cache_bytes
    mix = dataclasses.replace(get_reduced("mixtral-8x7b"), window=32)
    out["long"] = dryrun.run_cell("mixtral-8x7b", "long", "single",
                                  mesh=mesh, cfg=mix,
                                  shape=ShapeSpec("long", 524288, 1,
                                                  "decode"))
    print("RESULT" + json.dumps(out))
""") % (DEC_S, DEC_B)

REF_DECODE = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.devices()
    from repro.configs import ShapeSpec, get_reduced
    from repro.launch import dryrun, hlo_analysis
    from repro.launch.mesh import make_mesh
    dryrun.get = get_reduced
    dryrun.SHAPES_BY_NAME = {"d": ShapeSpec("d", %d, %d, "decode")}
    lowered, _ = dryrun.lower_cell("qwen3-14b", "d",
                                   make_mesh((2, 2), ("data", "model")))
    h = hlo_analysis.analyze_hlo(lowered.compile().as_text())
    print("RESULT" + json.dumps({"flops": h.flops}))
""") % (DEC_S, DEC_B)


def _run(script):
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": "src",
                            "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    line = next(x for x in r.stdout.splitlines() if x.startswith("RESULT"))
    return json.loads(line[len("RESULT"):])


def test_op_counter_and_dry_run_cell_against_the_reference():
    port, ref = _run(PORT), _run(REF)
    assert port["mm"] == 2 * 64 * 32 * 16
    assert port["loop"] == 2 * 8 * 16 * 16 * 5
    assert port["coll"]["all-reduce"] == {"count": 1,
                                          "bytes": ref["all-reduce"]}
    assert port["coll"]["all-gather"] == {"count": 1,
                                          "bytes": ref["all-gather"]}
    rec = port["cell"]
    flops = rec["hlo"]["flops_per_device"]
    assert abs(flops - ref["flops"]) <= FLOP_RTOL * ref["flops"], (
        flops, ref["flops"])
    assert set(rec) == {"arch", "shape", "mesh", "n_chips", "seq_shard",
                        "remat", "moment_dtype", "accum", "lower_s",
                        "run_s", "memory_per_device", "hlo", "roofline",
                        "torch"}
    assert rec["n_chips"] == 4
    mem = rec["memory_per_device"]
    assert set(mem) == {"argument_bytes", "temp_bytes", "live_bytes",
                        "fits_hbm_80g"}
    assert mem["argument_bytes"] == port["arg_bytes"]
    assert mem["argument_bytes"] < mem["live_bytes"]
    assert mem["fits_hbm_80g"] is True
    roof = rec["roofline"]
    for k in ("compute_s", "memory_s", "collective_s", "dominant",
              "model_flops", "hlo_flops_global", "useful_flop_ratio",
              "step_time_bound_s", "roofline_fraction", "collectives",
              "unknown_trip_whiles"):
        assert k in roof
    assert roof["unknown_trip_whiles"] == 0
    assert roof["hlo_flops_global"] == flops * 4
    assert roof["collectives"]["all-gather"]["bytes"] > 0


def test_decode_cell_against_the_reference():
    port, ref = _run(PORT_DECODE), _run(REF_DECODE)
    rec = port["cell"]
    flops = rec["hlo"]["flops_per_device"]
    assert abs(flops - ref["flops"]) <= FLOP_RTOL * ref["flops"], (
        flops, ref["flops"])
    assert rec["kv_dtype"] == "bfloat16"
    mem = rec["memory_per_device"]
    assert mem["argument_bytes"] == port["arg_bytes"]
    assert mem["cache_bytes"] == port["cache_bytes"]
    assert mem["live_bytes"] < mem["argument_bytes"] + mem["cache_bytes"]
    long = port["long"]
    assert long["n_chips"] == 4 and long["kv_dtype"] == "bfloat16"
    assert long["memory_per_device"]["cache_bytes"] > 0
    assert long["hlo"]["flops_per_device"] > 0


PRE_S, PRE_B = 8192, 2
#: (H, KV) -> how the port's FLOPs a rank are held to the reference's: the
#: MHA case within FLOP_RTOL (both split q's 5 heads 3 + 2 over tp), the
#: GQA case at most 1 + FLOP_RTOL times it (GSPMD keeps 4 of 6 heads a
#: rank there, the port ceil(6/2) = 3)
PRE_HEADS = {(5, 5): "within", (6, 3): "at most"}

PORT_PREFILL = textwrap.dedent("""
    import dataclasses, json
    from repro_torch.configs import ShapeSpec, get_reduced
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_group, make_mesh
    init_group("fake", world_size=4)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    for h, kv in %r:
        cfg = dataclasses.replace(get_reduced("qwen3-14b"), n_heads=h,
                                  n_kv=kv)
        out["%%d/%%d" %% (h, kv)] = dryrun.run_cell(
            "qwen3-14b", "p", "single", mesh=mesh, cfg=cfg,
            shape=ShapeSpec("p", %d, %d, "prefill"), peak_tensors=4)
    print("RESULT" + json.dumps(out))
""") % (list(PRE_HEADS), PRE_S, PRE_B)

REF_PREFILL = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax
    jax.devices()
    from repro.configs import ShapeSpec, get_reduced
    from repro.launch import dryrun, hlo_analysis
    from repro.launch.mesh import make_mesh
    dryrun.SHAPES_BY_NAME = {"p": ShapeSpec("p", %d, %d, "prefill")}
    out = {}
    for h, kv in %r:
        dryrun.get = lambda a, h=h, kv=kv: dataclasses.replace(
            get_reduced(a), n_heads=h, n_kv=kv)
        lowered, _ = dryrun.lower_cell("qwen3-14b", "p",
                                       make_mesh((2, 2), ("data", "model")))
        out["%%d/%%d" %% (h, kv)] = hlo_analysis.analyze_hlo(
            lowered.compile().as_text()).flops
    print("RESULT" + json.dumps(out))
""") % (PRE_S, PRE_B, list(PRE_HEADS))


@pytest.fixture(scope="module")
def uneven_prefill():
    return _run(PORT_PREFILL), _run(REF_PREFILL)


@pytest.mark.parametrize("heads", list(PRE_HEADS), ids=lambda h: "%d-%d" % h)
def test_uneven_heads_prefill_counts_the_references_share(uneven_prefill,
                                                          heads):
    """A prefill cell whose head counts tp 2 does not divide: the port's
    attention runs on each rank's ceil(H/tp) query heads
    (``shardctx.heads_local``), as the reference's q-chunked scan runs on
    its share of the heads, and K5's plain version holds one query block
    of scores at a time, as the scan holds one tile. FLOPs a rank: within
    FLOP_RTOL of the reference's (MHA) or at most 1 + FLOP_RTOL times it
    (GQA: GSPMD keeps more heads). Memory: no storage at the peak holds
    (B/dp)·H·S·S elements (the rank's rows of every head's scores, which
    the plain version held whole before it took query blocks, twice over:
    its product and the product scaled), and the peak's temporaries stay
    below one such f32 matrix, so the peak is below that earlier one's by
    at least one."""
    port, ref = uneven_prefill
    key = "%d/%d" % heads
    rec, want = port[key], ref[key]
    flops = rec["hlo"]["flops_per_device"]
    if PRE_HEADS[heads] == "within":
        assert abs(flops - want) <= FLOP_RTOL * want, (flops, want)
    else:
        assert flops <= (1 + FLOP_RTOL) * want, (flops, want)
    scores = PRE_B // 2 * heads[0] * PRE_S * PRE_S
    mem = rec["memory_per_device"]
    largest = mem["at_peak"]["largest"]
    assert all(math.prod(d["shape"]) < scores for d in largest), largest
    assert mem["temp_bytes"] < 4 * scores, mem
    assert mem["fits_hbm_80g"] is True


EP_B, EP_S = 8, 64

PORT_EP = textwrap.dedent("""
    import json
    from repro_torch.configs import ShapeSpec, get_reduced
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import init_group, make_mesh
    from repro_torch.models import moe
    init_group("fake", world_size=4)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    cfg = get_reduced("llama4-maverick-400b-a17b")
    counters, moe_flops = [], []
    enter = hlo_analysis.OpCounter.__enter__

    def entered(self):
        counters.append(self)
        return enter(self)

    forward = moe.moe_forward

    def counted(*a, **k):
        before = counters[-1].flops
        out = forward(*a, **k)
        moe_flops.append(counters[-1].flops - before)
        return out

    hlo_analysis.OpCounter.__enter__ = entered
    moe.moe_forward = counted
    out = {}
    for kind, S in (("decode", %d), ("prefill", %d), ("train", %d)):
        moe_flops.clear()
        rec = dryrun.run_cell(cfg.name, kind, "single", mesh=mesh, cfg=cfg,
                              shape=ShapeSpec(kind, S, %d, kind))
        out[kind] = {"flops": rec["hlo"]["flops_per_device"],
                     "collectives": rec["roofline"]["collectives"],
                     "moe_flops": list(moe_flops)}
    print("RESULT" + json.dumps(out))
""") % (DEC_S, EP_S, EP_S, EP_B)


def test_expert_parallel_cells_count_what_they_run():
    """Reduced llama4 (4 experts, top-1, the shared expert; tp 2 divides E)
    on the (2, 2) fake mesh. Decode (B 8): every MoE layer's FLOPs a rank
    are the expert-parallel pick's, worked out from the shapes: the rows of
    both data ranks (R = B, all-gathered over data, which splits the stacks'
    d) times each of the rank's E/tp experts on its d/2 columns (wg, wu)
    and f/2 rows (wd), the router on the R rows in f32, and the shared
    expert's three products on the stationary layout (rows all-to-all'd
    into d/2 columns for wg and wu, gathered over data for wd: R rows x
    (d/2 x f/2) each). Prefill and train (S 64 over tp): two all-to-alls
    a MoE layer forward (the exchange and its return), two more backward
    and two more where remat runs the forward again."""
    from repro_torch import configs
    cfg = configs.get_reduced("llama4-maverick-400b-a17b")
    port = _run(PORT_EP)
    d, f, E, dp, tp = cfg.d_model, cfg.d_ff, cfg.n_experts, 2, 2
    R = EP_B
    experts = (E // tp) * (2 * 2 * R * (d // dp) * f + 2 * R * (f // dp) * d)
    router = 2 * R * d * E
    shared = 3 * 2 * R * (d // dp) * (f // tp)
    n_moe = sum(k == "attn_moe" for k in cfg.pattern) * cfg.n_groups
    dec = port["decode"]
    assert dec["moe_flops"] == [experts + router + shared] * n_moe
    assert dec["flops"] > sum(dec["moe_flops"])
    assert "all-to-all" not in dec["collectives"]
    assert port["prefill"]["collectives"]["all-to-all"]["count"] == 2 * n_moe
    assert port["train"]["collectives"]["all-to-all"]["count"] == 6 * n_moe


@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
def test_op_counter_live_bytes_follow_the_tensors(fake):
    """A storage is live while any tensor on it is (a view keeps it), and
    is freed with the last one; the peak is the most live at once."""
    import contextlib
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.hlo_analysis import OpCounter
    kib4 = 1024 * 4
    with FakeTensorMode() if fake else contextlib.nullcontext():
        x = torch.ones(1024)
        with OpCounter() as c:
            c.track({"x": x, "again": [x]})
            assert c.live == kib4
            y = x * 2
            v = y.view(32, 32)
            del y
            z = v + 1
            assert c.live == c.peak == 3 * kib4
            del v
            assert c.live == 2 * kib4
            w = z * 3
            del z, w
            assert c.live == kib4
    assert c.peak == 3 * kib4


@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
def test_op_counter_lists_what_was_live_at_the_peak(fake):
    """``OpCounter(at_peak=True)`` lists the storages live when the live
    bytes were at their peak (largest first, with the op that made each),
    not those of a later, lower high: here x, y and z at the peak; w comes
    after y is freed and stays below it."""
    import contextlib
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.hlo_analysis import OpCounter
    with FakeTensorMode() if fake else contextlib.nullcontext():
        x = torch.ones(1024)
        with OpCounter(at_peak=True) as c:
            c.track(x)
            y = x.repeat(4)
            z = torch.cat([x, x]).view(32, 64)
            del y
            w = x + 1
            got, every = c.at_peak(2), c.at_peak(3)
            del z, w
        assert c.peak == (1 + 4 + 2) * 4096
    assert got["count"] == 3 and got["rest_bytes"] == 4096
    assert [(d["bytes"], d["op"]) for d in got["largest"]] == [
        (4 * 4096, "repeat"), (2 * 4096, "cat")]
    assert every["largest"][2]["op"] == "argument"
    assert got["largest"][0]["shape"] == [4096]
    assert got["largest"][0]["dtype"] == "torch.float32"
    with pytest.raises(ValueError):
        OpCounter().at_peak()


def test_op_counter_counts_no_bytes_for_a_device_query():
    """A fake tensor asks its device (``prim.device``, an op under a
    dispatch mode) around a view of it, as the dry run's DeviceMesh does
    at every ``mesh.mesh``; the query reads no element and adds no
    op-boundary bytes (it counted the tensor's bytes: 4.30e9 of mixtral
    ``long_500k``'s 6.41e9 on (2, 16, 16) were such queries). A view adds
    none either; an op that writes a tensor adds its bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.hlo_analysis import OpCounter
    with FakeTensorMode():
        y = torch.ones(1024)
        with OpCounter() as c:
            y[0]
            assert y.device.type == "cpu"
        assert c.hbm_bytes == 0
        with OpCounter() as c:
            y * 2
        assert c.hbm_bytes == 2 * 4 * 1024
