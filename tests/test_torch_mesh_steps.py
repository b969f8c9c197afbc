"""The port's steps on a mesh (``distributed.steps`` with ``mesh=``,
``planner.shard_model``) on a 4-rank (2, 2) ``("data", "model")`` gloo
mesh of CPU processes, against the JAX package's steps on a (2, 2) mesh of
4 host devices (a subprocess that sets XLA_FLAGS before importing jax),
and against the port's own unsharded step.

Both packages start from the reference's init (``params_from_numpy``) and
take one AdamW step (lr 1e-3, warmup 2, clip 1.0) on the same numpy batch
(B = 4, S = 16: the batch splits over ``data``, the sequence over
``model``).

  * reduced qwen3-14b: the sharded train step against the reference's
    sharded step (jitted); the prefill with ``seq_shard=True`` against the
    reference's sharded prefill.
  * reduced mixtral-8x7b and llama4-maverick (4 experts: tp = 2 divides
    them, so both run the MoE expert-parallel, ``moe._moe_ep``, as the
    reference pins them to ``constrain_experts``), and reduced mixtral with
    3 experts (``mixtral-8x7b-e3``: tp does not divide them, so it runs
    token-parallel, as at full size with 8 experts over 16): the sharded
    train step against the reference's
    *sharded* step (``make_train_step(mesh=...)``: its sharding hints and
    constraints active), run op by op (``jax.disable_jit()``, as
    tests/test_torch_train_moe.py runs it: compiled, XLA rounds the
    router's input and a near-tie flips an expert). Under tp = 2 both split
    each sequence into two dispatch groups (``moe_group_split``), which
    changes the capacity and so the routing: the unsharded step is the
    wrong yardstick for it. The reference's weights go in as its init made
    them, not placed by ``params_sharding``: op by op on placed weights,
    each FSDP-split contraction is summed across the 4 devices in bf16 in
    another order, which flips a router near-tie here (measured: ce 24.490
    on placed weights, 24.313 unplaced, and 24.313 for the reference with
    the group split and no mesh at all; the port's is within 2e-4 of the
    last two).
    Reduced mixtral-8x7b-e3 has a token whose router probabilities tie
    between two experts to six digits (0.273329 each, in the port's
    unsharded step and in the reference's), which the mesh's partial sums
    in another order resolve the other way (measured: loss 23.3104
    against the reference's 23.1147; the port's unsharded step on the same
    groups 23.1302). Its mesh step (``PINNED``) is pinned to the routing of
    the port's own unsharded step on the same dispatch groups
    (``moe.routing_log``: each call's experts and kept choices, the gates
    from the call's own probabilities), as tests/test_torch_mesh_decode.py
    pins its decode; the flips the pin hides are counted, at most
    MAX_FLIPS. The other MoE cases route on their own (pinned to the
    unsharded port, their mesh steps would take its near-tie picks, which
    the reference's op-by-op run does not share).
  * all: the gradient each sharded step hands to AdamW, leaf by leaf,
    against the reference's (captured by wrapping ``optim.update`` on both
    sides).
  * qwen3-14b: the port's sharded step and gradient against its own
    unsharded ones.
  * head counts tp = 2 does not divide (``UNEVEN``, prefill only): reduced
    qwen3-14b and whisper-base with 6 query heads and 3 KV heads (KV 3 over
    tp 2: each rank gathers the KV heads its 3 query heads read), qwen3
    with 5 and 5 (MHA: q, k and v split 3 + 2) and whisper with 3 and 1
    (q split 2 + 1, the one KV head gathered); whisper's encoder and cross
    attention run K5 without the mask, its cross attention with T (31
    frames) != S, and its encoder's 31 rows do not split over tp (the
    output is gathered, not moved to the sequence). The reference splits
    q's heads over tp as GSPMD pads them; the port gives each rank at most
    ceil(H/tp) query heads (``shardctx.heads_local``). Their sharded
    prefills' logits against the reference's sharded prefill and against
    the port's unsharded prefill, and each rank's K5 calls: at most
    ceil(H/tp) query heads, one KV head a query head, and the two tp ranks
    of a data rank together every head once.

Tolerances are tests/test_torch_train.py's, for the same reasons: loss
LOSS_RTOL = 2e-3 relative, the gradient's global norm GNORM_RTOL = 2e-2
relative, each param after the step PARAM_ATOL = 2.5 x lr absolute (Adam's
first update is sign-like, so an element whose gradient rounds to the
other sign moves by up to 2 x lr), each leaf's gradient LEAF_GRAD_RTOL =
0.1 relative (the worst leaf's norm of the difference over its norm); and
tests/test_torch_lm.py's logits bound, max |diff| / max |logit| <= 0.02.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_ranks

B, S = 4, 16
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
LOSS_RTOL, GNORM_RTOL = 2e-3, 2e-2
PARAM_ATOL = 2.5 * OCFG["lr"]
LEAF_GRAD_RTOL = 0.1
LOGIT_TOL = 0.02
#: The MoE cases whose mesh step routes as the port's unsharded step does
#: (module docstring)
PINNED = ("mixtral-8x7b-e3",)
#: (token, choice) picks where a MoE case's mesh step, routing on its own,
#: would choose another expert than the unsharded step it is pinned to,
#: summed over its calls (the forward and remat's recomputation)
MAX_FLIPS = 2
#: case -> (arch, config overrides), in both packages
CASES = {"qwen3-14b": ("qwen3-14b", {}),
         "mixtral-8x7b": ("mixtral-8x7b", {}),
         "llama4-maverick-400b-a17b": ("llama4-maverick-400b-a17b", {}),
         "mixtral-8x7b-e3": ("mixtral-8x7b", {"n_experts": 3})}
ARCHS = tuple(CASES)
#: prefill-only cases whose head counts tp = 2 does not divide
UNEVEN = {"qwen3-14b-h6kv3": ("qwen3-14b", {"n_heads": 6, "n_kv": 3}),
          "whisper-base-h6kv3": ("whisper-base", {"n_heads": 6, "n_kv": 3}),
          "qwen3-14b-h5kv5": ("qwen3-14b", {"n_heads": 5, "n_kv": 5}),
          "whisper-base-h3kv1": ("whisper-base", {"n_heads": 3, "n_kv": 1})}
#: whisper's encoder frames: odd, so the encoder's sequence does not split
FRAMES = 31

REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import numpy as np
    import jax
    from repro import configs, optim
    from repro.distributed import steps
    from repro.distributed.planner import params_sharding
    from repro.launch.mesh import make_mesh
    from repro.models import build

    B, S = %d, %d
    OCFG = optim.AdamWConfig(**%r)
    _update = optim.update

    def update_keeping_grads(ocfg, grads, opt_state, params):
        # the step's own gradient, before clipping, among its metrics
        p2, o2, m = _update(ocfg, grads, opt_state, params)
        return p2, o2, {**m, "grads": grads}

    optim.update = update_keeping_grads
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}

    def flat(prefix, tree):
        for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                           for q in path)
            out[prefix + key] = np.asarray(a, np.float32)

    for i, (arch, (name, over)) in enumerate(%r.items()):
        cfg = dataclasses.replace(configs.get_reduced(name), **over)
        params = build(cfg).init(jax.random.key(i))
        flat(arch + "/p0/", params)
        rng = np.random.default_rng(i)
        batch = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
                 for k in ("tokens", "labels")}
        out[arch + "/tokens"], out[arch + "/labels"] = (batch["tokens"],
                                                        batch["labels"])
        pd = jax.device_put(params, params_sharding(params, mesh))
        step = steps.make_train_step(cfg, OCFG, mesh=mesh)
        if cfg.n_experts:
            # op by op, on the weights as init made them (see docstring)
            with jax.disable_jit():
                p2, _, m = step(params, optim.init(params), batch)
        else:
            p2, _, m = jax.jit(step)(pd, optim.init(pd), batch)
        flat(arch + "/p1/", p2)
        flat(arch + "/g/", m["grads"])
        out[arch + "/loss"] = np.asarray(m["loss"])
        out[arch + "/gnorm"] = np.asarray(m["grad_norm"])
        if not cfg.n_experts:
            pre = jax.jit(steps.make_prefill(cfg, mesh=mesh, seq_shard=True))
            out[arch + "/logits"] = np.asarray(
                pre(pd, {"tokens": batch["tokens"]}))
    for i, (case, (name, over)) in enumerate(%r.items()):
        cfg = dataclasses.replace(configs.get_reduced(name), **over)
        params = build(cfg).init(jax.random.key(100 + i))
        flat(case + "/p0/", params)
        rng = np.random.default_rng(100 + i)
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        if cfg.enc_layers:
            batch["frames"] = np.asarray(jax.numpy.asarray(
                rng.standard_normal((B, %d, cfg.d_model)),
                jax.numpy.bfloat16).astype(np.float32))
        for k, a in batch.items():
            out[case + "/" + k] = a
        pd = jax.device_put(params, params_sharding(params, mesh))
        pre = jax.jit(steps.make_prefill(cfg, mesh=mesh, seq_shard=True))
        jb = {k: jax.numpy.asarray(a, jax.numpy.bfloat16 if k == "frames"
                                   else None) for k, a in batch.items()}
        out[case + "/logits"] = np.asarray(pre(pd, jb), np.float32)
    np.savez(sys.argv[1], **out)
""") % (B, S, OCFG, CASES, UNEVEN, FRAMES)


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, a in flat.items():
        *head, leaf = key.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def _tree_of(ref, arch, which):
    pre = f"{arch}/{which}/"
    return _nest({k[len(pre):]: ref[k] for k in ref.files
                  if k.startswith(pre)})


def _summed(n: int) -> int:
    """``n`` summed over the ranks."""
    import torch.distributed as dist
    t = torch.tensor([n])
    dist.all_reduce(t)
    return int(t)


def _pinned_to_the_unsharded_routing(cfg, plain, batch, mesh):
    """(pick, the picks): the port's unsharded loss and gradient on the same
    dispatch groups as the mesh step's (the sequence split in two,
    ``moe_group_split``), its routing recorded call by call (the forward,
    then remat's recomputation in the backward); ``pick(i)`` gives call
    i's experts and kept choices for this rank's groups (its two batch
    rows of the data split, its half of the sequence), for
    ``moe.routing_log``. The mesh step then routes as the unsharded one,
    where a router tie would otherwise flip an expert (module docstring)."""
    from repro_torch.distributed import shardctx, steps
    from repro_torch.models import moe
    log = []
    split = shardctx.moe_group_split
    shardctx.moe_group_split = lambda n: 2 if n % 2 == 0 else 1
    try:
        with moe.routing_log(log):
            steps.loss_and_grads(cfg, plain, batch)
    finally:
        shardctx.moe_group_split = split
    dr, mr = mesh.get_local_rank(0), mesh.get_local_rank(1)
    rows = slice(2 * dr, 2 * dr + 2)
    own = [r._replace(expert_ids=r.expert_ids.view(B, 2, S // 2, -1)[rows, mr],
                      keep=r.keep.view(B, 2, S // 2, -1)[rows, mr])
           for r in log]
    return (lambda i: (own[i].expert_ids, own[i].keep)), own


def _uneven_prefills(ref, mesh, plan, model_of):
    """``UNEVEN``'s cases: (rank 0's results, this rank's K5 calls as
    (query heads, KV heads) a call, by case)."""
    from repro_torch.distributed import steps
    from repro_torch.distributed.planner import shard_model
    from repro_torch.kernels.flash_attn import flash_mha
    from repro_torch.models import attention, encdec
    from repro_torch import configs
    calls, out, k5 = [], {}, {}

    def recorded(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2]))
        return flash_mha(q, k, v, **kw)

    for case, (name, over) in UNEVEN.items():
        cfg = dataclasses.replace(configs.get_reduced(name), **over)
        tree = _tree_of(ref, case, "p0")
        batch = {"tokens": torch.from_numpy(ref[f"{case}/tokens"])}
        if cfg.enc_layers:
            batch["frames"] = torch.from_numpy(
                ref[f"{case}/frames"]).to(torch.bfloat16)
        served = shard_model(model_of(cfg, tree), mesh, plan)
        pre = steps.make_prefill(cfg, mesh=mesh, seq_shard=True,
                                 device="cpu")
        calls.clear()
        saved = attention.flash_mha, encdec.flash_mha
        attention.flash_mha = encdec.flash_mha = recorded
        try:
            logits = pre(served, batch).full_tensor()
        finally:
            attention.flash_mha, encdec.flash_mha = saved
        k5[case] = list(calls)
        plain = steps.make_prefill(cfg, device="cpu")(model_of(cfg, tree),
                                                      batch)
        out[case] = {"logits": logits.float().numpy(),
                     "logits_plain": plain.float().numpy()}
    return out, k5


def _port(rank, world, ref_path):
    """Each rank's part; rank 0 returns the results (full tensors, gathered
    by every rank), every rank its K5 calls on ``UNEVEN``'s cases."""
    from repro_torch import configs, optim
    from repro_torch._tree import flatten_with_paths, leaves, unflatten
    from repro_torch.distributed import steps
    from repro_torch.distributed.planner import PlanConfig, shard_model
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe, params_from_numpy, to_reference

    ref = np.load(ref_path)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    update, grads = optim.update, []

    def update_keeping_grads(ocfg, g, opt_state, params):
        # the step's own gradient, before clipping
        grads.append(g)
        return update(ocfg, g, opt_state, params)

    optim.update = update_keeping_grads
    plan = PlanConfig()
    ocfg = optim.AdamWConfig(**OCFG)
    out = {}

    def model_of(cfg, tree, **kw):
        return params_from_numpy(cfg, tree, device="cpu", **kw)

    def ref_layout(cfg, tree):
        return {"/".join(p): t.double().numpy() for p, t in
                flatten_with_paths(to_reference(cfg, tree))}

    for arch, (name, over) in CASES.items():
        cfg = dataclasses.replace(configs.get_reduced(name), **over)
        tree = _tree_of(ref, arch, "p0")
        batch = {k: torch.from_numpy(ref[f"{arch}/{k}"])
                 for k in ("tokens", "labels")}
        f32 = dict(weight_dtype=torch.float32, remat=True)
        model = shard_model(model_of(cfg, tree, **f32), mesh, plan)
        step = steps.make_train_step(cfg, ocfg, mesh=mesh, device="cpu")
        log, pick, own = [], None, []
        if arch in PINNED:
            pick, own = _pinned_to_the_unsharded_routing(
                cfg, model_of(cfg, tree, **f32), batch, mesh)
        with moe.routing_log(log, pick):
            _, _, m = step(model, optim.init(model.params()), batch)
        res = {"loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
               "params": ref_layout(cfg, model.params()),
               "grads": ref_layout(cfg, grads.pop()),
               "moe_layouts": sorted({r.layout for r in log}),
               "flips": _summed(sum(int((r.expert_ids != o.expert_ids)
                                        .sum()) for r, o in zip(log, own)))}
        if arch == "qwen3-14b":
            served = shard_model(model_of(cfg, tree), mesh, plan)
            pre = steps.make_prefill(cfg, mesh=mesh, seq_shard=True,
                                     device="cpu")
            res["logits"] = pre(served, {"tokens": batch["tokens"]}
                                ).full_tensor().numpy()
            # the port's own unsharded step and gradient
            plain = model_of(cfg, tree, **f32)
            _, _, g0 = steps.loss_and_grads(cfg, plain, batch)
            res["grads_plain"] = ref_layout(cfg, unflatten(plain.params(),
                                                           g0))
            _, _, m0 = steps.make_train_step(cfg, ocfg, device="cpu")(
                plain, optim.init(plain.params()), batch)
            res["loss_plain"] = float(m0["loss"])
            res["gnorm_plain"] = float(m0["grad_norm"])
            res["params_plain"] = ref_layout(cfg, plain.params())
            sharded = shard_model(model_of(cfg, tree, **f32), mesh, plan)
            with steps._mesh_context(mesh, plan):
                _, _, g1 = steps.loss_and_grads(
                    cfg, sharded, steps._on_mesh(batch, mesh, plan),
                    constrain=steps._make_constrain(cfg, mesh, plan, True),
                    logits_sharding=steps._logits_sharding(cfg, mesh, plan))
            res["grads_mesh"] = ref_layout(
                cfg, unflatten(sharded.params(), leaves(g1)))
        out[arch] = res
    uneven, k5 = _uneven_prefills(ref, mesh, plan, model_of)
    return {**out, **uneven, "k5": k5} if rank == 0 else {"k5": k5}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_steps")
    ref_path = str(tmp / "ref.npz")
    r = subprocess.run([sys.executable, "-c", REF, ref_path],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": "src",
                            "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stdout + r.stderr
    ranks = _torch_ranks.run(_port, 4, tmp, ref_path)
    port = {**ranks[0], "k5_ranks": [r["k5"] for r in ranks]}
    return np.load(ref_path), port


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def _same_params(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def _same_grads(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    worst = max((np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k]),
                 k) for k in want)
    assert worst[0] <= LEAF_GRAD_RTOL, worst


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_the_reference_sharded_step(results,
                                                               arch):
    ref, port = results
    got = port[arch]
    assert _rel(got["loss"], ref[f"{arch}/loss"]) <= LOSS_RTOL
    assert _rel(got["gnorm"], ref[f"{arch}/gnorm"]) <= GNORM_RTOL
    want = {k[len(arch) + 4:]: ref[k] for k in ref.files
            if k.startswith(f"{arch}/p1/")}
    _same_params(got["params"], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_gradient_matches_the_reference_per_leaf(results,
                                                              arch):
    """The gradient each sharded step hands to AdamW (before clipping),
    leaf by leaf: Adam's first update moves each element by about lr
    whatever its gradient, so the params alone would not see a lost or
    reversed gradient."""
    ref, port = results
    pre = f"{arch}/g/"
    want = {k[len(pre):]: ref[k] for k in ref.files if k.startswith(pre)}
    _same_grads(port[arch]["grads"], want)


def test_sharded_prefill_matches_the_reference_sharded_prefill(results):
    ref, port = results
    got, want = port["qwen3-14b"]["logits"], ref["qwen3-14b/logits"]
    assert got.shape == want.shape == (B, S, 256)
    assert np.abs(got - want).max() / np.abs(want).max() <= LOGIT_TOL


def test_sharded_step_matches_the_ports_own_unsharded_step(results):
    _, port = results
    got = port["qwen3-14b"]
    assert _rel(got["loss"], got["loss_plain"]) <= LOSS_RTOL
    assert _rel(got["gnorm"], got["gnorm_plain"]) <= GNORM_RTOL
    _same_params(got["params"], got["params_plain"])
    _same_grads(got["grads_mesh"], got["grads_plain"])


#: The MoE layout each case takes on the (2, 2) mesh, as the reference's
#: rule ``E % tp == 0`` (``src/repro/models/moe.py:102-111``) picks it (the
#: layout every MoE call recorded in its routing, ``moe.Routing.layout``):
#: the sequence (16) splits over tp, so expert parallelism takes the
#: exchange.
MOE_LAYOUTS = {"mixtral-8x7b": "expert-parallel exchange",
               "llama4-maverick-400b-a17b": "expert-parallel exchange",
               "mixtral-8x7b-e3": "token-parallel"}


@pytest.mark.parametrize("arch", list(MOE_LAYOUTS))
def test_moe_cases_take_the_references_layout(results, arch):
    _, port = results
    assert port[arch]["moe_layouts"] == [MOE_LAYOUTS[arch]]
    assert port[arch]["flips"] <= MAX_FLIPS


def _logit_err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", list(UNEVEN))
def test_sharded_prefill_on_uneven_heads_matches_the_reference(results,
                                                               case):
    """Head counts tp 2 does not divide: the logits of the port's sharded
    prefill (ceil(H/tp) query heads a rank or fewer) against the
    reference's sharded prefill and the port's unsharded prefill."""
    ref, port = results
    got, want = port[case]["logits"], ref[f"{case}/logits"]
    assert got.shape == want.shape == (B, S, 256)
    assert _logit_err(got, want) <= LOGIT_TOL
    assert _logit_err(got, port[case]["logits_plain"]) <= LOGIT_TOL


@pytest.mark.parametrize("case", list(UNEVEN))
def test_each_ranks_k5_call_holds_its_own_heads(results, case):
    """Each rank's K5 calls (one an attention: whisper's encoder layers,
    and its decoder's self and cross attention a layer) hold at most
    ceil(H/tp) query heads, each with its own KV head (n_rep 1: the KV
    heads gathered by index); the two tp ranks of a data rank (ranks
    2d and 2d + 1 of the (2, 2) mesh) hold every head once a call."""
    from repro_torch import configs
    name, over = UNEVEN[case]
    cfg = dataclasses.replace(configs.get_reduced(name), **over)
    H, per_rank = cfg.n_heads, -(-cfg.n_heads // 2)
    n_calls = cfg.n_layers * (2 if cfg.enc_layers else 1) + cfg.enc_layers
    ranks = [r[case] for r in results[1]["k5_ranks"]]
    for calls in ranks:
        assert len(calls) == n_calls
        assert all(0 < h <= per_rank and kv == h for h, kv in calls), calls
    for d in (0, 1):
        assert [a[0] + b[0] for a, b in zip(ranks[2 * d], ranks[2 * d + 1])
                ] == [H] * n_calls
