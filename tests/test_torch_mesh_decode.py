"""The port's decode step on a mesh (``distributed.steps.make_decode_step``
with the weights placed by ``planner.shard_model`` and the cache by
``planner.cache_sharding``) on a 4-rank (2, 2) ``("data", "model")`` gloo
mesh of CPU processes, against the JAX package's decode step jitted on a
(2, 2) mesh of 4 host devices under ``params_sharding`` / ``cache_sharding``
with the cache donated (its dry run's lowering; a subprocess that sets
XLA_FLAGS before importing jax), and against the port's own unsharded
decode.

One case a family of cache leaves, reduced, B = 4, each decoding from an
empty cache of T = 32 for T + 3 steps (40 for a ring of 32, which wraps;
8 for xlstm, whose states have no length), so that each rank writes its
shard, the second rank of the sequence split starts with every key of its
shard masked, and the writes clamp past the end:
  * qwen3-14b (GQA), and with ``kv_cache_dtype="int8"``;
  * mixtral-8x7b and recurrentgemma-2b with the window set to 32 in both
    packages (reduced, it is 8: the ring (4, 8, KV, 16) would split its
    head dim, not the sequence dim it splits at full size);
  * minicpm3-4b (MLA: ``c_kv`` (4, 32, 16) and ``k_rope`` split on T);
  * xlstm-350m (mLSTM and sLSTM states split on their feature dim);
  * whisper-base with 31 encoder frames, so that the cross K/V split on the
    head dim as at full size (1500 frames do not divide 16), and its self
    cache on the sequence;
  * llama4-maverick (4 experts, top-1, the shared expert) and mixtral-8x7b
    (4 experts) run the MoE expert-parallel (tp = 2 divides E: each rank
    multiplies its own experts where they lie, ``moe._moe_ep``), as
    llama4's 128 experts over 16 do at full size; mixtral-8x7b-e3 (3
    experts, window 32) keeps the token-parallel decode
    (``moe._moe_stationary``), as mixtral's 8 experts over 16 do.

Both packages start from the same weights (the port's init, each norm scale
and bias perturbed, in the reference's layout) and decode the same numpy
tokens. Tolerances, as max |diff| / max |logit| at every step:
  * against the reference: LOGIT_TOL = 0.02 (tests/test_torch_lm.py's).
    Past the end of a cache without a window, the reference's decode
    writes the new K/V at the last slot (``dynamic_update_slice`` clamps
    its start), jitted or not; its lowering under ``cache_sharding``
    (the sequence split over ``model``) drops that write instead, the slot
    keeping the previous token's entry (measured: the last slot equal to
    the one 32 steps gave, logits 0.04-0.13 of the largest away from the
    unsharded decode's at steps 33-35). The port's mesh decode clamps, as
    the reference's own function does: it is held to the sharded lowering
    for the first T steps and to the reference's decode jitted without
    shardings at every step.
    xlstm runs from the f32 embedding rows (``embeds``), as
    tests/test_torch_lm.py runs it and for its reason: its reduced model
    amplifies one bf16 ulp some 30-fold. In f32 it is held to F32_TOL =
    1e-4, against the reference and the unsharded decode alike (measured
    1.8e-5 and 1.6e-5: the partial sums' order across ranks).
  * the MoE cases against the reference: MOE_LOGIT_TOL = 0.04 at every
    step, the reference run op by op (``jax.disable_jit()``), as
    tests/test_torch_mesh_steps.py runs it: compiled, XLA rounds the
    router's input otherwise. Even op by op the two packages round the
    router's input apart, and a near-tie can send a token to another
    expert, which moves that step's logits by order 1. So the reference's
    picks are recorded (its router lines on the same x, in a wrapper of
    its ``moe_forward``; the MoE cases' reference runs before the port's
    ranks) and both port decodes, unsharded and on the mesh, route every
    MoE call to them through ``moe.routing_log``, the gates from their own
    probabilities. Where a decode's own router would have chosen otherwise
    must be a near-tie (chip_smoke.py's MOE_MAX_FLIPS = 2 (token, layer,
    step) choices a run at most, each within MOE_TIE_MARGIN = 0.02 of its
    own probabilities: measured, reduced llama4's unsharded decode at steps
    10 and 23, 5.9e-3 and 4.4e-4, its mesh decode at the same two, 1.11e-2
    and 3.5e-3; the mixtral cases at none).
  * against the port's unsharded decode: MESH_TOL = 0.015 (chip_smoke.py's
    MESH_DECODE_TOL, which gates its one-rank mesh decode too), the same
    function in another order: the flash-decode's combine normalizes after
    the p.v product in f32 where ``_sdpa`` rounds the softmax weights to
    bf16 before it, and the products' f32 partial sums are summed across
    ranks in another order (measured 0.006 qwen3, minicpm3; 0.009
    whisper; 0.013 int8, where a k that rounds apart moves by a whole
    int8 step; 0.013 recurrentgemma, whose recurrence carries it). The
    reference's own sharded and unsharded decodes differ by as much
    (0.016 int8, 0.015 recurrentgemma). MoE: MOE_MESH_TOL = 0.025
    (measured 0.018); the two runs route the same tokens (both pinned to
    the reference's picks; where the mesh's own router and the unsharded
    one's chose apart is counted too: at most MAX_FLIPS choices).
recurrentgemma and xlstm then run RANDOM_STEPS more steps of both decodes
from one random state (the mLSTM normaliser ``n`` scaled by N_SCALE, so
that the read-out's clamp max(|q . n|, 1) does not hide a lost partial sum
over tp), held to the unsharded decode at the bounds above, logits and
states.
Every step, on every rank, every leaf split on its sequence dim is bit-equal
to its state before the step except at the slot the rank owns and wrote.
Each reduced leaf's spec class (which dim tp splits) is the one the same
leaf takes at full size on the (16, 16) mesh, and the full-size classes are
these: K/V and MLA latents on the sequence, whisper's cross K/V on the head
dim, recurrent states on their feature dim (recurrentgemma's tail ``h``,
(B, 2560) unstacked, whole at both sizes). A leaf placed any other way
raises.
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


def _load_chip_smoke():
    """chip_smoke.py as a module (its top level defines constants only):
    its phase 12f holds the mesh decode to MESH_TOL as this test does."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_chip_smoke = _load_chip_smoke()

B, T = 4, 32
LOGIT_TOL, MOE_LOGIT_TOL = 0.02, 0.04
MESH_TOL, MOE_MESH_TOL = _chip_smoke.MESH_DECODE_TOL, 0.025
F32_TOL = 1e-4
MAX_FLIPS, TIE_MARGIN = _chip_smoke.MOE_MAX_FLIPS, _chip_smoke.MOE_TIE_MARGIN
FRAMES = 31
#: case -> (arch, config overrides)
CASES = {
    "qwen3-14b": ("qwen3-14b", {}),
    "qwen3-14b-int8": ("qwen3-14b", {"kv_cache_dtype": "int8"}),
    "mixtral-8x7b": ("mixtral-8x7b", {"window": 32}),
    "recurrentgemma-2b": ("recurrentgemma-2b", {"window": 32}),
    "minicpm3-4b": ("minicpm3-4b", {}),
    "xlstm-350m": ("xlstm-350m", {}),
    "whisper-base": ("whisper-base", {}),
    "llama4-maverick-400b-a17b": ("llama4-maverick-400b-a17b", {}),
    "mixtral-8x7b-e3": ("mixtral-8x7b", {"window": 32, "n_experts": 3}),
}
F32_DRIVEN = ("xlstm-350m",)
#: leaves split on their sequence dim (1)
SEQ_LEAVES = ("k", "v", "c_kv", "k_rope")


#: cases whose caches run past their end (no window) within the run
PAST_END = ("qwen3-14b", "qwen3-14b-int8", "minicpm3-4b", "whisper-base")
#: cases run again from one random recurrent state, ``n`` scaled by N_SCALE:
#: the mLSTM read-out divides by max(|q . n|, 1), so from the empty state
#: (|q . n| < 1 at every head) a lost partial sum of q . n over tp would not
#: show; at N_SCALE |q . n| > 1 at most heads
RANDOM_STATE, RANDOM_STEPS, N_SCALE = (
    ("recurrentgemma-2b", "xlstm-350m"), 4, 30.0)


def _steps(name) -> int:
    """T + 3 steps; 40 for a ring of 32; 8 for xlstm, which has no cache
    but its recurrent states."""
    if name == "xlstm-350m":
        return 8
    return 40 if CASES[name][1].get("window") else T + 3


REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.distributed import steps
    from repro.distributed.planner import cache_sharding, params_sharding
    from repro.launch.mesh import make_mesh
    from repro.models import build

    B, T, CASES, F32_DRIVEN, NSTEPS, PAST_END = %r, %r, %r, %r, %r, %r
    data, names = np.load(sys.argv[1]), sys.argv[3].split(",")
    from repro.models import moe as RM
    moe_forward, picks = RM.moe_forward, []

    def moe_forward_logged(p, x, cfg):
        # the reference's own router lines (moe.py:74-77), on the same x
        probs = jax.nn.softmax(jnp.einsum(
            "gsd,de->gse", x.astype(jnp.float32), p["router"]), axis=-1)
        picks.append(np.asarray(jax.lax.top_k(probs, cfg.top_k)[1]))
        return moe_forward(p, x, cfg)

    RM.moe_forward = moe_forward_logged
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}

    def nest(pre):
        tree = {}
        for key in data.files:
            if not key.startswith(pre):
                continue
            *head, leaf = key[len(pre):].split("/")
            node = tree
            for k in head:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(data[key])
        return fix(tree)

    def fix(t):
        # the tail is a list in the reference's tree
        if isinstance(t, dict):
            if t and all(k.isdigit() for k in t):
                return [fix(t[k]) for k in sorted(t, key=int)]
            return {k: fix(v) for k, v in t.items()}
        return t

    for name in names:
        arch, over = CASES[name]
        cfg = dataclasses.replace(configs.get_reduced(arch), **over)
        model = build(cfg)
        params = nest(name + "/p/")
        if cfg.enc_layers:
            cache = model.init_cache(params, jnp.asarray(
                data[name + "/frames"], dtype=jnp.bfloat16), T)
        else:
            cache = model.init_cache(B, T)
        inp = data[name + "/inputs"]
        if name in F32_DRIVEN:
            def fn(p, e, c):
                return model.decode_step(p, None, c, embeds=e)
        else:
            fn = steps.make_decode_step(cfg)

        def run(step, params, cache):
            logits = []
            for t in range(NSTEPS[name]):
                lg, cache = step(params, jnp.asarray(inp[t]), cache)
                logits.append(np.asarray(lg))
            return np.stack(logits)

        if cfg.n_experts:
            # op by op, unplaced (module docstring)
            picks.clear()
            with jax.disable_jit():
                out[name] = run(fn, params, cache)
            out[name + "/experts"] = np.stack(picks)
            continue
        if name in PAST_END:
            # the reference's decode as it defines it (module docstring)
            out[name + "/plain"] = run(jax.jit(fn), params, cache)
        p_sh = params_sharding(params, mesh)
        c_sh = cache_sharding(cache, mesh, batch_size=B)
        i_sh = NamedSharding(mesh, P("data", *([None] * (inp.ndim - 2))))
        step = jax.jit(fn, in_shardings=(p_sh, i_sh, c_sh),
                       out_shardings=(None, c_sh), donate_argnums=(2,))
        out[name] = run(step, jax.device_put(params, p_sh),
                        jax.device_put(cache, c_sh))
    np.savez(sys.argv[2], **out)
""") % (B, T, CASES, F32_DRIVEN, {n: _steps(n) for n in CASES}, PAST_END)


def _cfg(name):
    from repro_torch import configs
    arch, over = CASES[name]
    return dataclasses.replace(configs.get_reduced(arch), **over)


def _make_inputs(dest):
    """The weights (the port's init, norm scales and biases perturbed) in
    the reference's layout, the step inputs and whisper's frames, for every
    case, into one npz."""
    from repro_torch._tree import flatten_with_paths
    from repro_torch.models import build, to_reference
    rng = np.random.default_rng(24)
    out = {}
    for i, name in enumerate(CASES):
        cfg = _cfg(name)
        model = build(cfg, device="cpu", seed=i)
        for key, t in flatten_with_paths(model.params()):
            if key[-1] in ("scale", "bias", "b"):
                t.add_(torch.from_numpy(
                    0.1 * rng.standard_normal(t.shape)).to(t.dtype))
        for key, t in flatten_with_paths(to_reference(cfg, model.params())):
            out[f"{name}/p/" + "/".join(key)] = t.float().numpy()
        toks = rng.integers(0, cfg.vocab, (_steps(name), B, 1))
        if name in F32_DRIVEN:
            emb = model.embedding["emb"].float()
            out[f"{name}/inputs"] = emb[torch.from_numpy(toks)].numpy()
        else:
            out[f"{name}/inputs"] = toks.astype(np.int32)
        if cfg.enc_layers:
            f = rng.standard_normal((B, FRAMES, cfg.d_model))
            out[f"{name}/frames"] = torch.from_numpy(f).to(
                torch.bfloat16).float().numpy()
    np.savez(dest, **out)


def _nest(ref, pre):
    tree: dict = {}
    for key in ref.files:
        if not key.startswith(pre):
            continue
        *head, leaf = key[len(pre):].split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = ref[key]
    return _lists(tree)


def _lists(t):
    if isinstance(t, dict):
        if t and all(k.isdigit() for k in t):
            return [_lists(t[k]) for k in sorted(t, key=int)]
        return {k: _lists(v) for k, v in t.items()}
    return t


def _seq_leaves(cache):
    """(path, DTensor) of the cache leaves split on their sequence dim."""
    from torch.distributed.tensor import Shard
    from repro_torch._tree import flatten_with_paths
    from repro_torch.distributed import shardctx
    out = []
    for path, t in flatten_with_paths(cache):
        if (shardctx.is_dtensor(t) and path[-1] in SEQ_LEAVES
                and Shard(1) in t.placements):
            out.append(("/".join(path), t))
    return out


def _port(rank, world, inputs, ref_picks):
    """Every case on this rank: the mesh decode, the unsharded decode, and
    the non-owner check, each MoE call of both decodes routed to the
    experts the reference picked (``ref_picks``); rank 0 returns the
    logits."""
    from repro_torch._tree import flatten_with_paths, unflatten
    from repro_torch.distributed import steps
    from repro_torch.distributed.planner import (cache_sharding, shard_model,
                                                 shard_tensor)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe, params_from_numpy
    data, ref_picks = np.load(inputs), np.load(ref_picks)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    res = {}
    for name in CASES:
        cfg = _cfg(name)
        tree = _nest(data, f"{name}/p/")
        plain = params_from_numpy(cfg, tree, device="cpu")
        model = shard_model(params_from_numpy(cfg, tree, device="cpu"), mesh)
        if cfg.enc_layers:
            frames = torch.from_numpy(data[f"{name}/frames"]).to(
                torch.bfloat16)
            c0, c1 = (plain.init_cache(frames, T) for _ in range(2))
        else:
            c0, c1 = (plain.init_cache(B, T) for _ in range(2))
        specs = cache_sharding(c1, mesh, batch_size=B, cfg=cfg)
        c1 = unflatten(c1, [
            shard_tensor(t, s) if isinstance(t, torch.Tensor) else t
            for (_, t), (_, s) in zip(flatten_with_paths(c1),
                                      flatten_with_paths(specs))])
        step = steps.make_decode_step(cfg)
        pick = _reference_pick(ref_picks, name) if cfg.n_experts else None
        inp = torch.from_numpy(data[f"{name}/inputs"])
        kw = "embeds" if name in F32_DRIVEN else "token"
        mesh_logits, plain_logits, writes, untouched = [], [], 0, True
        log0, log1 = [], []
        for t in range(_steps(name)):
            x = inp[t] if kw == "embeds" else inp[t].long()
            args = ({"token": None, "embeds": x} if kw == "embeds"
                    else {"token": x})
            n0, n1 = len(log0), len(log1)
            # both logs grow by one a MoE layer a step, in lockstep with
            # the reference's picks
            with moe.routing_log(log0, pick=pick):
                l0, c0 = step(plain, cache=c0, **args)
            before = [(p, leaf.to_local().clone())
                      for p, leaf in _seq_leaves(c1)]
            with moe.routing_log(log1, pick=pick):
                l1, c1 = step(model, cache=c1, **args)
            flips = 0
            for a, b in zip(log0[n0:], log1[n1:]):
                flips += int((a.expert_ids != b.expert_ids).sum())
            res.setdefault("flips", {}).setdefault(name, 0)
            res["flips"][name] += flips
            after = dict(_seq_leaves(c1))
            for p, old in before:
                new = after[p].to_local()
                diff = (new != old).reshape(new.shape[0], new.shape[1],
                                            -1).any(dim=2).any(dim=0)
                rows = diff.nonzero().flatten().tolist()
                writes += len(rows)
                # at most the one slot this rank owns, and only there
                untouched &= len(rows) <= 1
            mesh_logits.append(l1.full_tensor().float().numpy())
            plain_logits.append(l0.float().numpy())
        res[name] = {"mesh": np.stack(mesh_logits),
                     "plain": np.stack(plain_logits),
                     "writes": writes, "untouched": untouched,
                     "moe_layouts": sorted({r.layout for r in log1})}
        if cfg.n_experts:
            per_step = len(log0) // _steps(name)
            res[name]["apart"] = {
                run: _apart_from_the_reference(log, ref_picks, name,
                                               per_step)
                for run, log in (("plain", log0), ("mesh", log1))}
        if name in RANDOM_STATE:
            res[name]["random"] = _from_random_state(
                step, plain, model, c0, c1, inp, kw)
    return res


def _reference_pick(ref_picks, name):
    """``moe.routing_log``'s ``pick`` for a MoE case: call i routes to the
    experts the reference's router picked at its call i. A decode group is
    one token, whose K distinct experts all take slot 0 < C: every choice
    is kept."""
    ids = torch.from_numpy(ref_picks[name + "/experts"]).long()
    return lambda i: (ids[i], torch.ones_like(ids[i], dtype=torch.bool))


def _apart_from_the_reference(log, ref_picks, name, per_step) -> list:
    """(step, margin) of each (call, token) at which the run's own router
    chose other experts than the reference's: the margin is the run's own
    probability of its own top-k less that of the reference's picks (0 at
    an exact tie)."""
    want = torch.from_numpy(ref_picks[name + "/experts"]).long()
    assert len(log) == len(want)
    out = []
    for i, r in enumerate(log):
        assert bool(r.keep.all())
        own, ref = r.expert_ids, want[i].view(r.expert_ids.shape)
        apart = (own.sort(-1).values != ref.sort(-1).values).any(-1)
        margin = (r.probs.gather(-1, own).sum(-1)
                  - r.probs.gather(-1, ref).sum(-1))
        out += [(i // per_step, float(m)) for m in margin[apart]]
    return out


def _from_random_state(step, plain, model, c0, c1, inp, kw):
    """Both caches set to one random state (the sequence-split leaves to
    the unsharded run's), then RANDOM_STEPS steps of each: (the mesh
    logits, the unsharded logits, the largest max |diff| / max |state| of
    any state leaf after them)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch._tree import flatten_with_paths, unflatten
    g = np.random.default_rng(7)
    on_mesh = dict(flatten_with_paths(c1))
    start = []
    for path, t0 in flatten_with_paths(c0):
        if isinstance(t0, torch.Tensor):
            # a fresh tensor: the unsharded run's are inference tensors
            scale = N_SCALE if path[-1] == "n" else 1.0
            t0 = (t0.clone() if path[-1] in SEQ_LEAVES else torch.from_numpy(
                scale * g.standard_normal(t0.shape)).to(t0.dtype))
            t1 = on_mesh[path]
            t1.to_local().copy_(distribute_tensor(
                t0, t1.device_mesh, t1.placements).to_local())
        start.append(t0)
    c0 = unflatten(c0, start)
    mesh_logits, plain_logits = [], []
    for t in range(RANDOM_STEPS):
        args = ({"token": None, "embeds": inp[t]} if kw == "embeds"
                else {"token": inp[t].long()})
        l0, c0 = step(plain, cache=c0, **args)
        l1, c1 = step(model, cache=c1, **args)
        mesh_logits.append(l1.full_tensor().float().numpy())
        plain_logits.append(l0.float().numpy())
    on_mesh = dict(flatten_with_paths(c1))
    worst = max(_rel(on_mesh[path].full_tensor().float().numpy(),
                     t0.float().numpy())
                for path, t0 in flatten_with_paths(c0)
                if isinstance(t0, torch.Tensor)
                and path[-1] not in SEQ_LEAVES)
    return np.stack(mesh_logits), np.stack(plain_logits), worst


def _reference(inputs, out, names):
    """The reference's decodes of ``names`` into the npz ``out``, in a
    subprocess."""
    return subprocess.Popen([sys.executable, "-c", REF, inputs, out,
                             ",".join(names)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env={**os.environ, "PYTHONPATH": "src",
                                            "JAX_PLATFORMS": "cpu"})


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the reference's outputs by key, each rank's results). The MoE
    cases' reference runs first, since the port routes to its picks; the
    other cases' runs beside the port."""
    tmp = tmp_path_factory.mktemp("mesh_decode")
    inputs = str(tmp / "inputs.npz")
    _make_inputs(inputs)
    moe_cases = [n for n in CASES if _cfg(n).n_experts]
    outs = [str(tmp / "ref_moe.npz"), str(tmp / "ref_rest.npz")]
    rest = _reference(inputs, outs[1],
                      [n for n in CASES if n not in moe_cases])
    try:
        first = _reference(inputs, outs[0], moe_cases)
        log, _ = first.communicate(timeout=600)
        assert first.returncode == 0, log[-4000:]
        ranks = _torch_ranks.run(_port, 4, tmp, inputs, outs[0])
    finally:
        log, _ = rest.communicate(timeout=600)
    assert rest.returncode == 0, log[-4000:]
    return {k: v for o in outs for k, v in np.load(o).items()}, ranks


def _tol(name, moe: float, bf16: float) -> float:
    """A case's bound: F32_TOL for the f32-driven runs, ``moe`` for the
    MoE archs, ``bf16`` otherwise (module docstring)."""
    if name in F32_DRIVEN:
        return F32_TOL
    return moe if _cfg(name).n_experts else bf16


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_decode_matches_the_reference_sharded_decode(results, name):
    """Every step against the reference's decode; where the cache runs past
    its end, the reference's sharded lowering up to there and its own
    (unsharded) decode throughout (module docstring)."""
    ref, ranks = results
    got, want = ranks[0][name]["mesh"], ref[name]
    assert got.shape == want.shape == (_steps(name), B, 1, 256)
    assert np.isfinite(got).all()
    tol = _tol(name, MOE_LOGIT_TOL, LOGIT_TOL)
    n = T if name in PAST_END else len(want)
    worst = max(_rel(got[t], want[t]) for t in range(n))
    assert worst <= tol, worst
    if name in PAST_END:
        plain = ref[name + "/plain"]
        worst = max(_rel(got[t], plain[t]) for t in range(len(plain)))
        assert worst <= tol, worst


@pytest.mark.parametrize("name", [n for n in CASES if _cfg(n).n_experts])
def test_moe_picks_pinned_to_the_reference_are_near_ties(results, name):
    """Where a decode's own router chose other experts than the reference's
    (to which both decodes are pinned), the two choices are a near-tie of
    its own probabilities: at most MAX_FLIPS (token, layer, step) choices
    a run, each within TIE_MARGIN (module docstring)."""
    _, ranks = results
    for run, apart in ranks[0][name]["apart"].items():
        assert len(apart) <= MAX_FLIPS, (run, apart)
        assert all(m <= TIE_MARGIN for _, m in apart), (name, run, apart)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_decode_matches_the_ports_unsharded_decode(results, name):
    _, ranks = results
    got, want = ranks[0][name]["mesh"], ranks[0][name]["plain"]
    tol = _tol(name, MOE_MESH_TOL, MESH_TOL)
    worst = max(_rel(got[t], want[t]) for t in range(len(want)))
    assert worst <= tol, worst
    assert ranks[0]["flips"][name] <= MAX_FLIPS


@pytest.mark.parametrize("name", RANDOM_STATE)
def test_recurrent_steps_from_a_random_state_match_the_unsharded_ones(
        results, name):
    """RANDOM_STEPS steps from one random state (``n`` at N_SCALE), the
    mesh run against the unsharded run: the logits at every step and every
    state leaf after them, at the case's bound against the unsharded
    decode."""
    _, ranks = results
    got, want, states = ranks[0][name]["random"]
    assert got.shape == want.shape == (RANDOM_STEPS, B, 1, 256)
    tol = _tol(name, MOE_MESH_TOL, MESH_TOL)
    worst = max(_rel(got[t], want[t]) for t in range(RANDOM_STEPS))
    assert worst <= tol, worst
    assert states <= tol, states


@pytest.mark.parametrize("name", list(CASES))
def test_only_the_owning_rank_writes_a_sequence_split_cache(results, name):
    """Every rank's shard of every sequence-split leaf changes at no more
    than one slot a step; summed over the ranks, every step writes each
    such leaf of each batch-row shard exactly once."""
    _, ranks = results
    assert all(r[name]["untouched"] for r in ranks)
    cfg = _cfg(name)
    from repro_torch.models import transformer
    kinds = (["attn"] * cfg.n_layers if cfg.enc_layers
             else transformer.layer_kinds(cfg))
    n_seq = sum(2 for k in kinds if k in ("attn", "attn_moe", "mla"))
    # 2 batch-row shards (data) x n_seq leaves x steps, once each; the
    # recurrent archs' attention layers are the only ones here
    assert sum(r[name]["writes"] for r in ranks) == 2 * n_seq * _steps(name)


def _class(path, spec) -> str:
    """Which dim of a cache leaf the ``model`` axis splits, by name."""
    dims = [d for d, e in enumerate(spec)
            if e == "model" or (isinstance(e, tuple) and "model" in e)]
    if not dims:
        return "whole"
    d, nd, leaf = dims[0], len(spec), path[-1]
    if leaf in SEQ_LEAVES and d == 1:
        return "sequence"
    if leaf in ("xk", "xv") and d == nd - 1:
        return "head dim"
    if leaf in ("S", "n", "c", "h", "conv") and d == nd - 1:
        return "feature"
    return f"dim {d}"


def _classes(cfg, cache, mesh, batch):
    """{(tail or body, block kind, leaf): class} of a cache (the port's
    layout) on ``mesh``."""
    from repro_torch._tree import flatten_with_paths
    from repro_torch.distributed.planner import cache_sharding
    from repro_torch.models import transformer
    kinds = (None if cfg.enc_layers else transformer.layer_kinds(cfg))
    n_body = cfg.n_groups * len(cfg.pattern)
    out = {}
    specs = flatten_with_paths(cache_sharding(cache, mesh, batch_size=batch,
                                              cfg=cfg))
    for (path, leaf), (_, sh) in zip(flatten_with_paths(cache), specs):
        if not isinstance(leaf, torch.Tensor):
            continue
        if kinds is None:
            key = ("dec", path[-1])
        else:
            i = int(path[1])
            key = ("tail" if i >= n_body else "body", kinds[i], path[-1])
        out.setdefault(key, set()).add(_class(path, sh.spec))
    return out


#: The full-size classes: the sequence for K/V and the MLA latents, the
#: head dim for whisper's cross K/V, the feature dim for recurrent states.
FULL_CLASSES = {
    "qwen3-14b": {("body", "attn", "k"): "sequence",
                  ("body", "attn", "v"): "sequence"},
    "mixtral-8x7b": {("body", "attn_moe", "k"): "sequence",
                     ("body", "attn_moe", "v"): "sequence"},
    "recurrentgemma-2b": {("body", "rglru", "h"): "feature",
                          ("body", "rglru", "conv"): "feature",
                          ("body", "attn", "k"): "sequence",
                          ("body", "attn", "v"): "sequence",
                          ("tail", "rglru", "h"): "whole",
                          ("tail", "rglru", "conv"): "feature"},
    "minicpm3-4b": {("body", "mla", "c_kv"): "sequence",
                    ("body", "mla", "k_rope"): "sequence"},
    "xlstm-350m": {("body", "mlstm", "S"): "feature",
                   ("body", "mlstm", "n"): "feature",
                   ("body", "slstm", "c"): "feature",
                   ("body", "slstm", "n"): "feature",
                   ("body", "slstm", "h"): "feature"},
    "whisper-base": {("dec", "k"): "sequence", ("dec", "v"): "sequence",
                     ("dec", "xk"): "head dim", ("dec", "xv"): "head dim"},
}
FULL_CLASSES["qwen3-14b-int8"] = FULL_CLASSES["qwen3-14b"]
FULL_CLASSES["mixtral-8x7b-e3"] = FULL_CLASSES["mixtral-8x7b"]
FULL_CLASSES["llama4-maverick-400b-a17b"] = {
    ("body", kind, leaf): "sequence" for kind in ("attn", "attn_moe")
    for leaf in ("k", "v")}


@pytest.mark.parametrize("name", list(CASES))
def test_reduced_cache_splits_the_dims_the_full_size_cache_splits(name):
    from repro_torch import configs
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.distributed import steps
    from repro_torch.launch.mesh import AbstractMesh
    arch, over = CASES[name]
    full = dataclasses.replace(configs.get(arch), **{
        k: v for k, v in over.items() if k != "window"})
    shape = SHAPES_BY_NAME["decode_32k"]
    want = _classes(full, steps.cache_specs(full, shape),
                    AbstractMesh((16, 16), ("data", "model")),
                    shape.global_batch)
    assert {k: v.pop() for k, v in want.items() if len(v) == 1} == \
        FULL_CLASSES[name]
    cfg = _cfg(name)
    if cfg.enc_layers:
        from repro_torch.models import encdec
        from repro_torch.models import attention as A
        kv = (B, FRAMES, cfg.n_kv, cfg.hd)
        cache = {"dec": [{"xk": torch.empty(kv, device="meta"),
                          "xv": torch.empty(kv, device="meta"),
                          "self": A.init_cache(encdec._acfg(cfg, True), B, T,
                                               device="meta")}
                         for _ in range(cfg.n_layers)], "pos": 0}
    else:
        cache = steps.cache_specs(cfg, configs.ShapeSpec("d", T, B,
                                                         "decode"))
    got = _classes(cfg, cache, AbstractMesh((2, 2), ("data", "model")), B)
    assert {k: v.pop() for k, v in got.items()} == FULL_CLASSES[name]


def _unknown_placement(rank, world):
    """A KV cache split on its head dim over tp: the decode raises, naming
    the leaf, on every rank."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch import configs
    from repro_torch.distributed import steps
    from repro_torch.distributed.planner import shard_model
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    cfg = configs.get_reduced("qwen3-14b")
    model = shard_model(build(cfg, device="cpu"), mesh)
    cache = model.init_cache(B, T)
    cache["layers"] = [c._replace(**{
        k: distribute_tensor(getattr(c, k), mesh, [Shard(0), Shard(3)],
                             src_data_rank=None) for k in ("k", "v")})
        for c in cache["layers"]]
    try:
        steps.make_decode_step(cfg)(model, torch.zeros((B, 1),
                                                       dtype=torch.long),
                                    cache)
    except ValueError as e:
        return str(e)
    return None


def test_a_cache_leaf_placed_by_no_rule_raises(tmp_path):
    msgs = _torch_ranks.run(_unknown_placement, 4, tmp_path)
    assert all(m is not None and "'k'" in m and "match no decode rule" in m
               for m in msgs), msgs


#: The MoE layout of each MoE case's decode, as the reference's rule
#: ``E % tp == 0`` picks it (``src/repro/models/moe.py:102-111``; the
#: layout every MoE call recorded in its routing, ``moe.Routing.layout``):
#: expert parallelism's decode pick keeps the stacks where they lie.
MOE_LAYOUTS = {"mixtral-8x7b": "expert-parallel stationary",
               "llama4-maverick-400b-a17b": "expert-parallel stationary",
               "mixtral-8x7b-e3": "token-parallel"}


@pytest.mark.parametrize("name", list(MOE_LAYOUTS))
def test_moe_decode_takes_the_references_layout(results, name):
    _, ranks = results
    assert all(r[name]["moe_layouts"] == [MOE_LAYOUTS[name]] for r in ranks)
