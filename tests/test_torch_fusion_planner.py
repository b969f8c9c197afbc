"""Tier-B core of the port: the H100 latency model and the shared-memory
fusion planner (the twin of ``tests/test_fusion_planner.py``), with the
planner's legality rule held to the bytes K2's wrapper checks."""
import itertools

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core import h100_model
from repro_torch.core.fusion_planner import plan, shapes_from_model
from repro_torch.core.h100_model import LayerShape
from repro_torch.core.layerspec import (REALISTIC_WORKLOADS, jsc_m, jsc_xl_d,
                                        synthetic_mlp)
from repro_torch.kernels import _build
from repro_torch.kernels.cascade_mlp import cascade_mlp, ops, packed_mma_chain
from repro_torch.quant import quantize_mlp


def _chain(dims, m=64):
    return [LayerShape(M=m, K=dims[i], N=dims[i + 1])
            for i in range(len(dims) - 1)]


def _qmlp(dims, biases, seed=0):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(0, 0.4, (dims[i], dims[i + 1]))
          for i in range(len(dims) - 1)]
    bs = [rng.normal(0, 0.1, (dims[i + 1],)) if b else None
          for i, b in enumerate(biases)]
    return quantize_mlp(ws, bs, [True] * (len(ws) - 1) + [False],
                        rng.normal(0, 1, (8, dims[0])))


def _wrapper_smem(q):
    """The bytes ``cascade_mlp`` hands ``_check_smem`` for ``q``."""
    pc = packed_mma_chain(q)
    return pc.smem_bytes + 2 * ops.BLOCK_ROWS * pc.stride


class TestH100Model:
    def test_fused_beats_unfused_small_models(self):
        """For μs-scale models, launches and round-trips dominate: fusing
        the whole chain must win (the paper's core claim, transferred)."""
        layers = _chain([16, 64, 64, 64, 32, 5])
        assert (h100_model.fused_chain_time_s(layers)
                < h100_model.unfused_chain_time_s(layers))
        assert (h100_model.fused_chain_time_s(layers, kernel="deepsets")
                < h100_model.unfused_chain_time_s(layers))

    def test_hbm_traffic_reduction(self):
        layers = _chain([16, 64, 64, 64, 32, 5])
        fused = h100_model.hbm_traffic_bytes(layers, fused=True)
        unfused = h100_model.hbm_traffic_bytes(layers, fused=False)
        assert fused < unfused
        # intermediates (out=in of next) are counted once vs twice
        inter = sum(l.out_bytes for l in layers[:-1])
        assert unfused - fused == 2 * inter

    def test_compute_term_scales(self):
        a = h100_model.compute_time_s(1e9)
        b = h100_model.compute_time_s(2e9)
        assert b > a
        assert (h100_model.compute_time_s(0, layers=3, layer_s=1e-6)
                == pytest.approx(3e-6))

    def test_terms_add_up(self):
        """A fused chain of L layers is one launch, one prologue and L
        layers; the per-layer chain is L launches and L of K1's fixed cost
        (at these sizes HBM and peak compute are below the latency terms)."""
        layers = _chain([16, 64, 32, 32, 32, 5])
        m = h100_model
        assert m.fused_chain_time_s(layers) == pytest.approx(
            m.KERNEL_LAUNCH_S + m.FUSED_PROLOGUE_S + 5 * m.FUSED_LAYER_S
            + sum(l.flops for l in layers) / m.PEAK_INT8_OPS)
        assert m.fused_chain_time_s(layers, kernel="deepsets") == pytest.approx(
            m.KERNEL_LAUNCH_S + m.SET_PROLOGUE_S + 5 * m.SET_LAYER_S
            + sum(l.flops for l in layers) / m.PEAK_INT8_OPS)
        assert m.unfused_chain_time_s(layers) == pytest.approx(
            5 * (m.KERNEL_LAUNCH_S + m.UNFUSED_LAYER_S)
            + sum(max(l.flops / m.PEAK_INT8_OPS,
                      (l.in_bytes + l.w_bytes + l.out_bytes) / m.HBM_BW)
                  for l in layers))
        with pytest.raises(ValueError, match="kernel"):
            m.fused_chain_time_s(layers, kernel="mm_int8")

    def test_ingest(self):
        assert h100_model.ingest_time_s(0) == 0
        assert (h100_model.ingest_time_s(2 << 20)
                == pytest.approx(2 * h100_model.ingest_time_s(1 << 20)))

    def test_budget_is_the_kernels(self):
        assert h100_model.SMEM_BUDGET == _build.MAX_SMEM_BYTES == 232448
        assert h100_model.MAX_CHAIN_LAYERS == ops.MAX_LAYERS


@pytest.mark.parametrize("dims", [
    [16, 64, 32, 32, 32, 5], [16, 128, 64, 64, 64, 5], [64] * 9, [21, 32, 10],
    [5, 64, 32, 5], [130, 200, 64, 10], [16, 20, 13, 37, 70, 5], [1, 1],
    [7, 300, 9], [512, 512, 256, 3]])
@pytest.mark.parametrize("biases", ["all", "none", "alternate"])
def test_chain_smem_bytes_is_what_k2_checks(dims, biases):
    """The planner's legality count equals, byte for byte, what K2's
    wrapper hands ``_check_smem`` for the same widths."""
    n = len(dims) - 1
    flags = {"all": [True] * n, "none": [False] * n,
             "alternate": [i % 2 == 0 for i in range(n)]}[biases]
    q = _qmlp(dims, flags)
    shapes = [LayerShape(M=64, K=dims[i], N=dims[i + 1], bias=flags[i])
              for i in range(n)]
    assert h100_model.chain_smem_bytes(shapes) == _wrapper_smem(q)


def test_chain_smem_bytes_grid():
    for k0, n1, n2 in itertools.product([1, 16, 31, 32, 33, 100],
                                        [1, 8, 9, 64, 127],
                                        [5, 24, 200]):
        q = _qmlp([k0, n1, n2], [True, True], seed=k0 + n1 + n2)
        assert (h100_model.chain_smem_bytes(_chain([k0, n1, n2]))
                == _wrapper_smem(q)), (k0, n1, n2)


@pytest.mark.parametrize("n", [64, 200])
def test_k2_and_the_planner_agree_at_the_budget(n):
    """The widest one-layer chain under the budget is planned and passes the
    check K2's wrapper runs before a launch; the next width up is refused
    by both."""
    budget = h100_model.SMEM_BUDGET
    k = max(k for k in range(32, 4096, 32)
            if h100_model.chain_smem_bytes(_chain([k, n])) <= budget)
    ops._check_smem(_wrapper_smem(_qmlp([k, n], [True])))
    assert plan(_chain([k, n])).n_kernels == 1
    assert h100_model.chain_smem_bytes(_chain([k + 32, n])) > budget
    with pytest.raises(ValueError, match="cannot be fused"):
        ops._check_smem(_wrapper_smem(_qmlp([k + 32, n], [True])))
    with pytest.raises(ValueError, match="budget"):
        plan(_chain([k + 32, n]))


class TestFusionPlanner:
    def test_unlimited_budget_single_group(self):
        layers = _chain([16, 64, 64, 32, 5])
        p = plan(layers, smem_budget=1 << 40)
        assert p.n_kernels == 1
        assert p.groups == (tuple(range(len(layers))),)
        assert p.speedup > 1.0

    def test_tight_budget_splits(self):
        layers = _chain([1024, 1024, 1024, 1024], m=128)
        one = h100_model.chain_smem_bytes(layers[:1])
        p = plan(layers, smem_budget=int(one * 1.5))
        assert p.n_kernels == len(layers)

    def test_default_budget_splits_wide_chain(self):
        """At the card's 227 KB, a chain of 128-wide layers fuses in groups
        that each fit, and the groups cover it in order."""
        layers = _chain([128] * 14)
        p = plan(layers)
        assert 1 < p.n_kernels < len(layers)
        assert [i for g in p.groups for i in g] == list(range(len(layers)))
        for g in p.groups:
            assert (h100_model.chain_smem_bytes([layers[i] for i in g])
                    <= h100_model.SMEM_BUDGET)

    def test_layer_cap_splits(self):
        """K2 takes at most MAX_LAYERS layers; a longer narrow chain that
        fits shared memory is still split."""
        layers = _chain([8] * (2 * h100_model.MAX_CHAIN_LAYERS + 2))
        assert (h100_model.chain_smem_bytes(layers)
                <= h100_model.SMEM_BUDGET)
        p = plan(layers)
        assert p.n_kernels == 3
        assert max(len(g) for g in p.groups) <= h100_model.MAX_CHAIN_LAYERS

    def test_infeasible_single_layer_raises(self):
        layers = [LayerShape(M=8, K=1 << 14, N=1 << 14)]
        with pytest.raises(ValueError):
            plan(layers, smem_budget=1 << 20)

    @given(depth=st.integers(1, 8), seed=st.integers(0, 5))
    @settings(max_examples=15, deadline=None)
    def test_dp_invariants(self, depth, seed):
        rng = np.random.default_rng(seed)
        dims = [int(rng.choice([16, 32, 64, 128, 256]))
                for _ in range(depth + 1)]
        layers = _chain(dims)
        p = plan(layers)
        # groups partition the chain in order
        flat = [i for g in p.groups for i in g]
        assert flat == list(range(depth))
        # every group respects the budget
        for g in p.groups:
            chain = [layers[i] for i in g]
            assert h100_model.chain_smem_bytes(chain) <= p.smem_budget
        # DP optimality sanity: plan time <= both extremes of its groups,
        # every layer a kernel of its own and, where legal, one kernel
        # (a one-layer K2 group need not beat K1 on the card, so the
        # per-layer K1 chain is no bound here)
        singles = sum(h100_model.fused_chain_time_s([l]) for l in layers)
        assert p.time_s <= singles + 1e-12
        if h100_model.chain_smem_bytes(layers) <= p.smem_budget:
            assert p.time_s <= h100_model.fused_chain_time_s(layers) + 1e-12

    def test_paper_models_fully_fuse(self):
        """The jet-tagging models are tiny: the planner must fuse each into
        ONE kernel — whole-model on-chip, like the paper's AIE mapping."""
        for model in (jsc_m(), jsc_xl_d(), synthetic_mlp(64, 8)):
            shapes = shapes_from_model(model)
            p = plan(shapes)
            assert p.n_kernels == 1

    @pytest.mark.parametrize("name", sorted(REALISTIC_WORKLOADS))
    def test_every_realistic_group_runs_in_k2(self, name):
        """Each planned group of every realistic workload passes K2's own
        check, and the fused plain chain runs on its widths."""
        shapes = shapes_from_model(REALISTIC_WORKLOADS[name]())
        p = plan(shapes)
        for g in p.groups:
            dims = [shapes[g[0]].K] + [shapes[i].N for i in g]
            q = _qmlp(dims, [shapes[i].bias for i in g])
            ops._check_smem(_wrapper_smem(q))
            out = cascade_mlp(torch.zeros((4, dims[0]), dtype=torch.int8), q)
            assert out.shape == (4, dims[-1])
