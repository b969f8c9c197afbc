"""The port's copy of the paper's performance model and DSE against the JAX
package's ``repro.core``.

Both are numpy models of the AMD VEK280, so every result must be equal with
``==``, float for float, not within a tolerance. Like is compared with like:
the port's scalar model with the reference's scalar model, and batched with
batched (the reference's own batched and scalar sums differ in the last
digit on some designs).
"""
import dataclasses
import itertools
import random

import numpy as np
import pytest

from repro.core import baselines as rbase
from repro.core import dse as rdse
from repro.core import layerspec as rls
from repro.core import mapping as rmap
from repro.core import perfmodel as rpm
from repro.core import perfmodel_batched as rpmb
from repro.core import placement as rpl
from repro.core import aie_arch as rarch
from repro_torch.core import aie_arch as tarch
from repro_torch.core import baselines as tbase
from repro_torch.core import dse as tdse
from repro_torch.core import layerspec as tls
from repro_torch.core import mapping as tmap
from repro_torch.core import perfmodel as tpm
from repro_torch.core import perfmodel_batched as tpmb
from repro_torch.core import placement as tpl

MODELS = sorted(rls.REALISTIC_WORKLOADS)


def _norm(x):
    """A value with every dataclass (of either package) turned into its class
    name and fields and every array into its dtype, shape and items, so that
    the two packages' results compare with ``==``."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _norm(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tolist())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [_norm(v) for v in x])
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, np.generic):
        return x.item()
    return x


def _twin_spec(spec):
    """The port's ModelSpec equal to the reference's ``spec``."""
    return tls.ModelSpec(tuple(tls.LayerSpec(**dataclasses.asdict(l))
                               for l in spec.layers), name=spec.name)


def _placements(name, n, seed, max_tiles=16):
    """``n`` placed random mapping chains of one model, the same choices in
    both packages (their mapping enumerations run in the same order)."""
    rspec = rls.REALISTIC_WORKLOADS[name]()
    tspec = tls.REALISTIC_WORKLOADS[name]()
    ropts = [list(rmap.enumerate_mappings(l, max_tiles)) for l in rspec.layers]
    topts = [list(tmap.enumerate_mappings(l, max_tiles)) for l in tspec.layers]
    assert _norm(ropts) == _norm(topts)
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        idx = [rng.randrange(len(o)) for o in ropts]
        rmm = rmap.ModelMapping(model=rspec, mappings=tuple(
            o[i] for o, i in zip(ropts, idx)))
        tmm = tmap.ModelMapping(model=tspec, mappings=tuple(
            o[i] for o, i in zip(topts, idx)))
        assert rmm.fits() == tmm.fits()
        if not rmm.fits():
            continue
        rp, tp = rpl.place(rmm), tpl.place(tmm)
        assert _norm(rp) == _norm(tp)
        if rp is not None:
            out.append((rp, tp))
    return out


def test_arch_constants_and_workloads_are_the_reference():
    assert _norm(tarch.OVERHEADS) == _norm(rarch.OVERHEADS)
    for k in ("AIE_FREQ_GHZ", "ARRAY_ROWS", "ARRAY_COLS", "PLIO_PORTS",
              "BLOCK_SHAPES", "SHIM_STREAMS_PER_COL", "CASCADE_FIFO_DEPTH"):
        assert getattr(tarch, k) == getattr(rarch, k), k
    assert sorted(tls.REALISTIC_WORKLOADS) == MODELS
    for name in MODELS:
        assert (_norm(tls.REALISTIC_WORKLOADS[name]())
                == _norm(rls.REALISTIC_WORKLOADS[name]()))
    assert _norm(tls.synthetic_mlp(64, 8, bias_relu=True)) == _norm(
        rls.synthetic_mlp(64, 8, bias_relu=True))
    assert tpm.BLAME_CATEGORIES == rpm.BLAME_CATEGORIES
    assert tpm.BLAME_PARAM_KNOBS == rpm.BLAME_PARAM_KNOBS


@pytest.mark.parametrize("dtype", sorted(rarch.BLOCK_SHAPES))
def test_single_aie_terms_equal(dtype):
    shapes = itertools.product([1, 8, 32, 64, 128], [5, 16, 32, 64, 200],
                               [5, 16, 32, 64])
    for h1, w1, w2 in shapes:
        assert tpm.j_loops(h1, w2, dtype) == rpm.j_loops(h1, w2, dtype)
        for cas, ideal in itertools.product([False, True], repeat=2):
            assert (tpm.l_j_cycles(w1, cascaded=cas, dtype=dtype, ideal=ideal)
                    == rpm.l_j_cycles(w1, cascaded=cas, dtype=dtype,
                                      ideal=ideal))
        assert tpm.br_overhead(h1, w2) == rpm.br_overhead(h1, w2)
        for br, local, ideal in itertools.product([False, True], repeat=3):
            kw = dict(bias_relu=br, store_local=local, dtype=dtype,
                      ideal=ideal)
            assert (tpm.single_aie_cycles(h1, w1, w2, **kw)
                    == rpm.single_aie_cycles(h1, w1, w2, **kw))
        assert (tpm.gama_estimate_cycles(h1, w1, w2, dtype)
                == rpm.gama_estimate_cycles(h1, w1, w2, dtype))
        assert (tpm.ssr_estimate_cycles(h1, w1, w2, dtype)
                == rpm.ssr_estimate_cycles(h1, w1, w2, dtype))


def test_comm_and_agg_terms_equal():
    for nbytes, hops, streams, ideal in itertools.product(
            [1, 21, 512, 4096, 65536], [0, 1, 7], [1, 2, 4], [False, True]):
        assert (tpm.dma_comm_cycles(nbytes, hops, n_streams=streams,
                                    ideal=ideal)
                == rpm.dma_comm_cycles(nbytes, hops, n_streams=streams,
                                       ideal=ideal))
        assert (tpm.sharedmem_comm_cycles(nbytes, ideal=ideal)
                == rpm.sharedmem_comm_cycles(nbytes, ideal=ideal))
        assert (tpm.plio_cycles(nbytes, streams, ideal=ideal)
                == rpm.plio_cycles(nbytes, streams, ideal=ideal))
    assert tpm.cascade_comm_cycles() == rpm.cascade_comm_cycles()
    for a, h1, w2 in itertools.product([1, 2, 4, 8], [8, 32, 64], [16, 32, 64]):
        for ideal in (False, True):
            assert (tpm.agg_ours_cycles(a, h1, w2, ideal=ideal)
                    == rpm.agg_ours_cycles(a, h1, w2, ideal=ideal))
        assert (tpm.agg_baseline_cycles(a, h1, w2)
                == rpm.agg_baseline_cycles(a, h1, w2))
    rng = np.random.default_rng(3)
    items = [tuple(v) for v in rng.integers(0, 40, (300, 3)).tolist()]
    for n in (10, 300):       # the scalar path and the vectorized one
        assert (tdse.pareto_front(items[:n], key=lambda v: v[:2])
                == rdse.pareto_front(items[:n], key=lambda v: v[:2]))
        assert (tdse.pareto_front_nd(items[:n], key=lambda v: v)
                == rdse.pareto_front_nd(items[:n], key=lambda v: v))
    for lat, ii, slack, cap in itertools.product([100.0, 999.5], [7.0, 250.0],
                                                 [0, 1, 3], [None, 4]):
        assert (tpm.pipeline_fill_depth(lat, ii, slack=slack, cap=cap)
                == rpm.pipeline_fill_depth(lat, ii, slack=slack, cap=cap))


def test_calibration_fit_equal():
    tp, terr = tpm.calibrate()
    rp, rerr = rpm.calibrate()
    assert _norm(tp) == _norm(rp)
    assert terr == rerr
    assert tpm.model_errors() == rpm.model_errors()


@pytest.mark.parametrize("name", MODELS)
def test_per_layer_and_end_to_end_equal(name):
    """Every per-layer and end-to-end function of the scalar model on
    random placed mapping chains (not only the DSE's winners)."""
    for rp, tp in _placements(name, 6, seed=MODELS.index(name)):
        rmaps, tmaps = rp.model_mapping.mappings, tp.model_mapping.mappings
        for rm, tm in zip(rmaps, tmaps):
            for out_cas, ideal in itertools.product([False, True], repeat=2):
                kw = dict(out_cascade=out_cas, ideal=ideal)
                assert (tpm.layer_comp_cycles(tm, **kw)
                        == rpm.layer_comp_cycles(rm, **kw))
                assert (_norm(tpm.layer_occupancy(tm, **kw))
                        == _norm(rpm.layer_occupancy(rm, **kw)))
                assert (_norm(tpm.layer_blame(tm, out_cascade=out_cas))
                        == _norm(rpm.layer_blame(rm, out_cascade=out_cas)))
        for ideal, plio in itertools.product([False, True], repeat=2):
            kw = dict(ideal=ideal, include_plio=plio)
            assert (_norm(tpm.end_to_end_cycles(tp, **kw))
                    == _norm(rpm.end_to_end_cycles(rp, **kw)))
            assert (_norm(tpm.pipeline_stages(tp, **kw))
                    == _norm(rpm.pipeline_stages(rp, **kw)))
            assert (tpm.initiation_interval_cycles(tp, **kw)
                    == rpm.initiation_interval_cycles(rp, **kw))
        assert _norm(tpm.edge_comms(tp)) == _norm(rpm.edge_comms(rp))
        assert (_norm(tpm.shim_stage_cycles(tp))
                == _norm(rpm.shim_stage_cycles(rp)))
        blame = tpm.latency_blame(tp)
        assert _norm(blame) == _norm(rpm.latency_blame(rp))
        assert tpm.blame_shares(blame) == rpm.blame_shares(blame)
        for cat in tpm.BLAME_PARAM_KNOBS:
            assert (_norm(tpm.scale_overheads(tarch.OVERHEADS, cat, 1.5))
                    == _norm(rpm.scale_overheads(rarch.OVERHEADS, cat, 1.5)))


@pytest.mark.parametrize("name", ["JSC-M", "Deepsets-32", "Deepsets-64-d"])
def test_batched_model_equals_the_reference_batched(name):
    pairs = _placements(name, 12, seed=7)
    rb = rpmb.DesignBatch.from_placements([r for r, _ in pairs])
    tb = tpmb.DesignBatch.from_placements([t for _, t in pairs])
    assert _norm(tb) == _norm(rb)
    for ideal in (False, True):
        assert (_norm(tpmb.end_to_end_cycles_v(tb, ideal=ideal))
                == _norm(rpmb.end_to_end_cycles_v(rb, ideal=ideal)))
        assert (_norm(tpmb.stage_cycles_v(tb, ideal=ideal))
                == _norm(rpmb.stage_cycles_v(rb, ideal=ideal)))
        assert (_norm(tpmb.initiation_interval_cycles_v(tb, ideal=ideal))
                == _norm(rpmb.initiation_interval_cycles_v(rb, ideal=ideal)))
        assert (_norm(tpmb.score_batch(tb, ideal=ideal))
                == _norm(rpmb.score_batch(rb, ideal=ideal)))
    assert _norm(tpmb.latency_blame_v(tb)) == _norm(rpmb.latency_blame_v(rb))
    arr = np.array(list(rpm.TABLE2_NS), dtype=np.int64)
    for br in (False, True):
        assert _norm(tpmb.single_aie_cycles_v(
            arr[:, 0], arr[:, 1], arr[:, 2], bias_relu=br)) == _norm(
            rpmb.single_aie_cycles_v(arr[:, 0], arr[:, 1], arr[:, 2],
                                     bias_relu=br))


@pytest.mark.parametrize("force_dma", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_explore_equals_the_reference(name, force_dma):
    r = rdse.explore(rls.REALISTIC_WORKLOADS[name](), force_dma=force_dma)
    t = tdse.explore(tls.REALISTIC_WORKLOADS[name](), force_dma=force_dma)
    assert (r is None) == (t is None)
    assert t.latency_ns == r.latency_ns
    assert _norm(t.latency) == _norm(r.latency)
    assert _norm(t.mapping) == _norm(r.mapping)
    assert _norm(t.placement) == _norm(r.placement)
    assert t.summary() == r.summary()
    assert _norm(t) == _norm(r)


class _Registry:
    """The least of a metrics registry: counters and gauges by name."""

    def __init__(self):
        self.seen = []

    def counter(self, name, labels):
        return self._Metric(self.seen, "counter", name)

    def gauge(self, name, labels):
        return self._Metric(self.seen, "gauge", name)

    class _Metric:
        def __init__(self, seen, kind, name):
            self.seen, self.kind, self.name = seen, kind, name

        def inc(self, n=1.0):
            self.seen.append((self.kind, self.name))

        def set(self, v):
            self.seen.append((self.kind, self.name))


def test_search_equals_the_reference():
    spec = rls.deepsets(32, 21, [32, 32], [32, 5], name="ds-small")
    r = rdse.search(spec, explain=True)
    reg = _Registry()
    t = tdse.search(_twin_spec(spec), explain=True, registry=reg)
    assert len(t) == len(r) > 0
    assert _norm(t) == _norm(r)
    assert [d.summary() for d in t] == [d.summary() for d in r]
    assert ("counter", "dse.candidates_evaluated") in reg.seen
    ex_r = rdse.search(spec, exhaustive=True)
    ex_t = tdse.search(_twin_spec(spec), exhaustive=True)
    assert _norm(ex_t) == _norm(ex_r)


@pytest.mark.parametrize("name", MODELS)
def test_baselines_equal(name):
    r = rbase.compare_frameworks(rls.REALISTIC_WORKLOADS[name]())
    t = tbase.compare_frameworks(tls.REALISTIC_WORKLOADS[name]())
    assert _norm(t) == _norm(r)
    assert t.speedups() == r.speedups()
    for m, f, a in itertools.product([32, 64], [32, 64], [1, 4, 8]):
        assert tbase.agg_baseline_ns(m, f, a) == rbase.agg_baseline_ns(m, f, a)
