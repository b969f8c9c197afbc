"""The port's ``configs`` against the JAX package's: every architecture, full
and reduced, field by field with ``==``; the shape cells, the runnable
matrix and the parameter counts; the per-arch accessor modules and
``jet_tagging``, mirroring tests/test_configs.py."""
import dataclasses
import importlib

import pytest

from repro import configs as ref
from repro_torch import configs as port

MODULES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "mixtral-8x7b": "mixtral_8x7b",
    "xlstm-350m": "xlstm_350m",
    "qwen3-14b": "qwen3_14b",
    "granite-8b": "granite_8b",
    "qwen1.5-32b": "qwen15_32b",
    "minicpm3-4b": "minicpm3_4b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-base": "whisper_base",
    "qwen2-vl-72b": "qwen2_vl_72b",
}


def _fields(cfg):
    """Every field as a plain value (MLAParams as a dict), and the derived
    properties."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if d.get("mla") is not None:
        d["mla"] = dataclasses.asdict(d["mla"])
    return dict(d, hd=cfg.hd, n_groups=cfg.n_groups)


def test_arch_names_equal():
    assert port.ARCH_NAMES == ref.ARCH_NAMES
    assert list(port.FULL) == list(ref.FULL)
    assert set(MODULES) == set(ref.ARCH_NAMES)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", list(ref.ARCH_NAMES))
def test_config_equals_the_reference(arch, reduced):
    get_p = port.get_reduced if reduced else port.get
    get_r = ref.get_reduced if reduced else ref.get
    p, r = get_p(arch), get_r(arch)
    assert _fields(p) == _fields(r)
    assert p.param_count() == r.param_count()
    assert p.active_param_count() == r.active_param_count()


def test_shapes_equal():
    assert [dataclasses.asdict(s) for s in port.SHAPES] == [
        dataclasses.asdict(s) for s in ref.SHAPES]
    assert list(port.SHAPES_BY_NAME) == list(ref.SHAPES_BY_NAME)
    assert [s.is_train for s in port.SHAPES] == [s.is_train for s in ref.SHAPES]


def test_cell_runnable_equal_on_all_40_cells():
    cells = [(a, i) for a in ref.ARCH_NAMES for i in range(len(ref.SHAPES))]
    assert len(cells) == 40
    got = [port.cell_runnable(port.get(a), port.SHAPES[i]) for a, i in cells]
    want = [ref.cell_runnable(ref.get(a), ref.SHAPES[i]) for a, i in cells]
    assert got == want
    assert sum(ok for ok, _ in got) == 33


@pytest.mark.parametrize("arch", list(ref.ARCH_NAMES))
def test_per_arch_module(arch):
    mod = importlib.import_module(f"repro_torch.configs.{MODULES[arch]}")
    ref_mod = importlib.import_module(f"repro.configs.{MODULES[arch]}")
    assert mod.ARCH == ref_mod.ARCH == arch
    assert mod.config() == port.get(arch)
    assert _fields(mod.config()) == _fields(ref_mod.config())
    assert _fields(mod.reduced()) == _fields(ref_mod.reduced())
    assert mod.reduced().d_model <= 64


def test_jet_tagging_module():
    from repro.configs import jet_tagging as ref_jet
    from repro_torch.configs import jet_tagging
    assert jet_tagging.jsc_m().num_layers == 5
    assert len(jet_tagging.REALISTIC_WORKLOADS) == 7
    assert jet_tagging.__all__ == ref_jet.__all__
    for name, fn in jet_tagging.REALISTIC_WORKLOADS.items():
        want = ref_jet.REALISTIC_WORKLOADS[name]()
        got = fn()
        assert repr(got) == repr(want), name
