"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points default to CUDA and raise where there is none."""
import os
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    """Every module of the port, by walking its source tree."""
    out = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


MODULES = _modules()
# Each module is imported in a fresh interpreter of its own; that many
# interpreters at once, so that the file's time stays put as the port grows.
IMPORT_WORKERS = 4
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
_FORBIDDEN = re.compile(r"jax|\brepro\.|^\s*(from|import)\s+repro\b", re.M)


def _import_alone(module):
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')); "
            "print(','.join(bad))")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


@pytest.fixture(scope="module")
def imports():
    """module -> the finished subprocess that imported it alone."""
    with ThreadPoolExecutor(max_workers=IMPORT_WORKERS) as pool:
        return dict(zip(MODULES, pool.map(_import_alone, MODULES)))


def test_every_module_is_listed():
    assert len(MODULES) >= 70
    for m in ("repro_torch.models.transformer", "repro_torch.models.moe",
              "repro_torch.configs.archs",
              "repro_torch.launch.simulate", "repro_torch.launch.calibrate",
              "repro_torch.optim", "repro_torch.ckpt", "repro_torch.data",
              "repro_torch.distributed.ft", "repro_torch.distributed.steps",
              "repro_torch.launch.train", "repro_torch.launch.mesh",
              "repro_torch.launch.hlo_analysis", "repro_torch.launch.dryrun",
              "repro_torch.distributed.shardctx",
              "repro_torch.distributed.planner",
              "repro_torch.distributed.compression",
              "repro_torch.distributed.pipeline"):
        assert m in MODULES


#: Modules of the JAX package with no module of the same name in the port:
#: the TPU cost model (``core.h100_model`` stands in for it) and the Pallas
#: kernel bodies (``kernels/csrc`` holds their CUDA, ``ops.py`` and
#: ``ref.py`` the wrappers and plain versions).
STOOD_IN_FOR = {"repro.core.tpu_model",
                "repro.kernels.cascade_mlp.cascade_mlp",
                "repro.kernels.flash_attn.flash_attn",
                "repro.kernels.global_agg.global_agg",
                "repro.kernels.mm_int8.mm_int8"}


def test_every_reference_module_has_a_counterpart():
    ref_root = ROOT / "src" / "repro"
    missing = []
    for path in sorted(ref_root.rglob("*.py")):
        parts = path.relative_to(ref_root.parent).with_suffix("").parts
        name = ".".join(parts[:-1] if parts[-1] == "__init__" else parts)
        port = "repro_torch" + name[len("repro"):]
        if port not in MODULES and name not in STOOD_IN_FOR:
            missing.append(name)
    assert missing == []


@pytest.mark.parametrize("module", MODULES)
def test_import_pulls_in_no_jax(module, imports):
    res = imports[module]
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", res.stdout


def test_every_source_is_scanned():
    assert len(SOURCES) >= 15


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name if p.name
                         != "__init__.py" else p.parent.name + "/__init__.py")
def test_source_names_no_jax(path):
    hits = [m.group(0) for m in _FORBIDDEN.finditer(path.read_text())]
    assert not hits, (path, hits)


def _tiny_qmlp(k=4, n=3, device="cpu"):
    """A one-layer quantized model with zero weights, k -> n."""
    from repro_torch.quant import QuantizedLinear, QuantizedMLP
    w = torch.zeros((k, n), dtype=torch.int8, device=device)
    return QuantizedMLP(e_in=0, layers=(QuantizedLinear(
        w_q=w, bias_q=None, shift=0, relu=False, e_w=0, e_out=0),))


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present, so the CUDA defaults do not raise here")


def test_jetserver_defaults_to_cuda():
    _no_cuda()
    from repro_torch.serve import JetServer
    with pytest.raises(RuntimeError, match="cuda"):
        JetServer(_tiny_qmlp())


def test_fleet_defaults_to_cuda():
    _no_cuda()
    from repro_torch.serve.fleet import FleetServer, TenantSpec
    with pytest.raises(RuntimeError, match="cuda"):
        FleetServer([TenantSpec(name="m", qmlp=_tiny_qmlp())])


def test_launch_serve_defaults_to_cuda():
    _no_cuda()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--events", "1", "--train-steps", "0"])


def test_launch_serve_fleet_defaults_to_cuda():
    _no_cuda()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--mix", "deepsets-32,jsc-m", "--replicas", "2",
                    "--events", "1", "--train-steps", "0"])


def test_training_defaults_to_cuda():
    _no_cuda()
    from repro_torch import configs, optim
    from repro_torch.distributed import steps
    from repro_torch.launch import train
    cfg = configs.get_reduced("granite-8b")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        steps.make_train_step(cfg, optim.AdamWConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        steps.make_prefill(cfg)


def test_models_default_to_cuda():
    _no_cuda()
    from repro_torch.models import deepsets, mlp
    with pytest.raises(RuntimeError, match="cuda"):
        mlp.mlp_init(4, [3])
    with pytest.raises(RuntimeError, match="cuda"):
        deepsets.deepsets_init(4, [3], [2])


def test_h100_calibration_needs_cuda():
    _no_cuda()
    from repro_torch.core import h100_model
    with pytest.raises(RuntimeError, match="CUDA"):
        h100_model.calibrate()
    with pytest.raises(RuntimeError, match="CUDA"):
        h100_model.calibrate("cpu")


def test_kernel_library_needs_cuda():
    _no_cuda()
    from repro_torch.kernels import _build
    with pytest.raises(RuntimeError):
        _build.library()


@pytest.mark.parametrize("op", ["mm_int8", "cascade_mlp", "deepsets",
                                "mlp_unfused", "global_agg", "flash_attention",
                                "flash_mha"])
def test_ops_take_no_other_device(op):
    """The wrappers run the plain version only for CPU tensors: anything
    that is neither CPU nor CUDA raises instead of falling back."""
    from repro_torch.kernels.cascade_mlp import cascade_mlp, deepsets, mlp_unfused
    from repro_torch.kernels.flash_attn import flash_attention, flash_mha
    from repro_torch.kernels.global_agg import global_agg
    from repro_torch.kernels.mm_int8 import mm_int8
    q = _tiny_qmlp(device="meta")
    x = torch.empty((2, 4), dtype=torch.int8, device="meta")
    a = torch.empty((1, 64, 4, 16), device="meta")
    with pytest.raises(ValueError, match="device"):
        if op == "mm_int8":
            mm_int8(x, q.layers[0].w_q)
        elif op == "cascade_mlp":
            cascade_mlp(x, q)
        elif op == "mlp_unfused":
            mlp_unfused(x, q)
        elif op == "deepsets":
            deepsets(x[None], q, _tiny_qmlp(3, 2, device="meta"))
        elif op == "global_agg":
            global_agg(x)
        elif op == "flash_attention":
            flash_attention(a[0], a[0], a[0], block_q=4, block_k=4)
        else:
            flash_mha(a, a[:, :, :2], a[:, :, :2], block_q=64, block_k=64)


@pytest.mark.parametrize("shift", [-1, 31])
def test_mm_int8_rejects_shift_out_of_range(shift):
    from repro_torch.kernels.mm_int8 import mm_int8
    x = torch.zeros((2, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="shift"):
        mm_int8(x, torch.zeros((4, 3), dtype=torch.int8), shift=shift)


def test_resolve_device_cpu():
    from repro_torch import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
