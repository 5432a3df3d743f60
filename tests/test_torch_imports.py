"""paddle_tpu_torch stands alone: no jax, no paddle_tpu, CUDA by default.

``import paddle_tpu`` (which tests/conftest.py does in every test process)
loads jax, so the import check runs in a fresh subprocess.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
from paddle_tpu_torch.ops.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "paddle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def test_the_fsdp_and_checkpoint_modules_are_among_them():
    mods = set(_port_modules())
    assert {"paddle_tpu_torch.distributed.elastic", "paddle_tpu_torch.distributed.grad_comm",
            "paddle_tpu_torch.distributed.engine", "paddle_tpu_torch.tools.ckpt_fsck"} <= mods
    helpers = [ROOT / "tests" / "torch_dp_workers.py", ROOT / "tests" / "torch_fsdp_workers.py",
               ROOT / "tests" / "torch_obs_workers.py", ROOT / "tests" / "torch_tp_workers.py",
               ROOT / "tests" / "torch_pp_workers.py"]
    for path in helpers:   # the rank bodies run on the card's machine, which has no jax
        assert not {r for r in _imported_roots(path) if r in FORBIDDEN}, path.name


def test_the_optimizer_surface_modules_are_among_them():
    assert {"paddle_tpu_torch.regularizer", "paddle_tpu_torch.incubate",
            "paddle_tpu_torch.incubate.optimizer", "paddle_tpu_torch.optimizer.lr",
            "paddle_tpu_torch.amp"} <= set(_port_modules())
    scanned = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"regularizer.py", "incubate/__init__.py", "incubate/optimizer.py"} <= scanned


def test_the_paged_serving_modules_are_among_them():
    assert {"paddle_tpu_torch.serving.kv_pages", "paddle_tpu_torch.serving.prefix_cache",
            "paddle_tpu_torch.serving.engine"} <= set(_port_modules())


def test_the_parameter_server_and_rec_modules_are_among_them():
    assert {"paddle_tpu_torch.core.native", "paddle_tpu_torch.distributed.ps",
            "paddle_tpu_torch.distributed.ps.service", "paddle_tpu_torch.distributed.ps.runtime",
            "paddle_tpu_torch.distributed.ps.layers", "paddle_tpu_torch.distributed.fleet.dataset",
            "paddle_tpu_torch.models.rec", "paddle_tpu_torch.examples.train_widedeep_ps",
            "paddle_tpu_torch.tools.northstar_bench"} <= set(_port_modules())
    scanned = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"core/native/__init__.py", "distributed/ps/service.py", "models/rec.py",
            "distributed/fleet/dataset.py"} <= scanned


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        bad = {r for r in _imported_roots(path) if r in FORBIDDEN}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForPretraining(gpt_tiny())
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    model = GPTForPretraining(gpt_tiny(), device="cpu")
    assert model.device == torch.device("cpu")
    # hapi.Model follows its network's tensors; a network that holds none
    # runs on the card, and so refuses here rather than running on the CPU
    from paddle_tpu_torch.hapi import Model

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(torch.nn.ReLU()).predict_batch([torch.ones(2)])
    assert Model(torch.nn.Linear(2, 2)).device == torch.device("cpu")


def test_every_kernel_source_has_a_stable_build_key():
    names = _build.sources()
    assert {"flash_attention_fwd", "flash_attention_bwd", "layer_norm",
            "lm_loss"} <= set(names)
    for n in names:
        p = _build.library_path(n)
        assert p == _build.library_path(n)
        assert p.parent == _build.BUILD_DIR and p.name.startswith(n + "-")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_the_eager_fleet_modules_are_among_them():
    assert {"paddle_tpu_torch.framework.io", "paddle_tpu_torch.distributed.meta_parallel",
            "paddle_tpu_torch.distributed.meta_parallel.data_parallel",
            "paddle_tpu_torch.distributed.meta_parallel.sharding",
            "paddle_tpu_torch.distributed.fleet.meta_optimizers",
            "paddle_tpu_torch.distributed.fleet.hybrid_parallel_optimizer"} <= set(_port_modules())
    path = ROOT / "tests" / "torch_fleet_workers.py"   # rank bodies; the card's machine has no jax
    assert not {r for r in _imported_roots(path) if r in FORBIDDEN}


FLEET_MODULES = (
    "paddle_tpu_torch.serving.router", "paddle_tpu_torch.serving.loadgen",
    "paddle_tpu_torch.observability.metrics", "paddle_tpu_torch.observability.tracer",
    "paddle_tpu_torch.observability.step_telemetry", "paddle_tpu_torch.observability.fleet",
    "paddle_tpu_torch.observability.flight_recorder", "paddle_tpu_torch.observability.slo",
    "paddle_tpu_torch.observability.capacity", "paddle_tpu_torch.observability.exporter",
    "paddle_tpu_torch.distributed.store", "paddle_tpu_torch.distributed._py_store",
    "paddle_tpu_torch.distributed.membership")
# the train step's observability and its last entry points
TRAIN_OBS_MODULES = ("paddle_tpu_torch.observability.health",
                     "paddle_tpu_torch.distributed.prefetcher", "paddle_tpu_torch.core.monitor")


def test_the_serving_fleet_modules_are_among_them():
    assert set(FLEET_MODULES) <= set(_port_modules())
    for mod in FLEET_MODULES:   # the AST scan's view of each, by name
        path = ROOT / (mod.replace(".", "/") + ".py")
        assert not {r for r in _imported_roots(path) if r in FORBIDDEN}, mod


def test_the_train_obs_modules_are_among_them():
    assert set(TRAIN_OBS_MODULES) <= set(_port_modules())
    for mod in TRAIN_OBS_MODULES:
        path = ROOT / (mod.replace(".", "/") + ".py")
        assert not {r for r in _imported_roots(path) if r in FORBIDDEN}, mod


@pytest.mark.parametrize("mod", FLEET_MODULES)
def test_each_serving_fleet_module_alone_loads_no_jax(mod):
    """Imported alone in a fresh process, each new module (and what it
    imports) loads neither jax nor the JAX package."""
    code = (f"import importlib, sys; importlib.import_module({mod!r}); "
            f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r}); "
            "print('LOADED', bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def test_the_tensor_and_sequence_parallel_modules_are_among_them():
    assert {"paddle_tpu_torch.distributed.meta_parallel.mp_layers",
            "paddle_tpu_torch.distributed.meta_parallel.parallel_layers",
            "paddle_tpu_torch.distributed.meta_parallel.sequence_parallel"} <= set(
                _port_modules())


PP_EP_MODULES = ("paddle_tpu_torch.distributed.pipeline_schedule",
                 "paddle_tpu_torch.distributed.meta_parallel.pp_layers",
                 "paddle_tpu_torch.distributed.meta_parallel.pipeline_parallel",
                 "paddle_tpu_torch.distributed.meta_parallel.moe")


def test_the_pipeline_and_expert_parallel_modules_are_among_them():
    assert set(PP_EP_MODULES) <= set(_port_modules())
    for mod in PP_EP_MODULES:   # the AST scan's view of each, by name
        path = ROOT / (mod.replace(".", "/") + ".py")
        assert not {r for r in _imported_roots(path) if r in FORBIDDEN}, mod


VISION_ERNIE_MODULES = (
    "paddle_tpu_torch.ops.activation",
    "paddle_tpu_torch.nn.layers", "paddle_tpu_torch.nn.layers.common",
    "paddle_tpu_torch.nn.layers.activation", "paddle_tpu_torch.nn.layers.container",
    "paddle_tpu_torch.nn.layers.conv_pool", "paddle_tpu_torch.nn.layers.norm",
    "paddle_tpu_torch.nn.layers.loss", "paddle_tpu_torch.vision",
    "paddle_tpu_torch.vision.models", "paddle_tpu_torch.vision.models.resnet",
    "paddle_tpu_torch.vision.models.lenet", "paddle_tpu_torch.models.ernie")


def test_the_vision_and_ernie_modules_are_among_them():
    assert set(VISION_ERNIE_MODULES) <= set(_port_modules())
    for mod in VISION_ERNIE_MODULES:   # the AST scan's view of each, by name
        path = ROOT / (mod.replace(".", "/") + ".py")
        if not path.exists():
            path = ROOT / mod.replace(".", "/") / "__init__.py"
        assert not {r for r in _imported_roots(path) if r in FORBIDDEN}, mod
    path = ROOT / "tests" / "torch_vision_workers.py"   # rank bodies: no jax
    assert not {r for r in _imported_roots(path) if r in FORBIDDEN}


DATA_HAPI_MODULES = (
    "paddle_tpu_torch.io", "paddle_tpu_torch.reader", "paddle_tpu_torch.vision.datasets",
    "paddle_tpu_torch.vision.transforms", "paddle_tpu_torch.metric",
    "paddle_tpu_torch.hapi", "paddle_tpu_torch.hapi.callbacks", "paddle_tpu_torch.hapi.model",
    "paddle_tpu_torch.hapi.summary", "paddle_tpu_torch.hapi.dynamic_flops",
    "paddle_tpu_torch.callbacks", "paddle_tpu_torch.examples",
    "paddle_tpu_torch.examples.train_mnist_dygraph")


def test_the_data_and_hapi_modules_are_among_them():
    assert set(DATA_HAPI_MODULES) <= set(_port_modules())
    for mod in DATA_HAPI_MODULES:   # the AST scan's view of each, by name
        path = ROOT / (mod.replace(".", "/") + ".py")
        if not path.exists():
            path = ROOT / mod.replace(".", "/") / "__init__.py"
        assert not {r for r in _imported_roots(path) if r in FORBIDDEN}, mod
    path = ROOT / "tests" / "torch_elastic_workers.py"   # rank bodies: no jax
    assert not {r for r in _imported_roots(path) if r in FORBIDDEN}


def test_the_top_level_names_load_lazily():
    """``import paddle_tpu_torch`` loads none of the data and hapi modules;
    their top-level names load them at first use."""
    code = ("import sys, paddle_tpu_torch as P\n"
            "lazy = ('paddle_tpu_torch.io', 'paddle_tpu_torch.hapi', 'paddle_tpu_torch.metric',"
            " 'paddle_tpu_torch.reader', 'paddle_tpu_torch.distributed')\n"
            "assert not [m for m in lazy if m in sys.modules], sorted(sys.modules)\n"
            "from paddle_tpu_torch.hapi import Model, flops, summary\n"
            "from paddle_tpu_torch.reader import batch\n"
            "assert (P.Model, P.summary, P.flops, P.batch) == (Model, summary, flops, batch)\n"
            "assert P.io.DataLoader and P.metric.Accuracy and P.callbacks.EarlyStopping\n"
            "assert P.hapi.Model is Model and P.vision.datasets.MNIST\n"
            "print('OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "OK" in res.stdout, res.stdout + res.stderr


TENSOR_API_MODULES = (
    "paddle_tpu_torch.core.dtype", "paddle_tpu_torch.core.place", "paddle_tpu_torch.core.random",
    "paddle_tpu_torch.core.autograd", "paddle_tpu_torch.autograd", "paddle_tpu_torch.ops",
    "paddle_tpu_torch.ops._helpers", "paddle_tpu_torch.ops.attribute",
    "paddle_tpu_torch.ops.creation", "paddle_tpu_torch.ops.math",
    "paddle_tpu_torch.ops.reduction", "paddle_tpu_torch.ops.manipulation",
    "paddle_tpu_torch.ops.linalg", "paddle_tpu_torch.ops.activation",
    "paddle_tpu_torch.tools.op_coverage",
    # the second half: nn's layer, initializer, functional and utils modules
    "paddle_tpu_torch.nn", "paddle_tpu_torch.nn.layer", "paddle_tpu_torch.nn.initializer",
    "paddle_tpu_torch.nn.functional", "paddle_tpu_torch.nn.utils",
    "paddle_tpu_torch.nn.layers.transformer", "paddle_tpu_torch.nn.layers.decode",
    "paddle_tpu_torch.ops.nn_functional")


def test_the_tensor_api_modules_are_among_them():
    assert set(TENSOR_API_MODULES) <= set(_port_modules())
    for mod in TENSOR_API_MODULES:   # the AST scan's view of each, by name
        path = ROOT / (mod.replace(".", "/") + ".py")
        if not path.exists():
            path = ROOT / mod.replace(".", "/") / "__init__.py"
        assert not {r for r in _imported_roots(path) if r in FORBIDDEN}, mod



TEXT_MODULES = ("paddle_tpu_torch.nn.layers.rnn", "paddle_tpu_torch.nn.layers.decode",
                "paddle_tpu_torch.text", "paddle_tpu_torch.text.datasets",
                "paddle_tpu_torch.text.viterbi", "paddle_tpu_torch.text.faster_tokenizer")


@pytest.mark.parametrize("mod", TEXT_MODULES)
def test_each_rnn_and_text_module_alone_loads_no_jax(mod):
    """The RNN layers, the decoder and paddle.text, each imported alone in a
    fresh process: neither jax nor the JAX package loads; the native
    tokenizer's source is the JAX package's, byte for byte."""
    assert mod in set(_port_modules())
    code = (f"import importlib, sys; importlib.import_module({mod!r}); "
            f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r}); "
            "print('LOADED', bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert ((PORT / "core" / "native" / "tokenizer.cc").read_bytes()
            == (ROOT / "paddle_tpu" / "core" / "native" / "tokenizer.cc").read_bytes())
