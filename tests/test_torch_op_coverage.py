"""The port's tensor API surface: the coverage audit of the reference's
api.yaml / backward.yaml entries (``paddle_tpu_torch/tools/op_coverage.py``)
and every public name of the JAX package's tensor-API modules.
"""
import importlib
import json
import re
import types
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu_torch as tp
from paddle_tpu_torch.tools import op_coverage as oc

ROOT = Path(__file__).resolve().parents[1]

# the counts this port reached (ROADMAP Queue 1 items 15, 16 and 17, the
# last with text.viterbi_decode): no later change may lose one
IMPLEMENTED_AT_LEAST = 228
BACKWARD_IMPLEMENTED_AT_LEAST = 176


@pytest.fixture(scope="module")
def report():
    return oc.audit()


def test_the_audit_counts_and_buckets(report):
    c = report["counts"]
    assert c["apis"] == 235 and c["backward_apis"] == 182
    assert c["implemented"] >= IMPLEMENTED_AT_LEAST
    assert c["backward_implemented"] >= BACKWARD_IMPLEMENTED_AT_LEAST
    assert c["implemented"] + c["waived"] + c["missing"] == c["apis"]
    assert (c["backward_implemented"] + c["backward_waived"] + c["backward_missing"]
            == c["backward_apis"])
    for name, reason in {**report["waived"], **report["backward"]["waived"]}.items():
        assert reason, name


def test_every_missing_entry_names_its_roadmap_item(report):
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for name, item in {**report["missing"], **report["backward"]["missing"]}.items():
        assert item, f"{name} is missing and names no ROADMAP item"
        number = re.match(r"Queue 1 item (\d+)", item).group(1)
        assert re.search(rf"^{number}\. \*\*", roadmap, re.M), (name, item)


def test_implemented_entries_resolve_to_callables(report):
    for name, path in report["implemented"].items():
        obj = tp
        for part in path.split("."):
            obj = getattr(obj, part)
        assert callable(obj), (name, path)
    assert report["implemented"]["top_k"] == "topk"
    assert report["implemented"]["where_index"] == "nonzero"


def test_the_snapshot_is_the_reference_tools_own():
    ours = json.loads((ROOT / "paddle_tpu_torch" / "tools" / "api_surface.json").read_text())
    theirs = json.loads((ROOT / "tools" / "api_surface.json").read_text())
    assert ours["apis"] == theirs["apis"] and ours["backward_apis"] == theirs["backward_apis"]


def test_the_cli_prints_the_three_counts(capsys):
    oc.main([])
    out = capsys.readouterr().out
    assert re.search(r"implemented \d+\s+waived \d+\s+missing \d+", out)


# ---- every public name of the reference's tensor-API modules ----

MODULES = {   # reference module -> its port counterpart
    "paddle_tpu.core.dtype": "paddle_tpu_torch.core.dtype",
    "paddle_tpu.core.place": "paddle_tpu_torch.core.place",
    "paddle_tpu.core.random": "paddle_tpu_torch.core.random",
    "paddle_tpu.core.autograd": "paddle_tpu_torch.core.autograd",
    "paddle_tpu.autograd": "paddle_tpu_torch.autograd",
    "paddle_tpu.ops._helpers": "paddle_tpu_torch.ops._helpers",
    "paddle_tpu.ops.attribute": "paddle_tpu_torch.ops.attribute",
    "paddle_tpu.ops.creation": "paddle_tpu_torch.ops.creation",
    "paddle_tpu.ops.math": "paddle_tpu_torch.ops.math",
    "paddle_tpu.ops.reduction": "paddle_tpu_torch.ops.reduction",
    "paddle_tpu.ops.manipulation": "paddle_tpu_torch.ops.manipulation",
    "paddle_tpu.ops.linalg": "paddle_tpu_torch.ops.linalg",
    "paddle_tpu.ops.activation": "paddle_tpu_torch.ops.activation",
    "paddle_tpu.ops": "paddle_tpu_torch.ops",
    "paddle_tpu.ops.nn_functional": "paddle_tpu_torch.ops.nn_functional",
    "paddle_tpu.nn": "paddle_tpu_torch.nn",
    "paddle_tpu.nn.functional": "paddle_tpu_torch.nn.functional",
    "paddle_tpu.nn.initializer": "paddle_tpu_torch.nn.initializer",
    "paddle_tpu.nn.layer": "paddle_tpu_torch.nn.layer",
    "paddle_tpu.nn.utils": "paddle_tpu_torch.nn.utils",
    "paddle_tpu.text": "paddle_tpu_torch.text",
}

# ROADMAP Queue 1 item 15's waiver list: reference names with no port counterpart
WAIVED = {
    "apply": "the reference's op dispatcher (core/dispatch.py); each port op is a torch call",
    "as_tensor": "the dispatcher's operand coercion; the port's is ops/_helpers.t_",
    "register_kernel": "the dispatcher's kernel registry",
    "flag": "the reference's tpu_matmul_precision flag; torch's TF32 switch governs the port",
    "Node": "the reference's tape node; the port's graph is torch.autograd's grad_fn",
    "next_key": "JAX's functional RNG keys; the port draws from torch.Generators",
    "trace_key_scope": "JAX's functional RNG keys in traced programs",
}


def _public(mod):
    out = []
    for n, v in vars(mod).items():
        if n.startswith("_") or isinstance(v, types.ModuleType):
            continue
        if isinstance(v, np.dtype) or str(getattr(v, "__module__", "")).startswith("paddle_tpu"):
            out.append(n)
    return out


@pytest.mark.parametrize("ref,port", list(MODULES.items()), ids=list(MODULES))
def test_every_public_name_resolves_in_the_port_or_is_waived(ref, port):
    rmod, pmod = importlib.import_module(ref), importlib.import_module(port)
    helpers = importlib.import_module("paddle_tpu_torch.ops._helpers")
    names = _public(rmod)
    assert names
    unresolved = [n for n in names
                  if not any(hasattr(m, n) for m in (pmod, tp, helpers)) and n not in WAIVED]
    assert not unresolved, f"{ref}: {unresolved}"


def test_the_waivers_stand_on_the_roadmap():
    roadmap = (ROOT / "ROADMAP.md").read_text()
    section = roadmap[roadmap.index("Waived names of the tensor API"):]
    for name in WAIVED:
        assert f"`{name}`" in section[:3000], name


def test_top_level_names_of_the_reference():
    import paddle_tpu as jp

    names = [n for n in ("bfloat16", "bool", "bool_", "float16", "float32", "float64", "int8",
                         "int16", "int32", "int64", "uint8", "complex64", "complex128",
                         "convert_dtype", "finfo", "iinfo", "get_default_dtype",
                         "set_default_dtype", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace",
                         "TPUPlace", "XPUPlace", "NPUPlace", "MLUPlace", "IPUPlace",
                         "CustomPlace", "NPUPinnedPlace", "Place", "set_device", "get_device",
                         "device_count", "seed", "get_rng_state", "set_rng_state",
                         "get_cuda_rng_state", "set_cuda_rng_state", "grad", "no_grad",
                         "enable_grad", "set_grad_enabled", "is_grad_enabled", "Tensor",
                         "in_dynamic_mode", "enable_static", "disable_static", "tolist",
                         "tanh_", "squeeze_", "unsqueeze_", "scatter_", "linalg", "dtype",
                         "set_printoptions", "disable_signal_handler", "get_flags",
                         "set_flags", "save", "load", "autograd", "amp")
             if hasattr(jp, n)]
    assert len(names) > 50
    assert [n for n in names if not hasattr(tp, n)] == []
    assert tp.Tensor is __import__("torch").Tensor and tp.in_dynamic_mode()
