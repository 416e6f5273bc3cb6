"""lightgbm_tpu_torch stands alone: no jax, no lightgbm_tpu, and no quiet
fall back to the CPU.

The port may import torch and numpy only; the tests are the one place
where both packages meet. Its entry points run on the card unless the
caller passes device="cpu", so without a card they raise.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.utils.log import LightGBMError

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)

PKG = os.path.dirname(os.path.abspath(tlgb.__file__))
ROOT = os.path.dirname(PKG)


def test_import_pulls_in_neither_jax_nor_lightgbm_tpu():
    code = ("import sys, lightgbm_tpu_torch, lightgbm_tpu_torch.convert, "
            "lightgbm_tpu_torch.ops.kernels.build; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'lightgbm_tpu.')) or "
            "m == 'lightgbm_tpu']; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(os.path.join(d, f), PKG)
    for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    tree = ast.parse(open(os.path.join(PKG, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "lightgbm_tpu"), \
                "%s imports %s" % (path, name)


def test_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; nothing to refuse")
    x = np.random.RandomState(0).randn(100, 3)
    y = (x[:, 0] > 0).astype(float)
    with pytest.raises(LightGBMError, match="CUDA"):
        tlgb.train({"objective": "binary", "verbosity": -1},
                   tlgb.Dataset(x, y), num_boost_round=1)
    with pytest.raises(LightGBMError, match="CUDA"):
        tlgb.Booster(model_str="tree\n")


def test_serving_fleet_and_cli_pull_in_neither_jax_nor_lightgbm_tpu():
    code = ("import sys, lightgbm_tpu_torch.serving, "
            "lightgbm_tpu_torch.fleet, lightgbm_tpu_torch.cli; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'lightgbm_tpu.')) or "
            "m == 'lightgbm_tpu']; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_serving_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; nothing to refuse")
    from lightgbm_tpu_torch.cli import run
    from lightgbm_tpu_torch.serving import ModelRegistry, ServingApp
    x = np.random.RandomState(0).randn(200, 3)
    y = (x[:, 0] > 0).astype(float)
    bst = tlgb.train({"objective": "binary", "verbosity": -1},
                     tlgb.Dataset(x, y), num_boost_round=1, device="cpu")
    model = str(tmp_path / "model.txt")
    bst.save_model(model)
    with pytest.raises(LightGBMError, match="CUDA"):
        ServingApp()
    with pytest.raises(LightGBMError, match="CUDA"):
        ModelRegistry().load(bst)
    with pytest.raises(LightGBMError, match="CUDA"):
        run(["task=serve", "input_model=" + model, "serve_port=0"])
    # the schema's default device_type (cpu) is not a request for the CPU
    with pytest.raises(LightGBMError, match="CUDA"):
        run(["task=predict", "input_model=" + model,
             "data=" + model + ".csv"])


def test_capi_plotting_and_distributed_pull_in_neither_jax_nor_lightgbm_tpu():
    # nor matplotlib or graphviz: plotting imports them inside its
    # functions
    code = ("import sys, lightgbm_tpu_torch.capi_impl, "
            "lightgbm_tpu_torch.plotting, lightgbm_tpu_torch.distributed, "
            "lightgbm_tpu_torch.parallel.network, "
            "lightgbm_tpu_torch.parallel.mesh, "
            "lightgbm_tpu_torch.parallel.learners, "
            "lightgbm_tpu_torch.io.distributed; "
            "bad = [m for m in sys.modules if m in ('jax', 'lightgbm_tpu', "
            "'matplotlib', 'graphviz') or m.startswith(('jax.', 'jaxlib', "
            "'lightgbm_tpu.'))]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_capi_and_data_parallel_refuse_to_run_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present; nothing to refuse")
    import ctypes
    from lightgbm_tpu_torch.ops.kernels.build import capi_library
    monkeypatch.delenv("LGBM_TPU_DEVICE_TYPE", raising=False)
    x = np.random.RandomState(0).randn(100, 3)
    y = (x[:, 0] > 0).astype(float)
    with pytest.raises(LightGBMError, match="CUDA"):
        tlgb.train({"objective": "binary", "tree_learner": "data",
                    "verbosity": -1}, tlgb.Dataset(x, y), num_boost_round=1)
    lib = ctypes.CDLL(capi_library())
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    xf = np.ascontiguousarray(x)
    ds, bst = ctypes.c_void_p(), ctypes.c_void_p()
    assert lib.LGBM_DatasetCreateFromMat(
        xf.ctypes.data_as(ctypes.c_void_p), 1, 100, 3, 1, b"", None,
        ctypes.byref(ds)) == 0
    yl = y.astype(np.float32)
    assert lib.LGBM_DatasetSetField(
        ds, b"label", yl.ctypes.data_as(ctypes.c_void_p), 100, 0) == 0
    # no device key and no LGBM_TPU_DEVICE_TYPE: the card, which is absent
    assert lib.LGBM_BoosterCreate(ds, b"objective=binary",
                                  ctypes.byref(bst)) != 0
    assert b"CUDA" in lib.LGBM_GetLastError()
    it = ctypes.c_int()
    assert lib.LGBM_BoosterLoadModelFromString(
        b"tree\n", ctypes.byref(it), ctypes.byref(bst)) != 0
    assert b"CUDA" in lib.LGBM_GetLastError()
    assert lib.LGBM_BoosterCreate(ds, b"objective=binary device_type=cpu",
                                  ctypes.byref(bst)) == 0
    assert lib.LGBM_DatasetFree(ds) == 0


def test_capi_device_env_moves_only_model_loads(monkeypatch):
    # LGBM_TPU_DEVICE_TYPE=cpu reaches the model file and string loads
    # alone: a BoosterCreate whose parameter string names no device still
    # trains on the card
    if torch.cuda.is_available():
        pytest.skip("a card is present; nothing to refuse")
    import ctypes
    from lightgbm_tpu_torch.ops.kernels.build import capi_library
    monkeypatch.setenv("LGBM_TPU_DEVICE_TYPE", "cpu")
    x = np.random.RandomState(1).randn(100, 3)
    y = (x[:, 0] > 0).astype(float)
    lib = ctypes.CDLL(capi_library())
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    xf = np.ascontiguousarray(x)
    ds, bst = ctypes.c_void_p(), ctypes.c_void_p()
    assert lib.LGBM_DatasetCreateFromMat(
        xf.ctypes.data_as(ctypes.c_void_p), 1, 100, 3, 1, b"", None,
        ctypes.byref(ds)) == 0
    yl = y.astype(np.float32)
    assert lib.LGBM_DatasetSetField(
        ds, b"label", yl.ctypes.data_as(ctypes.c_void_p), 100, 0) == 0
    assert lib.LGBM_BoosterCreate(ds, b"objective=binary",
                                  ctypes.byref(bst)) != 0
    assert b"CUDA" in lib.LGBM_GetLastError()
    text = tlgb.train({"objective": "binary", "verbosity": -1},
                      tlgb.Dataset(x, y), num_boost_round=2,
                      device="cpu").model_to_string()
    it = ctypes.c_int()
    assert lib.LGBM_BoosterLoadModelFromString(
        text.encode(), ctypes.byref(it), ctypes.byref(bst)) == 0, \
        lib.LGBM_GetLastError()
    assert it.value == 2
    assert lib.LGBM_BoosterFree(bst) == 0
    assert lib.LGBM_DatasetFree(ds) == 0
