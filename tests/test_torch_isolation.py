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
