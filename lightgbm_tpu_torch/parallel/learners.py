"""The tree learner factory.

Port of the serial branch of lightgbm_tpu/parallel/learners.py::
create_tree_learner (reference: src/treelearner/tree_learner.cpp:13-36
CreateTreeLearner). The choice is by configuration, the JAX package's: the
device learner when ``DeviceTreeLearner.supports`` takes the config and
``LGBM_TPU_HOST_LEARNER`` is not 1, else the host-loop
``SerialTreeLearner`` (forced splits, CEGB, a histogram pool over 2 GB).
It is never a way around a kernel that fails to build or launch: such a
failure raises wherever it happens. The parallel learners (feature, data,
voting) are not ported and raise naming the key.
"""
from __future__ import annotations

from ..config import Config
from ..io.dataset import Dataset
from ..models.device_learner import DeviceTreeLearner
from ..models.serial_learner import SerialTreeLearner
from ..utils import log
from ..utils.envs import host_learner_env
from ..utils.log import LightGBMError


def create_tree_learner(config: Config, dataset: Dataset, device="cpu"):
    """The learner of `config` (tree_learner=serial) on `device`."""
    name = config.tree_learner
    if name != "serial":
        raise LightGBMError("tree_learner=%s is not supported by "
                            "lightgbm_tpu_torch yet (serial only)" % name)
    if not host_learner_env() and DeviceTreeLearner.supports(config,
                                                             dataset):
        return DeviceTreeLearner(config, dataset, device=device)
    log.info("Using the host-loop serial tree learner (%s)",
             "LGBM_TPU_HOST_LEARNER=1" if host_learner_env()
             else "forced splits, CEGB or a histogram pool over 2 GB")
    return SerialTreeLearner(config, dataset, device=device)
