"""The tree learner factory.

Port of the serial branch of lightgbm_tpu/parallel/learners.py::
create_tree_learner (reference: src/treelearner/tree_learner.cpp:13-36
CreateTreeLearner). The choice is by configuration, the JAX package's: the
device learner when ``DeviceTreeLearner.supports`` takes the config and
``LGBM_TPU_HOST_LEARNER`` is not 1, else the host-loop
``SerialTreeLearner`` (forced splits, CEGB, a histogram pool over 2 GB).
It is never a way around a kernel that fails to build or launch: such a
failure raises wherever it happens. The parallel learners (feature, data,
voting) are not ported and raise naming the key. Under stream_mode the
learner is the device chunk learner or an error, never a silent resident
learner (the JAX package's gating): the host-loop learner
(LGBM_TPU_HOST_LEARNER=1, forced splits, CEGB) has no streaming path.
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
    stream = str(getattr(config, "stream_mode", "off") or "off")
    if stream != "off" and name != "serial":
        raise LightGBMError(
            "stream_mode=%s with tree_learner=%s has no streaming path in "
            "lightgbm_tpu_torch: streaming runs on the serial learner "
            "(streamed data-parallel comes with the multi-GPU slice, "
            "ROADMAP.md item 5)" % (stream, name))
    if name != "serial":
        raise LightGBMError("tree_learner=%s is not supported by "
                            "lightgbm_tpu_torch yet (serial only)" % name)
    if stream != "off":
        if host_learner_env():
            raise LightGBMError(
                "stream_mode=%s is incompatible with LGBM_TPU_HOST_LEARNER=1"
                " (the host-loop learner has no streaming path)" % stream)
        if not DeviceTreeLearner.supports(config, dataset):
            raise LightGBMError(
                "stream_mode=%s needs the device chunk learner but this "
                "config is unsupported by it (forced splits / CEGB / pool "
                "budget); fix the config or set stream_mode=off" % stream)
        return DeviceTreeLearner(config, dataset, device=device)
    if not host_learner_env() and DeviceTreeLearner.supports(config,
                                                             dataset):
        return DeviceTreeLearner(config, dataset, device=device)
    log.info("Using the host-loop serial tree learner (%s)",
             "LGBM_TPU_HOST_LEARNER=1" if host_learner_env()
             else "forced splits, CEGB or a histogram pool over 2 GB")
    return SerialTreeLearner(config, dataset, device=device)
