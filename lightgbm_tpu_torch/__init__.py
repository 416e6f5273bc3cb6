"""lightgbm_tpu_torch: the PyTorch / CUDA port of lightgbm_tpu.

Slice 1 trains binary and L2-regression GBDT on one NVIDIA H100 through
the compact growth core, with hand-written Hopper kernels for the
histogram (K1) and the stable row partition (K4), and writes and reads
model text v2.3.1. It imports torch and numpy, never jax nor lightgbm_tpu.

    import lightgbm_tpu_torch as lgb
    bst = lgb.train({"objective": "binary"}, lgb.Dataset(x, y))
    p = bst.predict(x)

Entry points run on the card; ``device="cpu"`` runs the kernels' plain
PyTorch versions on the CPU instead.
"""
from .basic import Booster, Dataset
from .engine import train
from .utils.log import LightGBMError

__all__ = ["Booster", "Dataset", "train", "LightGBMError"]
