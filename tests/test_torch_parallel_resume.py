"""Checkpoints, resume and preemption of the port's data-parallel runs
across two processes, on the CPU.

Two ranks of ``python -m lightgbm_tpu_torch task=train num_machines=2
tree_learner=data device_type=cpu`` (per-rank bagging, so the resumed
bag draws must line up too), and two ranks of
tests/torch_dp_modes_worker.py (kind ``resume``). Held here:

* killed at iteration 2 on both ranks (``kill_rank@iter=2``, exit 137)
  with checkpoint_freq=1, then relaunched with resume=auto: the model
  text byte-equal to the uninterrupted run's;
* ``preempt@iter=2`` armed on rank 1 only: the vote makes both ranks
  exit 76 at the same boundary, rank 0 writes the one checkpoint (rank
  1's checkpoint directory stays empty: its resume is rank 0's
  broadcast), and the resume is byte-equal;
* a checkpoint the JAX package wrote of its 2-device data-parallel run
  restores on the port's two ranks: the trees' text is the file's, each
  rank's scores are the stored global scores cut to its block, and the
  ranks train on from it byte-equal.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.gbdt import create_boosting
from lightgbm_tpu.parallel import learners as jlearners
from lightgbm_tpu.parallel.mesh import make_mesh
from lightgbm_tpu.resilience.checkpoint import save_checkpoint

from lightgbm_tpu_torch.resilience.checkpoint import (CheckpointManager,
                                                      load_checkpoint)

import torch_dp_modes_worker as worker
import torch_dp_worker as base
from test_torch_parallel import _free_ports, _run_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ROUNDS = 5


def _launch(argv_of, env_of, timeout=240):
    """Both ranks to their end: their exit codes and outputs."""
    procs = [subprocess.Popen(argv_of(r), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=env_of(r)) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """run(tag, faults=(rank 0's, rank 1's), extra args) -> (exit codes,
    outputs, rank 0's model path, rank 1's model path)."""
    root = tmp_path_factory.mktemp("dp_resume")
    x, y = base.data()[:2]
    data = root / "train.csv"
    np.savetxt(data, np.column_stack([y, np.nan_to_num(x)]), delimiter=",",
               fmt="%.6f")

    def run(tag, faults=("", ""), extra=()):
        port = _free_ports(1)[0]
        models = [root / tag / "rank0" / "model.txt",
                  root / tag / "rank1" / "model.txt"]
        for m in models:
            m.parent.mkdir(parents=True, exist_ok=True)

        def env(r):
            # one CPU thread per rank: torch splits an elementwise op over
            # its threads and runs each part's tail unvectorized, so a
            # loaded host that hands a rank fewer threads moves an exp by
            # an ulp, and one run's trees off another's
            e = dict(os.environ, PYTHONPATH=ROOT,
                     LGBM_TPU_COORDINATOR="127.0.0.1:%d" % port,
                     LGBM_TPU_NUM_PROCESSES="2", LGBM_TPU_PROCESS_ID=str(r),
                     LGBM_TPU_FAULT_SPEC=faults[r], OMP_NUM_THREADS="1")
            e.pop("LGBM_TPU_NO_SIGNAL_HANDLERS", None)
            return e
        rcs, outs = _launch(lambda r: [
            sys.executable, "-m", "lightgbm_tpu_torch", "task=train",
            "data=%s" % data, "objective=binary", "num_leaves=7",
            "num_iterations=%d" % ROUNDS, "bagging_fraction=0.8",
            "bagging_freq=1", "num_machines=2", "tree_learner=data",
            "device_type=cpu", "output_model=%s" % models[r],
            "verbosity=-1"] + list(extra), env)
        return rcs, outs, models
    return run


def _model(path):
    """The model file's text before its parameters (which name the run's
    own paths and resume setting)."""
    text = path.read_text()
    return text[:text.index("\nparameters:")]


@pytest.fixture(scope="module")
def uninterrupted(cli):
    rcs, outs, models = cli("full", extra=["checkpoint_freq=1"])
    assert rcs == [0, 0], outs[0][-2000:] + outs[1][-2000:]
    assert not models[1].exists()               # model output is rank 0's
    return _model(models[0])


def test_kill_both_ranks_then_resume_is_byte_equal(cli, uninterrupted):
    rcs, outs, models = cli("kill", faults=("kill_rank@iter=2",) * 2,
                            extra=["checkpoint_freq=1"])
    assert rcs == [137, 137], outs
    ckpts = CheckpointManager(str(models[0]) + ".ckpt").checkpoints()
    assert [it for it, _ in ckpts] == [1, 2]
    assert not os.path.exists(str(models[1]) + ".ckpt")
    rcs, outs, _ = cli("kill", extra=["checkpoint_freq=1", "resume=auto"])
    assert rcs == [0, 0], outs[0][-2000:] + outs[1][-2000:]
    assert _model(models[0]) == uninterrupted


def test_one_rank_preempted_both_exit_76_then_resume(cli, uninterrupted):
    rcs, outs, models = cli("preempt", faults=("", "preempt@iter=2"))
    assert rcs == [76, 76], outs
    ckpts = CheckpointManager(str(models[0]) + ".ckpt").checkpoints()
    assert [it for it, _ in ckpts] == [2]
    data = load_checkpoint(ckpts[0][1])
    assert data.meta["preempted"] and data.meta["target_rounds"] == ROUNDS
    # rank 0 learned of rank 1's preemption through the vote
    assert data.meta["preempt_reason"] == "peer"
    assert not os.path.exists(str(models[1]) + ".ckpt")
    rcs, outs, _ = cli("preempt", extra=["resume=auto"])
    assert rcs == [0, 0], outs[0][-2000:] + outs[1][-2000:]
    assert _model(models[0]) == uninterrupted


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A checkpoint of the JAX package's data-parallel run on 2 devices,
    2 iterations, and the ranks' restore of it."""
    root = tmp_path_factory.mktemp("dp_jax_ckpt")
    x, y = base.data()[:2]
    mp = pytest.MonkeyPatch()
    mp.setattr(jlearners, "make_mesh", functools.partial(make_mesh, 2))
    try:
        cfg = JConfig(dict(worker.PARAMS))
        jb = create_boosting(cfg, JDataset(x, config=cfg, label=y))
        for _ in range(2):
            jb.train_one_iter()
        assert jb.learner.shards == 2
        path = str(root / "jax.ckpt")
        save_checkpoint(path, jb)
    finally:
        mp.undo()
    out = str(root)
    port = str(_free_ports(1)[0])
    _run_ranks(lambda r: [sys.executable,
                          os.path.join(HERE, "torch_dp_modes_worker.py"),
                          "resume", str(r), out, port, path])
    return path, [dict(np.load(os.path.join(out, "resume%d.npz" % r)))
                  for r in range(2)]


def _trees(text):
    """The model text's tree blocks."""
    return text[text.index("Tree=0"):text.index("end of trees")]


def test_jax_checkpoint_restores_on_two_ranks(jax_checkpoint):
    path, res = jax_checkpoint
    data = load_checkpoint(path)
    stored = data.state["train_score"]
    assert stored.shape == (1, base.N)          # one global score array
    for r in range(2):
        assert list(res[r]["iteration"]) == [2, 2]
        assert _trees(str(res[r]["text"])) == _trees(data.model_text)
        lo, hi = res[r]["block"]
        assert (lo, hi) == ((0, 1501) if r == 0 else (1501, base.N))
        np.testing.assert_array_equal(res[r]["score"], stored[:, lo:hi])
    assert str(res[0]["text_next"]) == str(res[1]["text_next"])
    assert str(res[0]["text_next"]).count("Tree=") == 3
