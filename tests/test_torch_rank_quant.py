"""Quantized lambdarank where quant_max's cap binds: above 32,768 rows
the 16-bit row store keeps 2^30 / N levels, fewer than 32,767. On the JAX
package's gradients replayed into the port (tests/rank_quant_witness.py)
the stored integers, the trees and the validation ndcg history are the
JAX package's; the leaf-local re-quantization ratio is its f32 quotient
bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import torch

import rank_quant_witness

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)


def test_requant_ratio_matches_jax():
    # every leaf max the 16-bit row store can hold: the leaf-local ratio
    # is the JAX package's f32 quotient bit for bit
    from lightgbm_tpu.ops import quantize as jq
    from lightgbm_tpu_torch.ops import quantize as tq
    m = np.arange(32768, dtype=np.float32)
    for qcap in (127, 7):
        np.testing.assert_array_equal(
            tq.requant_ratio(torch.from_numpy(m), qcap).numpy(),
            np.asarray(jq.requant_ratio(jnp.asarray(m), qcap)))


def test_quantized_lambdarank_where_the_cap_binds(monkeypatch):
    # 1,700 queries of 20: quant_max(16, N) = 31,580 levels. On the same
    # gradients both packages store the same integers and grow the same
    # trees
    monkeypatch.setenv("LGBM_TPU_STRATEGY", "compact")
    runs, recorded = rank_quant_witness.replay_quantized(1_700, 2, 63)
    (jb, jh), (tb, th) = runs["jax"], runs["torch"]
    assert tb._gbdt.learner.strategy == "compact"
    assert tb._gbdt.learner.quant_bits == 8 and tb._gbdt.learner.quant_renew
    assert len(recorded) == 2
    assert all(rank_quant_witness.stored_integers_equal(*gh)
               for gh in recorded)
    for ta, tt in zip(jb._gbdt.models, tb._gbdt.models):
        assert rank_quant_witness.structure(ta) \
            == rank_quant_witness.structure(tt)
        assert rank_quant_witness.leaf_rel_diff(ta, tt) <= 1e-5
    np.testing.assert_allclose(th, jh, rtol=0, atol=1e-5)
