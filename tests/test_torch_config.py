"""The port's copy of the parameter schema resolves every parameter, and
every alias of it, to the same Config as the JAX package."""
import pytest

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.params_schema import PARAMS
from lightgbm_tpu_torch.config import Config as TConfig

_SAMPLE = {"int": "7", "float": "0.25", "bool": "true", "str": None,
           "vec_int": "1,2", "vec_float": "0.5,1.5", "vec_str": "a,b"}


def _value(p):
    v = _SAMPLE.get(p["type"], "1")
    # strings must stay inside the JAX package's accepted sets
    return p["default"] if v is None else v


@pytest.mark.parametrize("chunk", range(4))
def test_every_param_and_alias_resolves_alike(chunk):
    names = PARAMS[chunk::4]
    for p in names:
        for key in [p["name"]] + list(p["aliases"]):
            params = {key: _value(p)}
            try:
                want = JConfig(params).to_dict()
            except Exception as e:           # both must refuse alike
                with pytest.raises(Exception) as got:
                    TConfig(params)
                assert (type(got.value).__name__, str(got.value)) \
                    == (type(e).__name__, str(e)), key
                continue
            assert TConfig(params).to_dict() == want, key


def test_conflict_errors_alike():
    bad = {"is_unbalance": True, "scale_pos_weight": 2.0}
    with pytest.raises(Exception, match="is_unbalance"):
        JConfig(bad)
    with pytest.raises(Exception, match="is_unbalance"):
        TConfig(bad)
    both = {"num_leaves": 7, "max_leaves": 9}
    assert TConfig(both).num_leaves == JConfig(both).num_leaves == 7
