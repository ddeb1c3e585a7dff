"""The ServableModel contract and the registry, against the JAX package:
every reference arch id is registered, its config's fields equal the
reference's, its reduced SERVE model passes ``ensure_servable`` with the
reference's probes and cache families; ``UnservableModelError`` carries
the reference's message; the engine checks the contract before anything
else."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.nn.context import SERVE as J_SERVE
from repro.nn.context import ModelContext as JModelContext
from repro.serve import servable as j_servable
from repro_torch.configs import ARCH_IDS, build_model, get_config
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.lm import DecoderLM
from repro_torch.nn.context import SERVE, ModelContext
from repro_torch.serve import servable
from repro_torch.serve.engine import BatchedEngine, ServeConfig
from test_torch_weights import CONFIG_FIELDS

ENC_FIELDS = ("enc_layers", "dec_layers", "dec_ratio", "modality", "grad_accum",
              "attn_chunk", "remat")


def _models(arch):
    cj, ct = j_get_config(arch).reduced(), get_config(arch).reduced()
    jm = j_build_model(cj, JModelContext(policy=cj.tbn, mode=J_SERVE,
                                         compute_dtype=jnp.float32,
                                         use_pallas=False))
    tm = build_model(ct, ModelContext(policy=ct.tbn, mode=SERVE,
                                      compute_dtype=torch.float32, device="cpu"))
    return jm, tm


def test_registry_has_every_reference_arch():
    assert sorted(ARCH_IDS) == sorted(J_ARCH_IDS) and len(ARCH_IDS) == 10
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(J_ARCH_IDS))
def test_config_matches_reference(arch, reduced):
    cj, ct = j_get_config(arch), get_config(arch.replace("-", "_"))
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
    for f in CONFIG_FIELDS + ENC_FIELDS:
        assert getattr(ct, f) == getattr(cj, f), f
    assert dataclasses.asdict(ct.tbn) == dataclasses.asdict(cj.tbn)


@pytest.mark.parametrize("arch", sorted(J_ARCH_IDS))
def test_models_satisfy_contract_with_reference_probes(arch):
    jm, tm = _models(arch)
    assert servable.ensure_servable(tm) is tm
    assert isinstance(tm, EncDecModel if arch == "seamless-m4t-large-v2"
                      else DecoderLM)
    for probe in ("has_full_attn", "has_recurrent_state", "has_cross_attn"):
        assert getattr(tm, probe) == getattr(jm, probe), probe
    assert ([dataclasses.astuple(f) for f in tm.cache_families()]
            == [dataclasses.astuple(f) for f in jm.cache_families()])


def test_tables_match_reference():
    assert servable.SERVABLE_FAMILIES == j_servable.SERVABLE_FAMILIES
    assert servable.REQUIRED_ATTRS == j_servable.REQUIRED_ATTRS


@pytest.mark.parametrize("missing", [None, ("prefill", "extend")])
def test_unservable_error_text_matches_reference(missing):
    class Partial:
        pass

    if missing:
        for a in servable.REQUIRED_ATTRS:
            if a not in missing:
                setattr(Partial, a, None)
    with pytest.raises(servable.UnservableModelError) as ei:
        servable.ensure_servable(Partial())
    with pytest.raises(j_servable.UnservableModelError) as ej:
        j_servable.ensure_servable(Partial())
    assert str(ei.value) == str(ej.value)
    assert ei.value.missing == ej.value.missing == (missing or servable.REQUIRED_ATTRS)
    assert isinstance(ei.value, TypeError)
    what = servable.UnservableModelError("config family 'foo'")
    assert str(what) == str(j_servable.UnservableModelError("config family 'foo'"))


def test_engine_rejects_unservable_model_first():
    class NotAModel:
        device = torch.device("cpu")

    with pytest.raises(servable.UnservableModelError, match="missing: has_full_attn"):
        BatchedEngine(NotAModel(), {}, ServeConfig())


def test_decoder_lm_rejects_unknown_family():
    cfg = dataclasses.replace(get_config("granite-8b").reduced(), family="rnn")
    with pytest.raises(ValueError, match="not 'rnn'"):
        build_model(cfg, ModelContext(policy=cfg.tbn, device="cpu"))
    np.testing.assert_equal(
        [f.name for f in _models("granite-8b")[1].cache_families()], ["self_attn"])
