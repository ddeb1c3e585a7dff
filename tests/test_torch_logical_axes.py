"""Logical axes of the port's param trees against the JAX package: for every
registered arch (``.reduced()``) and every paper builder, in TRAIN and SERVE
mode, ``nn.module.logical_axes`` of the port's specs equals the reference's
leaf for leaf (the same "/"-joined paths, the same tuple of axis names), and
``stack_specs`` prepends "layers" as the reference's does. These tuples are
what ``distributed.sharding.param_specs`` resolves onto a mesh."""
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.models.paper import build_paper_model as j_build_paper_model
from repro.nn import module as j_mod
from repro.nn.context import SERVE as J_SERVE
from repro.nn.context import TRAIN as J_TRAIN
from repro.nn.context import ModelContext as JModelContext
from repro_torch.configs import build_model, get_config
from repro_torch.models.paper import build_paper_model
from repro_torch.nn import module as mod
from repro_torch.nn.context import SERVE, TRAIN, ModelContext
from test_torch_paper import CASES, _policy

MODES = {"train": (J_TRAIN, TRAIN), "serve": (J_SERVE, SERVE)}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {"/".join(path): tuple(tree)}


def _jctx(pol, mode):
    return JModelContext(policy=pol, mode=mode, compute_dtype=jnp.float32,
                         use_pallas=False)


def _tctx(pol, mode):
    return ModelContext(policy=pol, mode=mode, compute_dtype=torch.float32,
                        device="cpu")


def _assert_same(jm, tm):
    want = _flat(j_mod.logical_axes(jm.specs()))
    got = _flat(mod.logical_axes(tm.specs()))
    assert sorted(got) == sorted(want)
    diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not diff, diff


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", sorted(J_ARCH_IDS))
def test_arch_logical_axes_match_reference(arch, mode):
    jmode, tmode = MODES[mode]
    cj, ct = j_get_config(arch).reduced(), get_config(arch).reduced()
    jm = j_build_model(cj, _jctx(cj.tbn, jmode))
    tm = build_model(ct, _tctx(ct.tbn, tmode))
    _assert_same(jm, tm)
    if hasattr(jm, "logical"):
        assert _flat(tm.logical()) == _flat(jm.logical())


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_paper_logical_axes_match_reference(name, mode):
    jmode, tmode = MODES[mode]
    builder, kw, (kind, p, lam), _, _ = CASES[name]
    jm = j_build_paper_model(builder, _jctx(_policy(kind, p, lam, True), jmode),
                             **kw)
    tm = build_paper_model(builder, _tctx(_policy(kind, p, lam, False), tmode),
                           **kw)
    _assert_same(jm, tm)


def test_stack_specs_prepends_layers():
    specs = {"w": mod.ParamSpec((4, 8), torch.float32, ("mlp", "embed")),
             "b": mod.ParamSpec((4,), torch.float32)}
    stacked = mod.stack_specs(specs, 3)
    assert mod.logical_axes(stacked) == {"w": ("layers", "mlp", "embed"),
                                         "b": ("layers", None)}
    assert stacked["w"].shape == (3, 4, 8)
    with pytest.raises(ValueError, match="does not match shape"):
        mod.ParamSpec((4, 8), torch.float32, ("mlp",))
