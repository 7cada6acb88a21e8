"""The port's config mirrors the JAX package's field for field."""

import dataclasses

import pytest
import torch

from icet_tpu import config as jcfg
from icet_tpu_torch import config as tcfg
from icet_tpu_torch.convert import config_from_icet

torch.set_num_threads(2)

CLASSES = ["ICETConfig", "OdometryConfig", "MapConfig", "KeyframeConfig",
           "BlockMapConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_match(name):
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(jcfg, name))]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(tcfg, name))]
    assert tf == jf


@pytest.mark.parametrize("profile", sorted(jcfg.PROFILES))
def test_profiles_match(profile):
    assert dataclasses.asdict(tcfg.PROFILES[profile]) == dataclasses.asdict(
        jcfg.PROFILES[profile]
    )
    assert set(tcfg.PROFILES) == set(jcfg.PROFILES)


@pytest.mark.parametrize("kw", [{}, {"radial_mode": "fixed", "n_shells": 7},
                                {"n_theta": 50, "phi_min": 0.3}])
def test_derived_properties_match(kw):
    j = jcfg.ICETConfig(**kw)
    t = config_from_icet(dataclasses.asdict(j))
    assert (t.n_voxels, t.n_angular, t.shell_growth) == (
        j.n_voxels, j.n_angular, j.shell_growth)
    assert t.replace(n_iters=3).n_iters == 3


def test_config_from_icet_rejects_unknown_field():
    fields = dataclasses.asdict(jcfg.ICETConfig())
    fields["not_a_field"] = 1
    with pytest.raises(ValueError):
        config_from_icet(fields)
