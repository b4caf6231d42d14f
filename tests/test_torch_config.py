"""The port's model configs equal the JAX package's, field for field.

Every arch, its ``reduced()`` form and the GQA-repeat test config
(``reduced(dtype=float32, n_kv_heads=2)``) are compared with the dtype
mapped from ``jnp`` to ``torch``."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as jreg
from repro_torch.configs import registry as treg

ARCH_IDS = sorted(jreg.ARCHS)


def _as_dict(cfg, dtype_name):
    d = dataclasses.asdict(cfg)
    d["dtype"] = dtype_name(d["dtype"])
    return d


def _jax(cfg):
    return _as_dict(cfg, lambda dt: jnp.dtype(dt).name)


def _torch(cfg):
    return _as_dict(cfg, lambda dt: str(dt).removeprefix("torch."))


def test_same_arch_set():
    assert sorted(treg.ARCHS) == ARCH_IDS
    assert treg.list_archs() == jreg.list_archs()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_fields_equal(arch):
    jc, tc = jreg.get_config(arch), treg.get_config(arch)
    assert _torch(tc) == _jax(jc)
    assert (tc.hd, tc.d_inner, tc.dt_rank) == (jc.hd, jc.d_inner, jc.dt_rank)
    assert tc.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_fields_equal(arch):
    jc, tc = jreg.get_config(arch), treg.get_config(arch)
    assert _torch(tc.reduced()) == _jax(jc.reduced())
    assert (_torch(tc.reduced(dtype=torch.float32, n_kv_heads=2))
            == _jax(jc.reduced(dtype=jnp.float32, n_kv_heads=2)))


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        treg.get_config("no-such-arch")
