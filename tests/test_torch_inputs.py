"""The port's ``models/inputs.py`` against the reference's, on the CPU.

1. **Specs** — for every architecture of the registry and every shape
   the reference lists for it (``applicable_shapes``: train, prefill and,
   for decoders, decode), at full size and at the reduced shapes, the
   port's stand-ins (meta tensors) have the reference's names, shapes and
   dtypes; the decode specs' cache leaves are the reference's
   ``init_cache`` leaves (shapes and dtypes), built through the port's
   ``init_cache`` on the meta device, without memory.
2. **materialize** — seeded: one generator seed gives the same tensors,
   another different ones; token ids inside the vocabulary; the results
   feed ``forward`` of every family at the reduced config.
3. **Axes** — ``input_axes`` is the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import (REDUCED_SHAPE_DECODE, REDUCED_SHAPE_PREFILL,
                           REDUCED_SHAPE_TRAIN)
from repro.configs import applicable_shapes as ref_applicable_shapes
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import inputs as RIN
from repro.models import model as RM
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.models import inputs as PIN
from repro_torch.models import model as PM

DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _port_shape(shape):
    return ShapeSpec(shape.name, shape.seq_len, shape.global_batch,
                     shape.kind)


def _same_specs(port, ref):
    p, r = _leaves(port), _leaves(ref)
    assert sorted(p) == sorted(r)
    for name, leaf in r.items():
        got = p[name]
        assert got.device.type == "meta", name
        assert tuple(got.shape) == tuple(leaf.shape), name
        assert got.dtype == DTYPES[jnp.dtype(leaf.dtype)], name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_size_specs_match_reference(arch):
    """Every shape cell the reference lists for the architecture; the
    decode cells' caches run to 32,768 and 524,288 positions, on the meta
    device."""
    rcfg, pcfg = ref_get_config(arch), get_config(arch)
    cells = ref_applicable_shapes(rcfg)
    kinds = {s.kind for s in cells}
    assert {"train", "prefill"} <= kinds
    assert ("decode" in kinds) == (not pcfg.is_encoder_only())
    for shape in cells:
        want = RIN.input_specs(rcfg, shape)
        got = PIN.input_specs(pcfg, _port_shape(shape))
        _same_specs(got, want)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", [REDUCED_SHAPE_TRAIN,
                                   REDUCED_SHAPE_PREFILL,
                                   REDUCED_SHAPE_DECODE],
                         ids=lambda s: s.kind)
def test_reduced_specs_match_reference(arch, shape):
    rcfg = ref_reduced_config(ref_get_config(arch))
    pcfg = reduced_config(get_config(arch))
    if shape.kind == "decode" and pcfg.is_encoder_only():
        with pytest.raises(ValueError, match="encoder-only"):
            PIN.input_specs(pcfg, _port_shape(shape))
        return
    want = RIN.input_specs(rcfg, shape)
    got = PIN.input_specs(pcfg, _port_shape(shape))
    _same_specs(got, want)
    if shape.kind == "decode":
        cache = jax.eval_shape(lambda: RM.init_cache(
            rcfg, shape.global_batch, shape.seq_len))
        _same_specs(got["cache"], cache)
        real = PM.init_cache(pcfg, shape.global_batch, shape.seq_len,
                             device="cpu")
        for name, t in _leaves(real).items():
            assert t.shape == _leaves(got["cache"])[name].shape
            assert not t.any()


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_materialize_is_seeded_and_feeds_forward(arch):
    pcfg = reduced_config(get_config(arch))
    shape = _port_shape(REDUCED_SHAPE_TRAIN)
    specs = PIN.input_specs(pcfg, shape)
    a = PIN.materialize(specs, _gen(0), pcfg.vocab_size)
    b = PIN.materialize(specs, _gen(0), pcfg.vocab_size)
    c = PIN.materialize(specs, _gen(1), pcfg.vocab_size)
    assert sorted(a) == sorted(specs)
    for name in specs:
        assert a[name].device.type == "cpu"
        assert a[name].shape == specs[name].shape
        assert a[name].dtype == specs[name].dtype
        assert torch.equal(a[name], b[name]), name
        assert not torch.equal(a[name], c[name]), name
        if not a[name].dtype.is_floating_point:
            assert 0 <= int(a[name].min()) and \
                int(a[name].max()) < pcfg.vocab_size
    params = PM.init_params(pcfg, 0, device="cpu")
    batch = {k: v for k, v in a.items() if k != "labels"}
    logits, aux, _ = PM.forward(pcfg, params, batch)
    assert logits.shape == (shape.global_batch, shape.seq_len,
                            pcfg.vocab_size)
    assert torch.isfinite(logits).all() and torch.isfinite(aux)


def test_materialize_draws_a_cache_tree():
    """Decode specs hold the cache as a tree: materialize walks it."""
    pcfg = reduced_config(get_config("jamba-1.5-large-398b"))
    specs = PIN.input_specs(pcfg, _port_shape(REDUCED_SHAPE_DECODE))
    got = PIN.materialize(specs, _gen(3), pcfg.vocab_size)
    assert set(got["cache"]) == {"attn", "mamba"}
    assert got["cache"]["mamba"]["state"].dtype == torch.float32
    assert got["cache"]["mamba"]["state"].shape == \
        specs["cache"]["mamba"]["state"].shape
    assert np.isfinite(got["cache"]["attn"]["k"].numpy()).all()


def test_input_axes_waits_for_the_sharding_slice():
    """The sharding slice has come: ``input_axes`` is the reference's, for
    every reduced shape (``tests/test_torch_sharding.py`` holds the rest
    of the axes trees)."""
    rcfg = ref_reduced_config(ref_get_config("qwen3-8b"))
    pcfg = reduced_config(get_config("qwen3-8b"))
    for shape in (REDUCED_SHAPE_TRAIN, REDUCED_SHAPE_PREFILL,
                  REDUCED_SHAPE_DECODE):
        got = PIN.input_axes(pcfg, _port_shape(shape))
        assert got == RIN.input_axes(rcfg, shape), shape.name
