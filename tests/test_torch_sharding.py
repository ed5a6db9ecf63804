"""The port's mesh-bound layers against the reference's on the CPU: the
production meshes over the ``fake`` process group (world 256 and 512 in
this one process), the logical-axis rules (the reference's
``TestLogicalRules``, case for case), and every parameter, optimizer-state,
decode-cache, batch and input spec of all ten architectures at their
published widths, on 16 x 16 and 2 x 16 x 16.

The reference's side is its own functions on a stand-in of its mesh (the
only attributes they read: ``axis_names``, ``devices.shape``), with its
``NamedSharding`` constructor replaced by a holder of the spec (a real one
wants 256 jax devices).  Specs are equal exactly; the placements are held
against the local shapes they give.
"""

from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.launch import specs as jspecs
from repro.sharding import rules as jrules
from repro.sharding.logical import logical_to_mesh as jl2m
from repro_torch.configs import registry as treg
from repro_torch.launch.mesh import (make_cpu_mesh, make_production_mesh,
                                     mesh_axis_sizes)
from repro_torch.launch.specs import ShardedMeta, input_specs
from repro_torch.models import abstract_params
from repro_torch.optim.adamw import OptState
from repro_torch.sharding import (NamedSharding, PartitionSpec as P,
                                  axis_rules, constrain, logical_to_mesh)
from repro_torch.sharding import rules as trules
from repro_torch.tree import leaf_id, leaves_with_path

from _torch_parity import fake_world, mesh_stand_in

MESHES = {"16x16": (False, (16, 16), ("data", "model")),
          "2x16x16": (True, (2, 16, 16), ("pod", "data", "model"))}


class _Spec:
    """Stands in for ``jax.sharding.NamedSharding``: keeps the spec."""

    def __init__(self, mesh, spec):
        self.spec = spec


@pytest.fixture
def reference(monkeypatch):
    """The reference's rules and specs modules with ``NamedSharding``
    holding the spec, and ``_sds`` returning ``(shape, dtype name,
    spec)``."""
    monkeypatch.setattr(jrules, "NamedSharding", _Spec)
    monkeypatch.setattr(jspecs, "_sds", lambda shape, dtype, sharding=None:
                        (tuple(shape), np.dtype(dtype).name,
                         _norm(sharding.spec)))
    return jrules


def _norm(spec) -> tuple:
    """A spec as a tuple, a one-axis tuple entry as its name (jax 0.9's
    ``PartitionSpec`` spells ``("data",)`` as ``"data"``; both mean one
    axis)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _ref_id(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(
        k, "name", k)))) for k in path) or "root"


def _flat_ref(tree, is_leaf=None) -> dict:
    return {_ref_id(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _flat(tree) -> dict:
    return {leaf_id(p): x for p, x in leaves_with_path(tree)}


def _local_shape(shape, sharding: NamedSharding) -> tuple:
    """Each rank's shard by the placements (the dims divide)."""
    from torch.distributed.tensor import Shard
    sizes = tuple(sharding.mesh.shape)
    out = list(shape)
    for size, pl in zip(sizes, sharding.placements):
        if isinstance(pl, Shard):
            assert out[pl.dim] % size == 0
            out[pl.dim] //= size
    return tuple(out)


def _spec_local_shape(shape, spec, sizes: dict) -> tuple:
    out = list(shape)
    for d, ax in enumerate(spec):
        for a in (() if ax is None else (ax,) if isinstance(ax, str)
                  else ax):
            out[d] //= sizes[a]
    return tuple(out)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_production_mesh_over_fake_group(mesh_id):
    multi_pod, shape, axes = MESHES[mesh_id]
    with fake_world(math.prod(shape)):
        m = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert m.mesh_dim_names == axes
        assert mesh_axis_sizes(m) == dict(zip(axes, shape))
        assert trules.activation_rules(m) == jrules.activation_rules(
            mesh_stand_in(shape, axes))
        assert trules.DATA_AXES(m) == jrules.DATA_AXES(
            mesh_stand_in(shape, axes))
    assert not dist.is_initialized()


def test_mesh_refuses_a_world_it_does_not_fill():
    with pytest.raises(RuntimeError, match="process group"):
        make_cpu_mesh(1, 1)
    with fake_world(8):
        with pytest.raises(ValueError, match="needs 4 ranks"):
            make_cpu_mesh(2, 2)
        with pytest.raises(ValueError, match="needs 256 ranks"):
            make_production_mesh(device_type="cpu")


# ---------------------------------------------------------------------------
# the reference's TestLogicalRules, case for case
# ---------------------------------------------------------------------------

class TestLogicalRules:
    def test_no_rules_is_identity_spec(self):
        assert logical_to_mesh(["batch", "embed"], rules=None) == \
            P(None, None)

    def test_basic_binding(self):
        rules = {"batch": "data", "ffn": "model"}
        spec = logical_to_mesh(["batch", None, "ffn"], rules=rules)
        assert spec == P("data", None, "model")

    def test_divisibility_fallback(self):
        with fake_world(1):
            mesh = make_cpu_mesh(1, 1)
            spec = logical_to_mesh(["kv"], shape=[7],
                                   rules={"kv": "model"}, mesh=mesh)
        assert spec == P("model")  # size-1 axis always divides

    def test_duplicate_mesh_axis_dedup(self):
        rules = {"heads": "model", "ffn": "model"}
        assert logical_to_mesh(["heads", "ffn"], rules=rules) == \
            P("model", None)

    def test_constrain_noop_outside_context(self):
        x = torch.ones((4, 4))
        assert constrain(x, ("batch", "embed")) is x

    def test_constrain_inside_context(self):
        """A plain tensor is one global view: unchanged.  A DTensor is
        laid out by the spec (batch over data: ``Shard(0)``)."""
        from torch.distributed.tensor import Replicate, Shard, \
            distribute_tensor
        with fake_world(1):
            mesh = make_cpu_mesh(1, 1)
            with axis_rules(trules.activation_rules(mesh), mesh):
                x = torch.ones((4, 4))
                assert constrain(x, ("batch", None)) is x
                d = distribute_tensor(x, mesh, (Replicate(), Replicate()))
                y = constrain(d, ("batch", None))
                assert tuple(y.placements) == (Shard(0), Replicate())
                np.testing.assert_array_equal(y.full_tensor().numpy(),
                                              x.numpy())


@pytest.mark.parametrize("names,shape,rules", [
    (("batch", "heads", "seq", None), (256, 32, 4096, 128), None),
    (("batch", "kv_heads", "qgroups", "seq", None), (8, 8, 2, 64, 128),
     None),
    (("vocab", "fsdp"), (50280, 1024), {"fsdp": "data"}),
    (("kv_heads", "heads"), (16, 32), None),
    (("batch",), (7,), None),
])
@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_logical_to_mesh_equals_reference(mesh_id, names, shape, rules):
    """Divisibility guard, tuple axes, first-binding dedupe: the
    reference's spec, and placements that cut each dim by its axes."""
    multi_pod, mshape, axes = MESHES[mesh_id]
    stand_in = mesh_stand_in(mshape, axes)
    want_rules = dict(jrules.activation_rules(stand_in), **(rules or {}))
    want = jl2m(names, shape, want_rules, stand_in)
    with fake_world(math.prod(mshape)):
        m = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        got_rules = dict(trules.activation_rules(m), **(rules or {}))
        got = logical_to_mesh(names, shape, got_rules, m)
        assert _norm(got) == _norm(want)
        assert _local_shape(shape, NamedSharding(m, got)) == \
            _spec_local_shape(shape, got, mesh_axis_sizes(m))
        with axis_rules(got_rules, m):
            assert _norm(logical_to_mesh(names, shape)) == _norm(want)


# ---------------------------------------------------------------------------
# parameters, optimizer state, caches, batches and inputs at full width
# ---------------------------------------------------------------------------

_REF_PARAMS = {}


def _ref_abstract_params(arch_id):
    if arch_id not in _REF_PARAMS:
        from repro.models.model import abstract_params as jab
        _REF_PARAMS[arch_id] = jab(jreg.get_config(arch_id))
    return _REF_PARAMS[arch_id]


def _decode_cases():
    """The decode shapes of ``LM_SHAPES`` and batches below (and not
    dividing) the data axes: the sequence spill."""
    out = [(s.global_batch, s.seq_len) for s in jbase.LM_SHAPES
           if s.kind == "decode"]
    return out + [(8, 4096), (7, 4096), (512, 1024)]


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch_id", jreg.ARCH_IDS)
def test_specs_equal_reference(reference, arch_id, mesh_id):
    """Every parameter leaf's spec (and so AdamW's moments'), every
    decode-cache leaf's spec at the decode shapes, ``batch_sharding`` for a
    divisible and a prime batch, and ``input_specs`` of every
    ``LM_SHAPES`` cell (shapes, dtypes and specs of every entry)."""
    multi_pod, mshape, axes = MESHES[mesh_id]
    stand_in = mesh_stand_in(mshape, axes)
    jcfg, tcfg = jreg.get_config(arch_id), treg.get_config(arch_id)
    ref_ab = _ref_abstract_params(arch_id)
    want_params = {k: _norm(v.spec) for k, v in _flat_ref(
        jrules.param_sharding(jcfg, stand_in, ref_ab),
        is_leaf=lambda x: isinstance(x, _Spec)).items()}
    with fake_world(math.prod(mshape)):
        m = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        sizes = mesh_axis_sizes(m)
        ab = abstract_params(tcfg)
        shd = trules.param_sharding(tcfg, m, ab)
        got = _flat(shd)
        assert {k: _norm(v.spec) for k, v in got.items()} == want_params
        for k, leaf in _flat(ab).items():
            assert _local_shape(leaf.shape, got[k]) == _spec_local_shape(
                leaf.shape, got[k].spec, sizes), k
        opt = trules.opt_state_sharding(shd, None)
        assert isinstance(opt, OptState)
        assert tuple(opt.count.spec) == () and opt.mu is shd \
            and opt.nu is shd

        for batch, max_len in _decode_cases():
            jc = jax.eval_shape(lambda: __import__(
                "repro.models", fromlist=["init_cache"]).init_cache(
                    jcfg, batch, max_len))
            want = {k: _norm(v.spec) for k, v in _flat_ref(
                jrules.cache_sharding(jcfg, stand_in, jc, batch, max_len),
                is_leaf=lambda x: isinstance(x, _Spec)).items()}
            from repro_torch.models import abstract_cache
            tc = abstract_cache(tcfg, batch, max_len)
            got_c = _flat(trules.cache_sharding(tcfg, m, tc, batch,
                                                max_len))
            assert {k: _norm(v.spec) for k, v in got_c.items()} == want, \
                (batch, max_len)
            for k, leaf in _flat(tc).items():
                assert _local_shape(leaf.shape, got_c[k]) == \
                    _spec_local_shape(leaf.shape, got_c[k].spec, sizes)

        for b in (256 * (2 if multi_pod else 1), 251):
            assert _norm(trules.batch_sharding(m, b).spec) == _norm(
                jrules.batch_sharding(stand_in, b).spec)

        for shape in jbase.LM_SHAPES:
            tshape = treg.get_shape(shape.name)
            want = jspecs.input_specs(jcfg, shape, stand_in)
            got = input_specs(tcfg, tshape, m)
            assert got["kind"] == want["kind"]
            for key in want:
                if key in ("kind", "param_sharding", "cache_sharding"):
                    continue
                w = _flat_ref(want[key], is_leaf=lambda x: isinstance(
                    x, tuple) and len(x) == 3 and isinstance(x[1], str))
                g = {k: (tuple(v.tensor.shape),
                         str(v.tensor.dtype).split(".")[-1],
                         _norm(v.sharding.spec))
                     for k, v in _flat(got[key]).items()}
                assert g == w, (shape.name, key)
                assert all(isinstance(v, ShardedMeta) and
                           v.tensor.device.type == "meta"
                           for v in _flat(got[key]).values())
    assert not dist.is_initialized()
