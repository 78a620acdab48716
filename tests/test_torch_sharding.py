"""The port's sharding rules (``repro_torch.sharding``, plain Python)
against the JAX package's ``repro.sharding``, on the CPU.

* Every named policy: the same fields and rules, and, for every logical
  axis its rules name, the same partition-spec entry on the one-pod
  (data, model) and the multi-pod (pod, data, model) production meshes.
* The production mesh shapes and the host mesh of one process.
* ``fit_sharding``: an axis that does not divide a dimension leaves it
  replicated (trailing axes of a tuple entry dropped first), the same
  specs as the reference's on the same shapes.

The reference reads only a mesh's axis names and sizes here, so its meshes
are ``jax.sharding.AbstractMesh``es of the production shapes; the port's
are plain objects with ``axis_names`` and ``shape``, as its docstring
allows.
"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

from repro.sharding import axes as jaxes
from repro.sharding import policy as jpolicy
from repro_torch.launch.mesh import make_host_mesh, production_mesh_shape
from repro_torch.sharding import fit_sharding, get_policy, logical_spec
from repro_torch.sharding.policy import POLICIES

MESHES = [production_mesh_shape(multi_pod=False),
          production_mesh_shape(multi_pod=True)]


def _meshes(shape, names):
    return (AbstractMesh(shape, names),
            SimpleNamespace(axis_names=names, shape=dict(zip(names, shape))))


def test_the_port_has_the_references_policies():
    assert sorted(POLICIES) == sorted(jpolicy.POLICIES)


@pytest.mark.parametrize("name", sorted(jpolicy.POLICIES))
def test_policy_and_its_specs_equal_the_references(name):
    want, got = jpolicy.get_policy(name), get_policy(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    logical = tuple(want.rules)
    for shape, names in MESHES:
        jmesh, tmesh = _meshes(shape, names)
        assert logical_spec(logical, got.rules, tmesh) == tuple(
            jaxes.logical_spec(logical, want.rules, jmesh)), (shape, name)


FIT_CASES = [
    ((8, 512), ("model", None)),  # 8 GQA kv heads on a 16-way axis
    ((504, 64), ("model", None)),  # a codebook's vocab
    ((40, 64, 64), ("model", None, None)),  # 40 RWKV heads
    ((48, 1024), (("pod", "data"), "model")),  # 48 rows over 2 x 16
    ((64, 40), (("data", "model"), None)),  # divides data, not data x model
    ((512, 4096), (("pod", "data"), "model")),
    ((7,), (None,)),
    ((32,), ("data", "model")),  # an entry past the tensor's rank stays
]


@pytest.mark.parametrize("shape,spec", FIT_CASES,
                         ids=[f"{s}-{p}" for s, p in FIT_CASES])
def test_fit_sharding_equals_the_references(shape, spec):
    for mshape, names in MESHES:
        if any(a not in names for e in spec if e is not None
               for a in ((e,) if isinstance(e, str) else e)):
            continue
        jmesh, tmesh = _meshes(mshape, names)
        want = jaxes.fit_sharding(
            shape, NamedSharding(jmesh, PartitionSpec(*spec))).spec
        assert fit_sharding(shape, spec, tmesh) == tuple(want), mshape


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "two_pods"])
def test_production_mesh_shape_is_the_references(multi_pod, monkeypatch):
    """The reference's ``make_production_mesh`` needs 256 or 512 devices:
    its ``make_mesh`` is replaced by one that returns what it is given."""
    import repro.launch.mesh as jmesh
    monkeypatch.setattr(jmesh, "_compat_make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    assert production_mesh_shape(multi_pod=multi_pod) == \
        jmesh.make_production_mesh(multi_pod=multi_pod)


def test_host_mesh_without_a_process_group_is_one_rank():
    """Over one CPU process the host mesh is (data 1, model 1), as the
    reference's is over its one CPU device, and runs no collective."""
    import repro.launch.mesh as jmesh
    want = jmesh.make_host_mesh()
    mesh = make_host_mesh(device="cpu")
    assert mesh.shape == dict(want.shape)
    x = torch.ones(3)
    assert mesh.all_reduce(x, ("data", "model")) is x
