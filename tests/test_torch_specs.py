"""The port's sharding specs and their resolution against the JAX
reference's, on the CPU, with no process group.

* For every ``(arch, shape)`` of ``repro.configs.cells(include_skipped=True)``
  at full size, ``repro_torch.launch.specs.input_specs`` gives the
  parameters', batch's and cache's shapes, dtypes and specs of the
  reference's ``jax.eval_shape`` path, leaf for leaf: a parameter under
  each of the port's per-layer names (``convert``'s unstacking), its
  stacked layer axes dropped, and those axes unsharded.
* ``trainer.resolve_spec`` equals the reference's on a table of specs x
  meshes x ``seq_shard`` x ``extra`` (the reference reads only
  ``mesh.axis_names``, so a stand-in with the names serves both).
* ``resolve_tree``'s placements: an axis listed out of mesh order (the
  FSDP entry ``("data", "pod")``) split in mesh order, each rank's shard
  the size of the reference order's, and the raise on an axis named
  twice.
"""
import itertools
from types import SimpleNamespace

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.train import trainer as jtrainer

from repro_torch import configs, convert
from repro_torch.launch import specs
from repro_torch.nn import decode, transformer
from repro_torch.nn.param import P
from repro_torch.train import trainer

CELLS = jconfigs.cells(include_skipped=True)
MESHES = (("data", "model"), ("pod", "data", "model"), ("data",),
          ("model",), ("pod", "model"))
EXTRAS = (None, {"batch": ("data",)},
          {"batch": (), "kvseq": ("data", "model")},
          {"batch": (), "kvseq": ("pod", "data", "model")})


def _mesh(names):
    return SimpleNamespace(axis_names=names, mesh_dim_names=names)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


@pytest.fixture(scope="module")
def reference_params():
    """The reference's (shapes, specs) a architecture, made once."""
    return {a: jspecs.param_shapes_and_specs(jconfigs.get(a))
            for a in jconfigs.ARCH_NAMES}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference_leaf_for_leaf(arch, shape,
                                                       reference_params):
    mine = specs.input_specs(arch, shape)
    cfg, kind, seq, gb = (mine["cfg"], mine["kind"], mine["seq"], mine["gb"])
    assert (kind, seq, gb) == jconfigs.SHAPES[shape]
    j_shapes, j_specs = (_flat(t) for t in reference_params[arch])
    p_shapes, p_specs = mine["params"]
    assert set(p_shapes) == set(p_specs)
    seen = set()
    for path, want in j_shapes.items():
        spec = tuple(j_specs[path])
        lead, names = convert._port_names(cfg, path)
        assert spec[:len(lead)] == (None,) * len(lead), path
        for name in names:
            assert tuple(p_shapes[name].shape) == want.shape[len(lead):], name
            assert _dtype(p_shapes[name]) == want.dtype.name, name
            assert tuple(p_specs[name]) == spec[len(lead):], name
            assert p_shapes[name].device.type == "meta"
        seen.update(names)
    assert seen == set(p_shapes)

    jcfg = jconfigs.get(arch)
    jb_shapes, jb_specs = jspecs.batch_specs(jcfg, kind, seq, gb)
    b_shapes, b_specs = mine["batch"]
    assert list(b_shapes) == list(jb_shapes)
    for k, want in jb_shapes.items():
        assert tuple(b_shapes[k].shape) == want.shape
        assert _dtype(b_shapes[k]) == want.dtype.name
        assert tuple(b_specs[k]) == tuple(jb_specs[k])
    if kind == "decode":
        jc_shapes, jc_specs = jspecs.cache_shapes_and_specs(jcfg, gb, seq)
        c_shapes, c_specs = mine["cache"]
        assert set(c_shapes) == set(jc_shapes) == set(c_specs)
        for k, want in jc_shapes.items():
            assert tuple(c_shapes[k].shape) == want.shape, k
            assert _dtype(c_shapes[k]) == want.dtype.name, k
            assert tuple(c_specs[k]) == tuple(jc_specs[k]), k
    else:
        assert "cache" not in mine


def _all_specs():
    """Every distinct spec the configs produce, and the reference test's."""
    out = {P("batch", "seq", None), P("pod", "model"),
           P("batch", None, "kvseq", None), P(("batch", "model"), None, None),
           P(("data", "pod"), "model"), P("seq", ("batch", "kvseq"))}
    for a in configs.ARCH_NAMES:
        cfg = configs.get(a)
        out |= set(transformer.param_specs(cfg).values())
        out |= set(decode.cache_specs(cfg).values())
    return sorted(out, key=repr)


SPECS = _all_specs()


@pytest.mark.parametrize("names", MESHES, ids="x".join)
@pytest.mark.parametrize("seq_shard", [False, True])
def test_resolve_spec_matches_the_reference(names, seq_shard):
    cfg = configs.reduced(configs.get("minitron-4b"), seq_shard=seq_shard)
    jcfg = jconfigs.reduced(jconfigs.get("minitron-4b"), seq_shard=seq_shard)
    mesh = _mesh(names)
    for spec, extra in itertools.product(SPECS, EXTRAS):
        want = jtrainer.resolve_spec(JP(*spec), mesh, jcfg, extra=extra)
        got = trainer.resolve_spec(spec, mesh, cfg, extra=extra)
        assert isinstance(got, P)
        assert tuple(got) == tuple(want), (spec, extra)
    # no cfg: "seq" resolves to "model", as the reference's
    assert tuple(trainer.resolve_spec(P("seq"), mesh)) == tuple(
        jtrainer.resolve_spec(JP("seq"), mesh))


def test_resolve_spec_virtual_axes():
    """The reference's ``test_train_infra.py`` cases, on the port."""
    mesh = _mesh(("data", "model"))
    cfg = configs.reduced(configs.get("minitron-4b"), seq_shard=True)
    assert trainer.resolve_spec(P("batch", "seq", None), mesh, cfg) == P(
        ("data",), "model", None)
    cfg2 = configs.reduced(configs.get("minitron-4b"), seq_shard=False)
    assert trainer.resolve_spec(P("batch", "seq", None), mesh, cfg2) == P(
        ("data",), None, None)
    assert trainer.resolve_spec(P("pod", "model"), mesh, cfg) == P(
        None, "model")
    assert trainer.resolve_spec(
        P("batch", None, "kvseq", None), mesh, cfg,
        extra={"batch": (), "kvseq": ("data", "model")}) == P(
        None, None, ("data", "model"), None)


@pytest.mark.parametrize("spec,names,want", [
    (P(("data", "model"), None), ("data", "model"),
     [Shard(0), Shard(0)]),
    (P(None, "model"), ("data", "model"), [Replicate(), Shard(1)]),
    (P(("pod", "data"), None, "model", None), ("pod", "data", "model"),
     [Shard(0), Shard(0), Shard(2)]),
    (P(), ("pod", "data", "model"), [Replicate()] * 3),
    (P("model", None), ("model",), [Shard(0)]),
])
def test_placements_shard_every_named_mesh_dim(spec, names, want):
    assert trainer.placements(spec, _mesh(names)) == want


@pytest.mark.parametrize("spec,names", [
    (P("model", "model"), ("data", "model")),
    (P(("data", "data")), ("data", "model")),
    (P(("pod", "data"), "pod"), ("pod", "data", "model")),
])
def test_placements_refuse_axes_out_of_mesh_order_or_twice(spec, names):
    """An axis named twice raises; axes out of mesh order are placed
    (:func:`test_placements_split_axes_out_of_mesh_order_in_mesh_order`)."""
    with pytest.raises(ValueError, match="twice"):
        trainer.placements(spec, _mesh(names))


def _shard_size(n: int, axes, sizes: dict, coord: dict) -> int:
    """Rank ``coord``'s chunk of a dim of ``n`` split over ``axes`` major
    to minor, each as ``torch.chunk`` deals it."""
    for a in axes:
        chunk = -(-n // sizes[a])
        n = max(0, min(chunk, n - coord[a] * chunk))
    return n


def _every_rank_holds_the_reference_orders_size(spec, placed, shape, sizes):
    """Each rank's shard of every dim (DTensor splits in mesh order) has
    the size the spec's own order gives that rank."""
    names = list(sizes)
    for coord in itertools.product(*(range(sizes[a]) for a in names)):
        at = dict(zip(names, coord))
        for dim, (n, entry) in enumerate(zip(shape, spec)):
            axes = entry if isinstance(entry, tuple) else (
                () if entry is None else (entry,))
            mesh_order = [a for a, p in zip(names, placed)
                          if p == Shard(dim)]
            assert sorted(mesh_order) == sorted(axes)
            assert _shard_size(n, mesh_order, sizes, at) == \
                _shard_size(n, axes, sizes, at), (spec, dim, at)


@pytest.mark.parametrize("spec,names,want", [
    (P(("model", "data")), ("data", "model"), [Shard(0), Shard(0)]),
    (P(("data", "pod"), "model"), ("pod", "data", "model"),
     [Shard(0), Shard(0), Shard(1)]),
])
def test_placements_split_axes_out_of_mesh_order_in_mesh_order(spec, names,
                                                              want):
    """The FSDP entry ``("data", "pod")`` on the multi-pod mesh: DTensor
    splits mesh dims left to right, so the dim is split in mesh order,
    each rank's shard the size of the reference order's."""
    placed = trainer.placements(spec, _mesh(names))
    assert placed == want
    sizes = dict(zip(names, (2, 16, 16)[-len(names):]))
    _every_rank_holds_the_reference_orders_size(spec, placed, (7168, 2048),
                                                sizes)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_every_config_resolves_on_the_production_meshes(arch):
    """Every tree resolves on both meshes; an FSDP config's ``("data",
    "pod")`` entries on the multi-pod mesh split in mesh order, each
    rank's parameter shards the sizes of the reference order's."""
    cfg = configs.get(arch)
    trees = {"params": transformer.param_specs(cfg),
             "cache": decode.cache_specs(cfg)}
    single = trainer.resolve_tree(trees, _mesh(("data", "model")), cfg)
    assert set(single["params"]) == set(trees["params"])
    assert all(len(p) == 2 for p in single["params"].values())
    multi = _mesh(("pod", "data", "model"))
    resolved = trainer.resolve_tree(trees, multi, cfg)
    assert all(len(p) == 3 for p in resolved["cache"].values())
    shapes, _ = specs.param_shapes_and_specs(cfg)
    out_of_order = 0
    for k, spec in trees["params"].items():
        spec = trainer.resolve_spec(spec, multi, cfg)
        out_of_order += ("data", "pod") in tuple(spec)
        if ("data", "pod") in tuple(spec) or k.endswith(("0.attn.wq",
                                                         "embed")):
            _every_rank_holds_the_reference_orders_size(
                spec, resolved["params"][k], shapes[k].shape,
                {"pod": 2, "data": 16, "model": 16})
    assert bool(out_of_order) == cfg.fsdp


def test_specs_allocate_nothing():
    shapes, _ = specs.param_shapes_and_specs(configs.get("kimi-k2-1t-a32b"))
    assert {x.device.type for x in shapes.values()} == {"meta"}
    total = sum(x.numel() for x in shapes.values())
    assert total > 1e12                     # a trillion parameters, on meta


def test_opt_state_specs_mirror_the_params():
    p_specs = {"w": P(None, "model")}
    got = trainer.opt_state_specs({"step": None, "m": None, "v": None},
                                  p_specs)
    assert got == {"step": P(), "m": p_specs, "v": p_specs}
    want = jtrainer.opt_state_specs({"step": None, "m": None, "v": None},
                                    {"w": JP(None, "model")})
    assert tuple(want["step"]) == tuple(got["step"])


def test_make_shard_fn_without_a_mesh_is_noshard():
    cfg = configs.reduced(configs.get("minitron-4b"))
    shard = trainer.make_shard_fn(None, cfg)
    x = torch.ones(2, 3)
    assert shard(x, P("batch", "seq", None)) is x
