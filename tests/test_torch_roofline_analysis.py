"""The port's roofline analysis (``repro_torch.roofline.analysis``) and the
dry run's op counts (``repro_torch.roofline.counts``) against the
reference's ``repro.roofline.analysis`` and ``hlo`` on the CPU.

* ``param_counts`` / ``model_flops`` equal the reference's for every arch;
* the ring formulas equal ``hlo.collective_bytes`` on
  ``test_roofline.MINI_HLO``'s all-reduce, and DTensor's collectives in a
  fake world of 16 give the expected wire bytes and link class;
* the dot flops of a 10-step loop equal ``hlo.analyze`` of the compiled
  ``lax.scan`` (``test_roofline.py``'s case), and the traffic proxy counts
  an in-place slice write as twice its update (its dynamic-update-slice
  case);
* on ``tests/test_torch_dryrun.py``'s two mini cells the new keys are
  present and positive, every other key keeps the value it had before the
  counters, and the sync cell's dot flops a rank stand within a stated
  tolerance of the reference's ``hlo.analyze`` of the same cell;
* ``analyze_cell`` / ``to_markdown`` give the reference's keys, and the
  terms use the H100's peaks and links.
"""
import gzip
import json
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.roofline import analysis as janalysis
from repro.roofline import hlo
from repro_torch import configs
from repro_torch.roofline import analysis, counts, kernels

from test_roofline import MINI_HLO
from test_torch_dryrun import MINI, run_py

ROOT = Path(__file__).resolve().parents[1]

#: the mini cells' keys as the dry run gave them before the op counts
#: (the parent tree's run_step, torch 2.13 on the CPU)
BEFORE = {
    "sync": {"peak_bytes": 660_748, "flops": 10_326_016,
             "matmul_flops": 9_699_328, "collective_bytes": {}},
    "decode": {"peak_bytes": 879_088, "flops": 624_640,
               "matmul_flops": 608_256,
               "collective_bytes": {"all_reduce": 5_632,
                                    "all_gather_into_tensor": 718_336}},
}

#: ``hlo.analyze`` of the reference's compiled mini sync cell (reduced
#: minitron-4b, ``seq_shard``, (data=4, model=2) of Auto axes, 8 forced
#: host devices, jax 0.9.0): dot flops a device
REF_SYNC_DOT_FLOPS = 8_978_432

#: the port's dot flops a rank over the reference's, on the mini sync
#: cell.  Measured 1.150.  The port's own mesh-less step, split evenly
#: over 8 ranks, has 8,912,896 matmul flops a rank: the reference's dots
#: less its 65,536 of attention.  Above that the port's rank counts
#: 786,432 products its placement repeats on both "model" ranks (8.8%) and
#: 626,688 of attention by its operators' formulas (the forward, its
#: recompute and the 5-product backward on visible pairs, heads whole on
#: both "model" ranks: 2 kv heads do not split over 8).  The port never
#: counts less than the reference, and a repeated product more, or a
#: kernel counted twice, would pass 1.2.
SYNC_DOT_RATIO = (1.0, 1.2)


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_param_counts_and_model_flops_equal_the_references(arch):
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert analysis.param_counts(arch) == janalysis.param_counts(arch)
    for kind, seq, gb in configs.SHAPES.values():
        assert analysis.model_flops(arch, kind, seq, gb) == \
            janalysis.model_flops(arch, kind, seq, gb)


def test_ring_formulas_equal_hlo_on_the_mini_all_reduce():
    comps = hlo.parse_computations(MINI_HLO)
    total, by_kind = hlo.collective_bytes(
        comps, hlo.compute_multipliers(comps, "main"))
    # one all-reduce of f32[8,16] in groups of 16, 10 trips
    assert 10 * counts.wire_bytes("all-reduce", 512, 16) == total
    assert by_kind == {"all-reduce": total}
    assert counts.wire_bytes("all-gather", 512, 16) == 15 / 16 * 512
    assert counts.wire_bytes("reduce-scatter", 512, 16) == 15 / 16 * 512
    assert counts.wire_bytes("all-to-all", 512, 16) == 15 / 16 * 512
    assert counts.wire_bytes("collective-permute", 512, 16) == 512
    assert counts.wire_bytes("all-reduce", 512, 1) == 0


@pytest.mark.parametrize("shape", [(2, 8), (8, 2)])
def test_dtensor_collectives_give_ring_bytes_and_link_class(shape):
    """A [16, 4] fp32 tensor (256 bytes) in a fake world of 16 ranks on a
    ``(data, model)`` mesh: an all-reduce over "model" (Partial to
    Replicate), an all-gather over "data" (Shard(0) to Replicate), a
    reduce-scatter over "model" (Partial to Shard(0))."""
    res = run_py(f"""
        import json
        import torch
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        from repro_torch.launch import dryrun
        from repro_torch.roofline.counts import OpCounts
        shape = {shape!r}
        with dryrun.fake_world(16):
            m = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            full = torch.ones(16, 4)
            out = {{}}
            for name, local, src, dst in (
                    ("all-reduce", full, [Replicate(), Partial()],
                     [Replicate(), Replicate()]),
                    ("all-gather", full[:16 // shape[0]], [Shard(0), Replicate()],
                     [Replicate(), Replicate()]),
                    ("reduce-scatter", full, [Replicate(), Partial()],
                     [Replicate(), Shard(0)])):
                t = DTensor.from_local(local, m, src, run_check=False,
                                       shape=(16, 4), stride=(4, 1))
                counts = OpCounts()
                with counts:
                    t.redistribute(m, dst).to_local()
                out[name] = {{"/".join(k): v for k, v in counts.wire.items()}}
        print(json.dumps(out))
    """, timeout=120)
    data, model = shape
    link = {(2, 8): ("nvlink", "net x1"), (8, 2): ("nvlink", "net x4")}
    model_link, data_link = link[shape]
    assert res["all-reduce"] == {
        f"all-reduce/{model_link}": 2 * (model - 1) / model * 256}
    assert res["all-gather"] == {
        f"all-gather/{data_link}": (data - 1) / data * 256}
    assert res["reduce-scatter"] == {
        f"reduce-scatter/{model_link}": (model - 1) / model * 256}


def test_link_model_on_the_production_meshes():
    # (data=16, model=16): "model" is 16 consecutive ranks, two nodes of 8
    assert analysis.link_class(range(16)) == "net x8"
    assert analysis.link_bytes_per_s("net x8") == 400e9
    # "data" strides 16: one rank a node
    assert analysis.link_class(range(0, 256, 16)) == "net x1"
    assert analysis.link_bytes_per_s("net x1") == 50e9
    # (pod=2, data=16, model=16): "pod" pairs rank r with r + 256
    assert analysis.link_class([0, 256]) == "net x1"
    # a group inside one node, and the NVLink cap on many rails
    assert analysis.link_class(range(8)) == "nvlink"
    assert analysis.link_bytes_per_s("nvlink") == 450e9
    assert analysis.link_bytes_per_s("net x16") == 450e9


def test_loop_dot_flops_equal_the_references_hlo_parse():
    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, None, length=10)
        return y

    spec = jax.ShapeDtypeStruct((64, 64), jnp.float32)
    a = hlo.analyze(jax.jit(f).lower(spec, spec).compile().as_text())

    c, w = torch.randn(64, 64), torch.randn(64, 64)
    with counts.LocalFlopCounter(display=False) as counter:
        for _ in range(10):
            c = torch.tanh(c @ w)
    assert set(counter.by_dtype) == {"float32"}
    assert counter.by_dtype["float32"] == counter.get_total_flops()
    assert counter.by_dtype["float32"] == pytest.approx(a.dot_flops,
                                                       rel=1e-2)


def test_traffic_counts_a_slice_write_as_twice_its_update():
    text = """
ENTRY %m (b: f32[1000,64], u: f32[1,64]) -> f32[1000,64] {
  %b = f32[1000,64]{1,0} parameter(0)
  %u = f32[1,64]{1,0} parameter(1)
  %z = s32[] constant(0)
  ROOT %d = f32[1000,64]{1,0} dynamic-update-slice(%b, %u, %z, %z)
}
"""
    comps = hlo.parse_computations(text)
    ref = hlo.memory_bytes(comps, hlo.compute_multipliers(comps, "m"), set())
    buf, upd = torch.zeros(1000, 64), torch.ones(1, 64)
    slice_write, put = counts.OpCounts(), counts.OpCounts()
    with slice_write:
        buf[3:4] = upd                       # copy_ into a view
    with put:                                # the update and an 8-byte index
        buf.index_put_((torch.tensor([3]),), upd)
    # the reference counts the update and its two s32 indices, each read
    # and written: 2 x (256 + 8), the 256 KB buffer not at all
    assert put.hbm_bytes == ref == 2 * (64 * 4 + 8)
    assert slice_write.hbm_bytes == 2 * 64 * 4
    # views, allocation and metadata move nothing; an op its operands
    views = counts.OpCounts()
    with views:
        buf.view(64000).t().expand(2, 64000)
        torch.empty(10)
    assert views.hbm_bytes == 0
    add = counts.OpCounts()
    with add:
        upd + upd
    assert add.hbm_bytes == 3 * 256


def test_attention_traffic_is_the_kernels_bytes():
    import repro_torch.kernels.flash_attn.ops  # noqa: F401 (the operator)
    q = torch.randn(1, 4, 32, 16)
    k = torch.randn(1, 2, 32, 16)
    c = counts.OpCounts()
    with c:
        torch.ops.repro_torch.flash_attn(q, k, k, True, None, None, None,
                                         True)
    want = kernels.kernel_cost("flash_attn", {
        "batch": 1, "heads_q": 4, "heads_kv": 2, "seq_q": 32, "seq_k": 32,
        "head_dim": 16, "dtype": "float32"})["hbm_bytes"]
    assert c.hbm_bytes == want


@pytest.fixture(scope="module")
def mini_cells():
    """Both mini cells of ``tests/test_torch_dryrun.py`` in one fake-world
    subprocess."""
    return run_py(f"""
        import json
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch import configs
        from repro_torch.launch import dryrun
        out = {{}}
        for cell, setup in {({k: v[:-2] for k, v in MINI.items()})!r}.items():
            arch, seq_shard, shape, names, kind, seq, gb = setup
            cfg = configs.reduced(configs.get(arch), seq_shard=seq_shard)
            with dryrun.fake_world(8):
                m = init_device_mesh("cpu", shape, mesh_dim_names=names)
                out[cell] = dryrun.run_step(dryrun.group_rule(cfg, m, gb),
                                            kind, seq, gb, m, device="cpu")
        print(json.dumps(out))
    """, timeout=180)


@pytest.mark.parametrize("cell", sorted(MINI))
def test_mini_cells_gain_the_counts_and_keep_every_other_key(cell,
                                                             mini_cells):
    r, before = mini_cells[cell], BEFORE[cell]
    *_, arg_bytes, out_bytes = MINI[cell]
    assert r["memory"]["argument_bytes"] == arg_bytes
    assert r["memory"]["output_bytes"] == out_bytes
    assert r["memory"]["peak_bytes"] == before["peak_bytes"]
    assert r["cost_analysis"]["flops"] == before["flops"]
    assert r["matmul_flops"] == before["matmul_flops"]
    assert r["collective_bytes"] == before["collective_bytes"]
    # the new keys: the flops split by dtype, the traffic, the wire bytes
    assert sum(r["dot_flops_by_dtype"].values()) == before["flops"]
    assert all(v > 0 for v in r["dot_flops_by_dtype"].values())
    assert r["hbm_bytes"] > 0 and len(r["hbm_top"]) == counts.TOP
    assert r["wire_bytes"] > 0
    assert sum(r["wire_bytes_by_kind"].values()) == pytest.approx(
        r["wire_bytes"])
    assert sum(r["wire_bytes_by_link"].values()) == pytest.approx(
        r["wire_bytes"])
    # 8 ranks: every group in one node
    assert set(r["wire_bytes_by_link"]) == {"nvlink"}


def test_mini_sync_cell_dot_flops_against_the_references_hlo(mini_cells):
    ratio = (sum(mini_cells["sync"]["dot_flops_by_dtype"].values())
             / REF_SYNC_DOT_FLOPS)
    lo, hi = SYNC_DOT_RATIO
    assert lo <= ratio <= hi, ratio


def _recorded_cell(tmp_path: Path) -> Path:
    cell = {"arch": "h2o-danube-1.8b", "shape": "train_4k", "mesh": "16x16",
            "update": "sync", "kind": "train", "seq": 4096,
            "global_batch": 256, "status": "ok",
            "memory": {"argument_bytes": 1, "peak_bytes": 2},
            "dot_flops_by_dtype": {"bfloat16": 989e12, "float32": 67e12},
            "hbm_bytes": 3.35e12, "hbm_top": {"aten.mm": 1.0},
            "wire_bytes": 850e9,
            "wire_bytes_by_kind": {"all-gather": 850e9},
            "wire_bytes_by_link": {"net x8": 400e9, "nvlink": 450e9}}
    path = tmp_path / "h2o-danube-1.8b__train_4k__16x16.json"
    path.write_text(json.dumps(cell))
    return path


def test_analyze_cell_terms_on_the_h100(tmp_path):
    row = analysis.analyze_cell(_recorded_cell(tmp_path))
    assert row["compute_s"] == pytest.approx(2.0)      # 1 s each dtype
    assert row["memory_s"] == pytest.approx(1.0)
    assert row["collective_s"] == pytest.approx(2.0)   # 1 s each link
    assert row["dominant"] in ("compute_s", "collective_s")
    assert row["step_time_bound_s"] == pytest.approx(2.0)
    assert row["devices"] == 256
    mf = janalysis.model_flops("h2o-danube-1.8b", "train", 4096, 256)
    assert row["model_flops_global"] == mf
    assert row["useful_compute_ratio"] == pytest.approx(
        mf / 256 / (989e12 + 67e12))
    assert all(math.isfinite(row[k]) for k in ("compute_s", "memory_s",
                                               "collective_s"))


def test_analyze_cell_and_markdown_give_the_references_keys(tmp_path):
    # the reference's row for a cell whose HLO is MINI_HLO
    hlo_file = tmp_path / "mini.hlo.gz"
    with gzip.open(hlo_file, "wt") as f:
        f.write(MINI_HLO)
    meta = tmp_path / "ref.json"
    meta.write_text(json.dumps({
        "arch": "h2o-danube-1.8b", "shape": "train_4k", "mesh": "16x16",
        "kind": "train", "seq": 4096, "global_batch": 256, "status": "ok",
        "hlo_file": str(hlo_file), "memory": {}}))
    want = janalysis.analyze_cell(meta)
    got = analysis.analyze_cell(_recorded_cell(tmp_path))
    # the port parses no HLO: its dot flops drop the prefix, and loops
    # are Python, so n_while has no counterpart
    renamed = {"hlo_dot_flops_per_dev": "dot_flops_per_dev"}
    assert {renamed.get(k, k) for k in want} - {"n_while"} <= set(got)
    ref_cols = janalysis.to_markdown([want]).splitlines()[0].split("|")
    cols = analysis.to_markdown([got]).splitlines()
    assert set(ref_cols) <= set(cols[0].split("|"))
    assert len(cols) == 3 and "danube" in cols[2]
    assert analysis.analyze_cell(meta) is None     # no counts: skipped


def test_run_writes_the_mesh_table(tmp_path, capsys):
    _recorded_cell(tmp_path)
    rows = analysis.run("16x16", results=tmp_path)
    assert [r["arch"] for r in rows] == ["h2o-danube-1.8b"]
    saved = json.loads((tmp_path / "roofline_16x16.json").read_text())
    assert saved[0]["dominant"] == rows[0]["dominant"]
    assert "wrote" in capsys.readouterr().out


def test_peaks_are_the_h100s():
    assert analysis.PEAK_FLOPS == {"bfloat16": 989e12, "float16": 989e12,
                                   "float32": 67e12}
    assert analysis.HBM_BYTES_PER_S == 3.35e12
    # the reference's TPU figures appear nowhere in the port's roofline
    assert (janalysis.PEAK_FLOPS, janalysis.HBM_BW, janalysis.ICI_BW) == (
        197e12, 819e9, 45e9)
    tpu = re.compile(r"\b(197e12|819e9|45e9|197 TFLOP|819 GB|45 GB)\b")
    for path in (ROOT / "src" / "repro_torch" / "roofline").glob("*.py"):
        assert not tpu.search(path.read_text()), path
