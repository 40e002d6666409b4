"""Parity of the port's dataset ingestion (``repro_torch.data.ingest``) with
the JAX reference's (``repro.data.ingest``), on the CPU.

Both packages resolve the bundled fixtures offline; the port ships its own
copy of the five files.  The same fixture and split go through both, and
every array, profile and content hash must be equal (the pipeline is
numpy up to the tensors, so exactly equal).
"""
import dataclasses

import numpy as np
import pytest

from repro.data import ingest as jingest
from repro.data.ingest import cache as jcache
from repro.data.ingest import fixtures as jfixtures
from repro.data.ingest import registry as jregistry

from repro_torch.data import ingest as tingest
from repro_torch.data.ingest import cache as tcache
from repro_torch.data.ingest import fixtures as tfixtures
from repro_torch.data.ingest import registry as tregistry

NAMES = tuple(jregistry.REAL_DATASETS)
SPLITS = ("train", "test", "all")
CPU = "cpu"


@pytest.fixture
def isolated_env(tmp_path, monkeypatch):
    """Point both blob caches at a tmp dir and clear in-process memos."""
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.delenv("REPRO_ALLOW_DOWNLOAD", raising=False)
    monkeypatch.delenv("REPRO_FIXTURE_DIR", raising=False)
    jingest.clear_cache()
    tingest.clear_cache()
    yield tmp_path
    jingest.clear_cache()
    tingest.clear_cache()


def test_registry_metadata_is_the_references():
    assert tuple(tregistry.REAL_DATASETS) == NAMES
    for name in NAMES:
        assert (dataclasses.asdict(tregistry.get(name))
                == dataclasses.asdict(jregistry.get(name)))
        assert tregistry.get(name).density == jregistry.get(name).density
    with pytest.raises(KeyError, match="unknown real dataset"):
        tregistry.get("mnist")


@pytest.mark.parametrize("name", NAMES)
def test_bundled_fixture_is_the_references_byte_for_byte(name, isolated_env):
    port, ref = tingest.fixture_path(name), jingest.fixture_path(name)
    assert port != ref and port.parent.parent.name == "ingest"
    assert tcache.sha256_file(port) == jcache.sha256_file(ref)
    assert tingest.raw_digest(name) == jingest.raw_digest(name)
    assert tingest.source_path(name) == (port, "fixture")


@pytest.mark.parametrize("name", NAMES)
def test_make_fixture_matches_reference(name):
    tcsr, traw = tfixtures.make_fixture(name)
    jcsr, jraw = jfixtures.make_fixture(name)
    for field in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(tcsr, field),
                                      getattr(jcsr, field))
    assert tcsr.d == jcsr.d
    np.testing.assert_array_equal(traw, jraw)


def test_write_all_regenerates_the_bundled_fixtures(tmp_path):
    written = tfixtures.write_all(tmp_path)
    assert sorted(p.name for p in written) == sorted(f"{n}.libsvm"
                                                     for n in NAMES)
    for path in written:
        assert path.read_bytes() == (tfixtures.FIXTURE_DIR
                                     / path.name).read_bytes()


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("name", NAMES)
def test_load_profile_and_content_hash_match(name, split, isolated_env):
    t = tingest.load(name, split=split, device=CPU)
    j = jingest.load(name, split=split)
    assert (t.name, t.n, t.d, t.dense) == (j.name, j.n, j.d, j.dense)
    assert t.content_hash == j.content_hash == jingest.content_hash(
        name, split=split) == tingest.content_hash(name, split=split)
    np.testing.assert_array_equal(t.y.numpy(), np.asarray(j.y))
    if t.dense:
        assert t.ell is None and t.X.device.type == CPU
        np.testing.assert_array_equal(t.X.numpy(), np.asarray(j.X))
    else:
        assert t.X is None and t.ell.values.device.type == CPU
        np.testing.assert_array_equal(t.ell.values.numpy(),
                                      np.asarray(j.ell.values))
        np.testing.assert_array_equal(t.ell.indices.numpy(),
                                      np.asarray(j.ell.indices))
    assert tingest.profile(name, split=split) == jingest.profile(name,
                                                                 split=split)


@pytest.mark.parametrize("name", ("covtype", "w8a"))
def test_capped_and_reseeded_loads_match(name, isolated_env):
    for kw in (dict(max_n=17), dict(seed=3), dict(split="test", max_n=5)):
        t, j = tingest.load(name, device=CPU, **kw), jingest.load(name, **kw)
        assert t.content_hash == j.content_hash
        np.testing.assert_array_equal(t.y.numpy(), np.asarray(j.y))
        assert tingest.profile(name, **kw) == jingest.profile(name, **kw)


@pytest.mark.parametrize("seed", (0, 5))
@pytest.mark.parametrize("split", SPLITS)
def test_split_rows_match(split, seed):
    for n in (1, 10, 160, 321):
        np.testing.assert_array_equal(tingest.split_rows(n, split, seed),
                                      jingest.split_rows(n, split, seed))
    with pytest.raises(ValueError, match="split must be one of"):
        tingest.split_rows(10, "dev", 0)


@pytest.mark.parametrize("name", NAMES)
def test_feature_scales_match(name, isolated_env):
    tcsr, _ = tingest._parsed(name)
    jcsr, _ = jingest._parsed(name)
    rows = tingest.split_rows(tcsr.n, "train", 0)
    np.testing.assert_array_equal(tingest.feature_scales(tcsr, rows),
                                  jingest.feature_scales(jcsr, rows))


@pytest.mark.parametrize("name", NAMES)
def test_fetch_full_refuses_offline(name, isolated_env):
    with pytest.raises(tingest.DownloadDisabledError,
                       match="downloads are disabled"):
        tingest.fetch_full(name)
    assert not (isolated_env / "data").exists()


def test_cache_verify_records_then_enforces(isolated_env):
    blob = isolated_env / "blob.bin"
    blob.write_bytes(b"abc")
    assert tcache.verify(blob) == blob          # trust on first use
    assert (blob.with_name("blob.bin.sha256").read_text().strip()
            == jcache.sha256_file(blob))
    blob.write_bytes(b"abd")
    with pytest.raises(tcache.IntegrityError, match="does not match"):
        tcache.verify(blob)
    assert tcache.data_dir() == jcache.data_dir()
    assert tcache.downloads_allowed() is jcache.downloads_allowed() is False


def test_fixture_dir_override_changes_the_hash(isolated_env, monkeypatch):
    before = tingest.content_hash("w8a")
    alt = isolated_env / "fixtures"
    alt.mkdir()
    text = tingest.fixture_path("w8a").read_text()
    (alt / "w8a.libsvm").write_text(text + "-1 1:1\n")
    monkeypatch.setenv("REPRO_FIXTURE_DIR", str(alt))
    tingest.clear_cache()
    jingest.clear_cache()
    assert tingest.fixture_dir() == alt
    assert tingest.content_hash("w8a") == jingest.content_hash("w8a") != before
    assert tingest.profile("w8a", split="all")[0] == 161
