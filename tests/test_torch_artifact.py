"""repro_torch plan-cache artifacts: twins of tests/test_artifact.py's
round-trip, no-fit, fault-injection, fingerprint and activation cases,
a fresh subprocess warm-starting from a populated directory, and the
cache shared with the JAX package: a geometry the reference published
is served to the port unchanged (and back)."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch.kernels  # noqa: F401 — registers the c0 ISA
from repro_torch.core import artifact, isa
from repro_torch.core import program as prog_mod
from repro_torch.core.burst_model import H100_HBM, BurstModel
from repro_torch.core.program import Program

F32 = torch.float32


@pytest.fixture
def cache_dir(tmp_path):
    """A fresh artifact dir active for the test, cold dispatch state."""
    prog_mod.clear_dispatch_caches()
    prog_mod.reset_dispatch_stats()
    with artifact.using_plan_cache(tmp_path):
        yield tmp_path
    prog_mod.clear_dispatch_caches()


def snap():
    return prog_mod.DISPATCH_STATS.snapshot()


def delta(s0, *names):
    s1 = prog_mod.DISPATCH_STATS
    return tuple(getattr(s1, n) - getattr(s0, n) for n in names)


def two_stage_program(**kw):
    stages = tuple(isa.get(n).template.stage()
                   for n in ("c0_scale", "c0_add"))
    return Program(stages, **kw)


def entries(tmp_path, kind):
    return sorted(p for p in tmp_path.iterdir()
                  if p.name.startswith(f"{kind}-"))


class TestPlanCacheUnit:
    def test_roundtrip_and_entry_naming(self, cache_dir):
        cache = artifact.plan_cache()
        key = ("geom", ("id",), 4096, "float32", ("hbm", 1.0), 1 << 20, 2)
        assert cache.store("geom", key, {"block_cols": 256})
        path = cache.entry_path("geom", key)
        assert os.path.basename(path) == (
            f"geom-{artifact.key_hash(key)}.json")
        s0 = snap()
        assert cache.load("geom", key) == {"block_cols": 256}
        assert delta(s0, "disk_hit", "disk_miss") == (1, 0)

    def test_tuples_and_lists_share_identity(self):
        key_t = ("k", (1, 2), {"a": (3,)})
        key_l = ["k", [1, 2], {"a": [3]}]
        assert artifact.key_hash(key_t) == artifact.key_hash(key_l)

    @pytest.mark.parametrize("key", [
        ("k", (1, 2), {"a": (3,)}), ("geom", 2, 2.0, None, True, "x"),
        (("c0_scale", 1, 1, 1, 8, 1024, 0, "float32", 0.0, True),
         1 << 26, "float32", ("burst", 3.35e12, 1e-06), 232448, 2)])
    def test_key_hash_equals_reference(self, key):
        from repro.core import artifact as jart
        assert artifact.canonical_key(key) == jart.canonical_key(key)
        assert artifact.key_hash(key) == jart.key_hash(key)

    def test_missing_entry_is_miss(self, cache_dir):
        s0 = snap()
        assert artifact.plan_cache().load("geom", ("nope",)) is None
        assert delta(s0, "disk_miss", "disk_hit", "disk_corrupt") == (1, 0, 0)

    def test_renamed_entry_never_serves_another_key(self, cache_dir):
        cache = artifact.plan_cache()
        cache.store("geom", ("a",), {"v": 1})
        os.replace(cache.entry_path("geom", ("a",)),
                   cache.entry_path("geom", ("b",)))
        s0 = snap()
        assert cache.load("geom", ("b",)) is None
        assert delta(s0, "disk_invalidated", "disk_hit") == (1, 0)
        assert not os.path.exists(cache.entry_path("geom", ("b",)))

    def test_unwritable_dir_degrades_to_false(self, tmp_path):
        blocker = tmp_path / "not-a-dir"
        blocker.write_text("file where the cache dir should be")
        cache = artifact.PlanCache(blocker)
        assert cache.store("geom", ("k",), {"v": 1}) is False
        assert cache.load("geom", ("k",)) is None

    def test_decode_rejection_invalidates(self, cache_dir):
        cache = artifact.plan_cache()
        cache.store("geom", ("k",), {"v": 1})
        s0 = snap()
        assert cache.load("geom", ("k",), decode=lambda p: None) is None
        assert delta(s0, "disk_invalidated") == (1,)
        assert not entries(cache_dir, "geom")

    def test_persistable_fingerprint(self):
        assert artifact.persistable_fingerprint(H100_HBM.fingerprint())
        assert not artifact.persistable_fingerprint(("token", 3))
        assert not artifact.persistable_fingerprint(
            ("outer", ("token", 3), "x"))


class TestGeometryArtifacts:
    def test_warm_start_bit_identical(self, cache_dir):
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal(5000, dtype=np.float32))
        b = torch.from_numpy(rng.standard_normal(5000, dtype=np.float32))

        fused = isa.fuse("c0_scale", "c0_add")
        geo_cold = fused.program.negotiate_geometry(5000, F32)
        ref_cold = fused(2.0, x, b, mode="ref")
        int_cold = fused(2.0, x, b, mode="interpret")
        assert entries(cache_dir, "geom")

        prog_mod.clear_dispatch_caches()            # "fresh worker"
        s0 = snap()
        twin = isa.fuse("c0_scale", "c0_add")
        assert twin is not fused
        geo_warm = twin.program.negotiate_geometry(5000, F32)
        assert delta(s0, "geometry_misses", "disk_hit") == (0, 1)
        assert geo_warm == geo_cold
        assert torch.equal(twin(2.0, x, b, mode="ref"), ref_cold)
        assert torch.equal(twin(2.0, x, b, mode="interpret"), int_cold)

        prog_mod.clear_dispatch_caches()
        with artifact.using_plan_cache(None):
            fresh = isa.fuse("c0_scale", "c0_add")
            assert fresh.program.negotiate_geometry(5000, F32) == geo_cold
            assert torch.equal(fresh(2.0, x, b, mode="interpret"), int_cold)

    def test_no_fit_verdict_persists(self, cache_dir):
        with pytest.raises(ValueError, match="shared-memory budget"):
            two_stage_program(smem_budget=1).negotiate_geometry(4096, F32)
        assert entries(cache_dir, "geom")

        prog_mod.clear_dispatch_caches()
        s0 = snap()
        with pytest.raises(ValueError, match="shared-memory budget"):
            two_stage_program(smem_budget=1).negotiate_geometry(4096, F32)
        assert delta(s0, "geometry_misses", "disk_hit") == (0, 1)

    @pytest.mark.parametrize("damage", ["truncate", "garbage", "version",
                                        "wrong_key"])
    def test_fault_injection_recompiles_and_overwrites(self, cache_dir,
                                                       damage):
        prog = two_stage_program()
        geo = prog.negotiate_geometry(4096, F32)
        (entry,) = entries(cache_dir, "geom")

        if damage == "truncate":
            entry.write_bytes(entry.read_bytes()[:10])
        elif damage == "garbage":
            entry.write_bytes(b"\x00\xffnot json at all")
        elif damage == "version":
            data = json.loads(entry.read_text())
            data["version"] = artifact.ARTIFACT_VERSION + 1
            entry.write_text(json.dumps(data))
        else:
            data = json.loads(entry.read_text())
            data["key"] = ["somebody", "else"]
            entry.write_text(json.dumps(data))

        prog_mod.clear_dispatch_caches()
        s0 = snap()
        assert two_stage_program().negotiate_geometry(4096, F32) == geo
        bad, = delta(s0, "disk_corrupt" if damage in ("truncate", "garbage")
                     else "disk_invalidated")
        assert bad == 1
        assert delta(s0, "geometry_misses", "disk_hit") == (1, 0)
        prog_mod.clear_dispatch_caches()
        s1 = snap()
        assert two_stage_program().negotiate_geometry(4096, F32) == geo
        assert delta(s1, "geometry_misses", "disk_hit") == (0, 1)

    def test_fingerprint_drift_misses_not_serves(self, cache_dir):
        two_stage_program().negotiate_geometry(1 << 16, F32)
        prog_mod.clear_dispatch_caches()
        s0 = snap()
        edited = dataclasses.replace(H100_HBM,
                                     overhead_s=H100_HBM.overhead_s * 2)
        two_stage_program(model=edited).negotiate_geometry(1 << 16, F32)
        assert delta(s0, "disk_hit", "geometry_misses") == (0, 1)
        prog_mod.clear_dispatch_caches()
        s1 = snap()
        two_stage_program().negotiate_geometry(1 << 16, F32)
        assert delta(s1, "disk_hit", "geometry_misses") == (1, 0)

    def test_token_fingerprint_models_never_touch_disk(self, cache_dir):
        @dataclasses.dataclass(frozen=True)
        class Anonymous(BurstModel):
            """H100_HBM behaviourally, but with no value fingerprint —
            dispatch falls back to a process-local token."""
            fingerprint = None

        s0 = snap()
        prog = two_stage_program(model=Anonymous(H100_HBM.peak_bw,
                                                 H100_HBM.overhead_s))
        geo = prog.negotiate_geometry(4096, F32)
        assert geo[1] >= 1
        assert not list(cache_dir.iterdir())
        assert delta(s0, "disk_hit", "disk_miss", "disk_store") == (0, 0, 0)

    def test_hierarchy_models_not_ported_yet(self, cache_dir):
        # memhier is ported: a Hierarchy model negotiates by simulating
        # each candidate and persists the verdict under the hierarchy's
        # value fingerprint; a fresh process's view loads it back
        from repro_torch.memhier import H100
        s0 = snap()
        br, bc, _ = two_stage_program(model=H100).negotiate_geometry(
            4096, F32)
        assert br == 8 and bc % 128 == 0
        assert delta(s0, "geometry_misses", "disk_store") == (1, 1)
        assert len(entries(cache_dir, "geom")) == 1
        prog_mod.clear_dispatch_caches()
        s1 = snap()
        assert two_stage_program(model=H100).negotiate_geometry(
            4096, F32)[:2] == (br, bc)
        assert delta(s1, "geometry_misses", "disk_hit") == (0, 1)


class TestActivation:
    def test_env_var_activates(self, tmp_path, monkeypatch):
        monkeypatch.setenv(artifact.ENV_VAR, str(tmp_path))
        artifact.reset_plan_cache()
        try:
            cache = artifact.plan_cache()
            assert cache is not None and cache.path == str(tmp_path)
        finally:
            artifact.reset_plan_cache()

    def test_explicit_none_overrides_env(self, tmp_path, monkeypatch):
        monkeypatch.setenv(artifact.ENV_VAR, str(tmp_path))
        with artifact.using_plan_cache(None):
            assert artifact.plan_cache() is None
        artifact.reset_plan_cache()

    def test_using_plan_cache_restores(self, tmp_path):
        before = artifact.plan_cache()
        with artifact.using_plan_cache(tmp_path) as cache:
            assert cache.path == str(tmp_path)
            assert artifact.plan_cache() is cache
        after = artifact.plan_cache()
        assert (after is None) == (before is None)


_CHILD = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    import repro_torch.kernels
    import repro_torch.graph, repro_torch.memhier, repro_torch.obs
    import repro_torch.regions, repro_torch.sched
    from repro_torch.core import isa
    from repro_torch.core import program as prog_mod

    fused = isa.fuse("c0_scale", "c0_add")
    fused.program.negotiate_geometry(5000, torch.float32)
    s = prog_mod.DISPATCH_STATS.snapshot()
    assert "jax" not in sys.modules and "repro" not in sys.modules
    print(json.dumps({f.name: getattr(s, f.name)
                      for f in dataclasses.fields(s)}))
""")


class TestCrossProcess:
    def test_subprocess_warm_starts_from_parent_cache(self, cache_dir):
        fused = isa.fuse("c0_scale", "c0_add")
        fused.program.negotiate_geometry(5000, F32)
        assert entries(cache_dir, "geom")

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ)
        env[artifact.ENV_VAR] = str(cache_dir)
        env["PYTHONPATH"] = os.path.join(root, "src")
        proc = subprocess.run([sys.executable, "-c", _CHILD],
                              capture_output=True, text=True, env=env,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        stats = json.loads(proc.stdout.splitlines()[-1])
        assert stats["geometry_misses"] == 0, stats
        assert stats["disk_hit"] == 1, stats
        assert stats["disk_corrupt"] == 0 and stats["disk_invalidated"] == 0


# ---------------------------------------------------------------------------
# one cache directory, two packages
# ---------------------------------------------------------------------------

CHAINS = [("c0_scale", "c0_add"), ("c0_triad",),
          ("c0_scale", "c0_add", "c0_copy")]


def _jax_model_program(names):
    """The port's Program built with the JAX default model's values and
    the JAX VMEM budget, read from the reference here in the test."""
    from repro.core.burst_model import TPU_V5E_HBM
    from repro.core.stream import VMEM_BYTES
    model = BurstModel(peak_bw=TPU_V5E_HBM.peak_bw,
                       overhead_s=TPU_V5E_HBM.overhead_s)
    return Program(tuple(isa.get(n).template.stage() for n in names),
                   model=model, smem_budget=VMEM_BYTES)


@pytest.mark.parametrize("names", CHAINS, ids="+".join)
def test_jax_published_geometry_served_to_port(tmp_path, names):
    import jax.numpy as jnp
    import repro.kernels  # noqa: F401
    from repro.core import artifact as jart
    from repro.core import isa as jisa
    from repro.core import program as jprog

    jprog.clear_dispatch_caches()
    with jart.using_plan_cache(tmp_path):
        jgeo = jisa.fuse(*names).program.negotiate_geometry(1 << 20,
                                                            jnp.float32)
    assert entries(tmp_path, "geom")

    prog_mod.clear_dispatch_caches()
    with artifact.using_plan_cache(tmp_path):
        with prog_mod.dispatch_stats_window() as w:
            tgeo = _jax_model_program(names).negotiate_geometry(1 << 20, F32)
            assert w.delta("disk_hit") == 1
            assert w.delta("geometry_misses") == 0
            assert w.delta("disk_invalidated") == 0
    assert tgeo[:2] == jgeo[:2]
    assert (tgeo[2].vlen_bits, tgeo[2].block_bits) == (jgeo[2].vlen_bits,
                                                       jgeo[2].block_bits)


def test_port_published_geometry_served_to_jax(tmp_path):
    import jax.numpy as jnp
    import repro.kernels  # noqa: F401
    from repro.core import artifact as jart
    from repro.core import isa as jisa
    from repro.core import program as jprog

    prog_mod.clear_dispatch_caches()
    with artifact.using_plan_cache(tmp_path):
        tgeo = _jax_model_program(("c0_scale", "c0_add")).negotiate_geometry(
            5000, F32)
    jprog.clear_dispatch_caches()
    with jart.using_plan_cache(tmp_path):
        with jprog.dispatch_stats_window() as w:
            jgeo = jisa.fuse("c0_scale", "c0_add").program.negotiate_geometry(
                5000, jnp.float32)
            assert (w.delta("disk_hit"), w.delta("geometry_misses")) == (1, 0)
    assert jgeo[:2] == tgeo[:2]
