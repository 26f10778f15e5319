"""The request-level serving simulator of the PyTorch port
(``repro_torch.core.requests``, ``repro_torch.serving.scheduler``,
``ServingResult`` and ``sweep(scenarios=...)``, on the CPU) against the JAX
package's, bitwise.

Every test of ``tests/test_serving_sim.py`` and ``tests/test_serving_fixes.py``
is mirrored here: the same seeded inputs go through both packages, and the
request arrays, every ``ServingResult`` field (latency arrays, counters and
the per-batch ``EmbeddingBatchStats``), the event logs, the sweep entries and
the fault telemetry must be equal. Serving journals written by either
package resume in the other. Beyond the JAX tests: degraded batches that
lose every lookup or keep a single one (both degrade modes, every policy),
and the port's ``pallas`` / ``stack_pallas`` backends (the plain versions of
K1 and K2 on the CPU) against the JAX package's ``stack``.
"""
import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
from differential import assert_bitwise_equal_results
from test_torch_sweep import plain

import repro.core as R
import repro.core.requests as r_requests
import repro.serving as RS
import repro_torch.core as T
import repro_torch.core.requests as t_requests
import repro_torch.serving as TS
from repro.core.memory.system import EmbeddingTrace as REmbeddingTrace
from repro.core.memory.system import MultiCoreMemorySystem as RMulti
from repro.core.results import ServingResult as RServingResult
from repro.core.sweep import _serving_fingerprint as r_serving_fingerprint
from repro.core.sweep_ckpt import fingerprint_digest as r_digest
from repro.core.trace import ConcatTrace as RConcat
from repro_torch.core.memory.system import EmbeddingTrace as TEmbeddingTrace
from repro_torch.core.memory.system import MultiCoreMemorySystem as TMulti
from repro_torch.core.results import ServingResult as TServingResult
from repro_torch.core.sweep import _serving_fingerprint as t_serving_fingerprint
from repro_torch.core.sweep_ckpt import fingerprint_digest as t_digest
from repro_torch.core.trace import ConcatTrace as TConcat

SPEC_KW = dict(num_tables=4, rows_per_table=1000, dim=32, lookups_per_sample=4, dtype_bytes=4)

# The two packages behind one interface: ``P.core``, ``P.serving``, a fresh
# memory system (``P.ms(hw)``), and the types the identity test needs.
REF = SimpleNamespace(core=R, serving=RS, requests=r_requests, ServingResult=RServingResult,
                      ms=lambda hw: RMulti.from_hardware(hw), EmbeddingTrace=REmbeddingTrace,
                      ConcatTrace=RConcat, sweep=lambda *a, **k: R.sweep(*a, **k))
PORT = SimpleNamespace(core=T, serving=TS, requests=t_requests, ServingResult=TServingResult,
                       ms=lambda hw: TMulti.from_hardware(hw, "cpu"),
                       EmbeddingTrace=TEmbeddingTrace, ConcatTrace=TConcat,
                       sweep=lambda *a, **k: T.sweep(*a, device="cpu", **k))
for _p in (REF, PORT):
    _p.SPEC = _p.core.EmbeddingOpSpec(**SPEC_KW)
    _p.WL = _p.core.Workload(name="serve_wl", embedding_ops=(_p.SPEC,))
    _p.HW = _p.core.tpuv6e()

STEADY = dict(pattern="poisson", mean_gap_cycles=700.0, num_requests=48, seed=11)
# Arrival rate far above service capacity: the overload regime every
# robustness policy exists for.
OVERLOAD = dict(pattern="bursty", mean_gap_cycles=40.0, num_requests=80, seed=23, burst_len=10)
STORM_POLICY = dict(admission_watermark=12, deadline_cycles=25_000, max_retries=2,
                    retry_backoff_cycles=2_000.0)
# tests/test_serving_fixes.py's deadline storm: every failed attempt
# reschedules from an already-expired deadline.
DDL_STORM = dict(traffic=dict(pattern="bursty", mean_gap_cycles=10.0, num_requests=120,
                              seed=23, burst_len=16),
                 policy=dict(deadline_cycles=300, max_retries=3, retry_backoff_cycles=50.0),
                 batch_slots=4)

INERT = [dict(admission_watermark=10**9), dict(deadline_cycles=10**12), dict(max_retries=3),
         dict(degrade_mode="hot_rows_only", degrade_watermark=10**9),
         dict(degrade_mode="cache_bypass", degrade_watermark=10**9)]


def scenario(P, name, traffic, policy=None, batch_slots=8):
    return P.serving.ServingScenario(
        name=name, traffic=P.core.TrafficConfig(**traffic),
        policy=P.serving.RobustnessPolicy(**(policy or {})), batch_slots=batch_slots)


def serve(P, name, traffic, policy=None, batch_slots=8, hw=None, **kw):
    return P.serving.simulate_serving(P.ms(hw or P.HW), P.SPEC,
                                      scenario(P, name, traffic, policy, batch_slots), **kw)


def both(name, traffic, policy=None, batch_slots=8, **kw):
    """The scenario served by the JAX package and by the port."""
    return tuple(serve(P, name, traffic, policy, batch_slots, **kw) for P in (REF, PORT))


def same_serving(port, ref, label=""):
    """The port's ``ServingResult`` equals the reference's, bitwise: every
    field (arrays with their dtypes, each batch's stats), the derived
    summary (percentiles, rates) and the JSON record."""
    assert type(port).__name__ == type(ref).__name__ == "ServingResult", label
    assert_bitwise_equal_results(plain(port), plain(ref), label)
    assert_bitwise_equal_results(port.summary(), ref.summary(), label)
    for f in dataclasses.fields(ref):
        if isinstance(getattr(ref, f.name), np.ndarray):
            assert getattr(port, f.name).dtype == getattr(ref, f.name).dtype, (label, f.name)
    assert port.to_json() == ref.to_json(), label


def same_requests(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert (a.rid, a.arrival) == (b.rid, b.arrival)
        for name in ("table_ids", "rows", "ranks"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name


# --------------------------------------------------------------------------
# Request generators
# --------------------------------------------------------------------------

class TestGenerators:
    @pytest.mark.parametrize("pattern", ["poisson", "diurnal", "bursty"])
    def test_arrivals_sorted_deterministic(self, pattern):
        kw = dict(pattern=pattern, mean_gap_cycles=100.0, num_requests=64, seed=3)
        a = T.generate_arrivals(T.TrafficConfig(**kw))
        assert a.dtype == np.int64
        assert np.array_equal(a, T.generate_arrivals(T.TrafficConfig(**kw)))
        assert np.array_equal(a, R.generate_arrivals(R.TrafficConfig(**kw)))
        assert np.all(np.diff(a) >= 0) and a[0] >= 0
        c = T.generate_arrivals(T.TrafficConfig(**{**kw, "seed": 4}))
        assert not np.array_equal(a, c)
        assert np.array_equal(c, R.generate_arrivals(R.TrafficConfig(**{**kw, "seed": 4})))

    @pytest.mark.parametrize("kw", [
        dict(num_requests=32, seed=5, tables_per_request=2, lookups_per_table=3,
             zipf_drift=0.6, drift_period=8),
        dict(pattern="diurnal", num_requests=40, seed=2, zipf_s=1.1, zipf_drift=-0.3),
        dict(pattern="bursty", num_requests=24, seed=9, tables_per_request=1, burst_len=4),
    ], ids=["drift_period", "diurnal_grid_drift", "bursty_one_table"])
    def test_requests_deterministic_and_in_range(self, kw):
        port = T.generate_requests(PORT.SPEC, T.TrafficConfig(**kw))
        same_requests(port, R.generate_requests(REF.SPEC, R.TrafficConfig(**kw)))
        same_requests(port, T.generate_requests(PORT.SPEC, T.TrafficConfig(**kw)))
        tpr = kw.get("tables_per_request") or SPEC_KW["num_tables"]
        for r in port:
            assert r.rows.shape == (tpr, kw.get("lookups_per_table") or 4)
            assert r.rows.min() >= 0 and r.rows.max() < SPEC_KW["rows_per_table"]
            assert np.array_equal(r.table_ids, np.sort(r.table_ids))

    def test_popularity_drift_rotates_hot_rows(self):
        kw = dict(num_requests=32, seed=7, drift_period=16, zipf_s=1.2)
        reqs = T.generate_requests(PORT.SPEC, T.TrafficConfig(**kw))
        same_requests(reqs, R.generate_requests(REF.SPEC, R.TrafficConfig(**kw)))

        def rank0_rows(rs):
            return {int(x) for r in rs for x in r.rows[r.ranks == 0]}
        e0, e1 = rank0_rows(reqs[:16]), rank0_rows(reqs[16:])
        assert e0 and e1 and e0 != e1

    @pytest.mark.parametrize("keep", [0.25, 0.5, 1.0])
    def test_hot_table_set_deterministic(self, keep):
        kw = dict(num_requests=24, seed=9, tables_per_request=2)
        port = t_requests.hot_table_set(
            T.generate_requests(PORT.SPEC, T.TrafficConfig(**kw)), PORT.SPEC, keep)
        ref = r_requests.hot_table_set(
            R.generate_requests(REF.SPEC, R.TrafficConfig(**kw)), REF.SPEC, keep)
        assert port.dtype == ref.dtype and np.array_equal(port, ref)
        assert port.sum() == max(1, int(np.ceil(4 * keep)))

    def test_traffic_validation(self):
        for P in (REF, PORT):
            with pytest.raises(ValueError, match="unknown arrival pattern"):
                P.core.TrafficConfig(pattern="lunar")
            with pytest.raises(ValueError, match="num_requests"):
                P.core.TrafficConfig(num_requests=0)
            with pytest.raises(ValueError, match="mean_gap_cycles"):
                P.core.TrafficConfig(mean_gap_cycles=0.0)
            with pytest.raises(ValueError, match=r"tables_per_request=99 outside \[1, 4\]"):
                P.core.generate_requests(P.SPEC, P.core.TrafficConfig(tables_per_request=99))

    def test_keys_and_module_constants_equal_jax_package(self):
        """Memo keys and journals name scenarios by these tuples, and the
        seed tags fix every stream."""
        for name in ("_ARRIVAL_TAG", "_SHAPE_TAG", "_ROWS_TAG", "_PERM_TAG", "_DRIFT_GRID",
                     "ARRIVAL_PATTERNS"):
            assert getattr(t_requests, name) == getattr(r_requests, name), name
        assert TS.DEGRADE_MODES == RS.DEGRADE_MODES
        sc = [scenario(P, "storm", OVERLOAD, STORM_POLICY) for P in (REF, PORT)]
        assert sc[1].key == sc[0].key and repr(sc[1].key) == repr(sc[0].key)


# --------------------------------------------------------------------------
# Identity: policies off == plain fixed-trace path
# --------------------------------------------------------------------------

def _plain_batches(P, reqs, slots):
    """One plain ``simulate_embedding`` over the arrival-order lowered trace."""
    lowered = [P.requests.lower_batch(reqs[i:i + slots], P.SPEC)
               for i in range(0, len(reqs), slots)]
    return P.ms(P.HW).simulate_embedding(P.EmbeddingTrace.from_concat(
        P.SPEC, P.ConcatTrace.from_traces([b.full for b in lowered])))


class TestIdentity:
    def test_all_off_equals_plain_simulate_embedding(self):
        ref, port = both("steady", STEADY)
        same_serving(port, ref, "all-off")
        reqs = T.generate_requests(PORT.SPEC, T.TrafficConfig(**STEADY))
        assert_bitwise_equal_results(port.batch_stats, _plain_batches(PORT, reqs, 8),
                                     "all-off vs plain")
        assert port.offered == port.completed == len(reqs)
        assert port.shed == port.timed_out == port.retries == 0
        assert port.degraded_batches == 0 and port.goodput == 1.0

    @pytest.mark.parametrize("policy", INERT, ids=[next(iter(p)) + (
        f"_{p['degrade_mode']}" if "degrade_mode" in p else "") for p in INERT])
    def test_inert_policy_is_identity(self, policy):
        """An armed policy that never triggers runs the closed loop (a
        growing prefix re-priced per batch) and lands bitwise on the
        all-off fast path, in both packages."""
        base = serve(PORT, "s", STEADY)
        ref, port = both("s", STEADY, policy)
        same_serving(port, ref, "inert policy")
        same_serving(port, base, "inert policy vs all-off")

    def test_partial_final_batch(self):
        cfg = {**STEADY, "num_requests": 21}
        ref, port = both("p", cfg)
        same_serving(port, ref, "partial final batch")
        assert port.completed == 21 and port.num_batches == 3


# --------------------------------------------------------------------------
# Reproducible overload
# --------------------------------------------------------------------------

class TestOverload:
    def test_overload_triggers_all_counters(self):
        ref, port = both("storm", OVERLOAD, STORM_POLICY)
        same_serving(port, ref, "storm")
        assert port.shed > 0 and port.retries > 0
        assert port.shed + port.timed_out == port.retries + port.abandoned
        assert port.makespan_cycles > 0

    def test_retry_storm_bitwise_reproducible(self):
        a = serve(PORT, "storm", OVERLOAD, STORM_POLICY)
        assert a.diff(serve(PORT, "storm", OVERLOAD, STORM_POLICY)) == {}
        same_serving(a, serve(REF, "storm", OVERLOAD, STORM_POLICY), "retry storm")

    @pytest.mark.parametrize("mode", ["hot_rows_only", "cache_bypass"])
    def test_degradation_bitwise_reproducible(self, mode):
        pol = dict(degrade_mode=mode, degrade_watermark=2, hot_fraction=0.2,
                   bypass_keep_tables=0.5)
        ref, port = both("deg", OVERLOAD, pol)
        same_serving(port, ref, f"degradation {mode}")
        assert port.diff(serve(PORT, "deg", OVERLOAD, pol)) == {}
        assert port.degraded_batches > 0
        assert (port.dropped_cold_rows if mode == "hot_rows_only" else port.bypassed_lookups) > 0
        assert port.completed == port.offered

    def test_deadline_timeouts_fire(self):
        ref, port = both("ddl", OVERLOAD, dict(deadline_cycles=1_500))
        same_serving(port, ref, "deadline")
        assert port.timed_out > 0
        assert port.completed + port.timed_out == port.offered
        assert port.goodput < 1.0

    def test_policy_validation(self):
        for P in (REF, PORT):
            with pytest.raises(ValueError, match="unknown degrade_mode"):
                P.serving.RobustnessPolicy(degrade_mode="pray")
            with pytest.raises(ValueError, match="max_retries"):
                P.serving.RobustnessPolicy(max_retries=-1)
            with pytest.raises(ValueError, match="batch_slots"):
                scenario(P, "x", STEADY, batch_slots=0)

    @pytest.mark.parametrize("attempt", [1, 2, 5])
    def test_retry_backoff_equals_jax_package(self, attempt):
        from repro.serving.scheduler import _retry_backoff as r_backoff
        from repro_torch.serving.scheduler import _retry_backoff as t_backoff
        for rid in (0, 7, 1234):
            for kw in (dict(retry_seed=0), dict(retry_seed=3, retry_jitter_frac=0.9,
                                                retry_backoff_factor=1.5)):
                assert t_backoff(TS.RobustnessPolicy(**kw), rid, attempt) == r_backoff(
                    RS.RobustnessPolicy(**kw), rid, attempt)


# --------------------------------------------------------------------------
# Degraded batches down to no lookup, and the scan backends
# --------------------------------------------------------------------------

# One table a request, one lookup, one request a batch, every batch degraded
# (watermark 0): ``hot_rows_only`` at a rank limit of 1 keeps only rank-0
# lookups, ``cache_bypass`` keeping 1 of 4 tables drops every request on a
# cold table. Each batch is then empty or a single lookup, and the seeds make
# the first batches empty: the memory system prices a prefix with no lookup
# at all, then a one-lookup stream.
EDGE_TRAFFIC = dict(pattern="poisson", mean_gap_cycles=700.0, num_requests=12,
                    tables_per_request=1, lookups_per_table=1)


def _edge(mode):
    return (dict(EDGE_TRAFFIC, seed=0 if mode == "hot_rows_only" else 1),
            dict(degrade_mode=mode, degrade_watermark=0, hot_fraction=0.001,
                 bypass_keep_tables=0.25))


@pytest.mark.parametrize("policy", ["spm", "lru", "srrip", "fifo", "pinning"])
@pytest.mark.parametrize("mode", ["hot_rows_only", "cache_bypass"])
def test_empty_and_one_lookup_degraded_batches(mode, policy):
    traffic, pol = _edge(mode)
    ref, port = (serve(P, "edge", traffic, pol, batch_slots=1,
                       hw=P.HW.with_policy(P.core.OnChipPolicy(policy))) for P in (REF, PORT))
    same_serving(port, ref, f"{mode}/{policy}")
    lines_per_vector = -(-PORT.SPEC.vector_bytes // PORT.HW.onchip.line_bytes)
    lookups = [s.onchip_reads // lines_per_vector for s in port.batch_stats]
    assert port.degraded_batches == port.num_batches == 12
    assert lookups[0] == 0 and 0 in lookups and max(lookups) > 0
    assert set(lookups) == {0, 1}
    if mode == "hot_rows_only":
        assert port.dropped_cold_rows > 0
    else:
        assert port.bypassed_lookups > 0


@pytest.mark.parametrize("backend", ["pallas", "stack_pallas"])
@pytest.mark.parametrize("case", ["storm", "edge_hot_rows_only", "edge_cache_bypass"])
def test_port_scan_backends_equal_jax_stack(case, backend):
    """The port's K1 (``pallas``) and K2 (``stack_pallas``) plain versions
    under the closed loop, against the JAX package's ``stack`` engine (its
    Pallas K1/K2 do not run on the installed jax; the backends are equal)."""
    if case == "storm":
        args, slots = (OVERLOAD, STORM_POLICY), 8
    else:
        args, slots = _edge(case[len("edge_"):]), 1
    ref = serve(REF, case, *args, batch_slots=slots)
    port = serve(PORT, case, *args, batch_slots=slots,
                 hw=PORT.HW.replace(cache_backend=backend))
    same_serving(port, ref, f"{case}/{backend}")


# --------------------------------------------------------------------------
# Replay oracle (checkpoint reconstruction seam)
# --------------------------------------------------------------------------

class TestReplay:
    def test_replay_reconstructs_bitwise(self):
        live = serve(PORT, "storm", OVERLOAD, STORM_POLICY)
        replayed = serve(PORT, "storm", OVERLOAD, STORM_POLICY,
                         oracle=TS.ReplayOracle(live.batch_stats))
        assert live.diff(replayed) == {}
        ref = serve(REF, "storm", OVERLOAD, STORM_POLICY)
        same_serving(replayed, ref, "replay")
        # The reference's recorded stats replayed through the port's
        # scheduler: the scheduler alone, against the reference's.
        cross = serve(PORT, "storm", OVERLOAD, STORM_POLICY,
                      oracle=TS.ReplayOracle(ref.batch_stats))
        assert_bitwise_equal_results(cross.summary(), ref.summary(), "cross replay")
        assert np.array_equal(cross.latency_cycles, ref.latency_cycles)

    def test_replay_misuse_raises(self):
        live = serve(PORT, "s", STEADY)
        with pytest.raises(RuntimeError, match="exhausted"):
            serve(PORT, "s", STEADY, oracle=TS.ReplayOracle(live.batch_stats[:-1]))
        with pytest.raises(RuntimeError, match="undrained"):
            serve(PORT, "s", STEADY,
                  oracle=TS.ReplayOracle(live.batch_stats + live.batch_stats[-1:]))


# --------------------------------------------------------------------------
# Scenario axis in sweep(): sharding / checkpoint / fault composition
# --------------------------------------------------------------------------

def scenarios(P):
    return [scenario(P, "steady", STEADY), scenario(P, "storm", OVERLOAD, STORM_POLICY)]


def sweep_grid(P):
    return dict(policies=("spm", "lru"), capacities=(1 << 20,), ways=(8,),
                scenarios=scenarios(P))


def records(sr):
    """Each entry's config, result and memo key, as plain values."""
    return [(plain(e.config), plain(e.result), e.memo_key) for e in sr.entries]


def same_serving_sweep(port, ref, label=""):
    assert_bitwise_equal_results(records(port), records(ref), label)
    assert port.distinct_memo_keys == ref.distinct_memo_keys, label


@pytest.fixture(scope="module")
def ref_sweep():
    return R.sweep(REF.WL, REF.HW, **sweep_grid(REF))


class TestServingSweep:
    def test_sweep_matches_direct_simulation(self, ref_sweep):
        res = PORT.sweep(PORT.WL, PORT.HW, **sweep_grid(PORT))
        same_serving_sweep(res, ref_sweep, "serving sweep")
        assert res.num_configs == 4
        for e in res.entries:
            assert e.config.label.endswith(f"/sv:{e.config.scenario}")
            sc = next(s for s in scenarios(PORT) if s.name == e.config.scenario)
            hw = PORT.HW.with_policy(e.config.policy, capacity_bytes=e.config.capacity_bytes,
                                     ways=e.config.ways)
            direct = TS.simulate_serving(PORT.ms(hw), PORT.SPEC, sc)
            assert e.result.diff(direct) == {}, e.config.label
        row = res.entries[0].row()
        for k in ("p50_cycles", "p95_cycles", "p99_cycles", "goodput", "shed", "sustained_qps"):
            assert k in row
        assert res.best("p99_cycles") in res.entries
        assert row == ref_sweep.entries[0].row()

    def test_sweep_sharded_bitwise(self, ref_sweep):
        got = PORT.sweep(PORT.WL, PORT.HW, devices=2, **sweep_grid(PORT))
        assert got.sharded
        same_serving_sweep(got, ref_sweep, "sharded serving sweep")

    def test_sweep_checkpoint_resume_bitwise(self, ref_sweep, tmp_path):
        path = str(tmp_path / "serving.ckpt")
        first = PORT.sweep(PORT.WL, PORT.HW, checkpoint=path, **sweep_grid(PORT))
        resumed = PORT.sweep(PORT.WL, PORT.HW, checkpoint=path, **sweep_grid(PORT))
        assert resumed.resumed_keys == resumed.distinct_memo_keys == 4
        same_serving_sweep(first, ref_sweep, "ckpt first run")
        same_serving_sweep(resumed, ref_sweep, "ckpt resume")
        assert not os.path.exists(path + ".lock")

    @pytest.mark.parametrize("writer", ["jax_package", "port"])
    def test_sweep_journal_resumes_in_the_other_package(self, ref_sweep, tmp_path, writer):
        """A serving journal of either package resumes in the other: the
        fingerprint and each key's stats are the same bytes' worth."""
        path = str(tmp_path / "cross.ckpt")
        first, second = (REF, PORT) if writer == "jax_package" else (PORT, REF)
        first.sweep(first.WL, first.HW, checkpoint=path, **sweep_grid(first))
        resumed = second.sweep(second.WL, second.HW, checkpoint=path, **sweep_grid(second))
        assert resumed.resumed_keys == resumed.distinct_memo_keys == 4
        if second is PORT:
            same_serving_sweep(resumed, ref_sweep, "reference journal resumed by the port")
        else:
            assert_bitwise_equal_results(resumed, ref_sweep, "port journal resumed by the reference")

    def test_serving_fingerprint_equals_jax_package(self):
        from repro.core.sweep import _resolve_axes as r_axes
        from repro_torch.core.sweep import _resolve_axes as t_axes
        import itertools
        fps = []
        for P, axes_fn, fp in ((REF, r_axes, r_serving_fingerprint),
                               (PORT, t_axes, t_serving_fingerprint)):
            g = sweep_grid(P)
            axes = axes_fn(P.HW, g["policies"], g["capacities"], g["ways"], None, None, None,
                           None, None)
            fps.append(fp((P.WL,), P.HW, list(itertools.product(*axes)), g["scenarios"]))
        assert fps[1] == fps[0]
        assert t_digest(fps[1]) == r_digest(fps[0])

    def test_sweep_fault_injection_bitwise(self, ref_sweep):
        tele = {}
        for P in (REF, PORT):
            tele[P is PORT] = P.core.FaultTelemetry()
            plan = P.core.FaultPlan(events=(P.core.FaultEvent("crash", shard=1, round=0),))
            got = P.sweep(P.WL, P.HW, devices=2, fault_plan=plan, fault_telemetry=tele[P is PORT],
                          **sweep_grid(P))
        same_serving_sweep(got, ref_sweep, "serving crash failover")
        assert tele[True].worker_crashes == tele[False].worker_crashes == 1
        assert tele[True].failovers == tele[False].failovers == 1
        for k in ("worker_crashes", "failovers", "transient_retries", "watchdog_timeouts",
                  "degraded_devices"):
            if hasattr(tele[False], k):
                assert getattr(tele[True], k) == getattr(tele[False], k), k

    def test_sweep_rejects_bad_combinations(self):
        for P in (REF, PORT):
            g = sweep_grid(P)
            with pytest.raises(ValueError, match="configs"):
                P.sweep(P.WL, P.HW, configs=[], **g)
            with pytest.raises(ValueError, match="index_trace"):
                P.sweep(P.WL, P.HW, index_trace=np.arange(8), **g)
            dup = [g["scenarios"][0], g["scenarios"][0]]
            with pytest.raises(ValueError, match="duplicate"):
                P.sweep(P.WL, P.HW, policies=("spm",), scenarios=dup)
            wl = P.core.Workload(name="no_emb", embedding_ops=())
            with pytest.raises(ValueError, match="no embedding op"):
                P.sweep(wl, P.HW, policies=("spm",), scenarios=g["scenarios"][:1])


# --------------------------------------------------------------------------
# The fixes of tests/test_serving_fixes.py
# --------------------------------------------------------------------------

class TestRetryMonotonicity:
    def test_event_timeline_never_rewinds(self):
        logs = ([], [])
        ref, port = (serve(P, "ddl_storm", event_log=log, **DDL_STORM)
                     for P, log in zip((REF, PORT), logs))
        same_serving(port, ref, "deadline storm")
        assert logs[1] == logs[0] and len(logs[1]) > 0
        assert port.timed_out > 0 and port.retries > 0
        diffs = np.diff(np.asarray(logs[1], dtype=np.int64))
        assert (diffs >= 0).all(), f"clock rewound at {np.argmin(diffs)}"

    def test_storm_still_bitwise_reproducible(self):
        a = serve(PORT, "ddl_storm", **DDL_STORM)
        assert not a.diff(serve(PORT, "ddl_storm", **DDL_STORM))

    def test_conservation_under_storm(self):
        res = serve(PORT, "ddl_storm", **DDL_STORM)
        assert res.shed + res.timed_out == res.retries + res.abandoned
        assert res.completed + res.abandoned == res.offered
        assert 0 < res.completed < res.offered


class TestFalsyZeroValidation:
    @pytest.mark.parametrize("knob", ["tables_per_request", "lookups_per_table"])
    def test_zero_knob_raises(self, knob):
        for P in (REF, PORT):
            with pytest.raises(ValueError, match=knob):
                P.core.generate_requests(P.SPEC, P.core.TrafficConfig(num_requests=4, **{knob: 0}))

    def test_none_still_means_spec_defaults(self):
        reqs = T.generate_requests(PORT.SPEC, T.TrafficConfig(num_requests=4))
        assert reqs[0].rows.shape == (SPEC_KW["num_tables"], SPEC_KW["lookups_per_sample"])
        same_requests(reqs, R.generate_requests(REF.SPEC, R.TrafficConfig(num_requests=4)))


class TestDriftQuantization:
    @pytest.mark.parametrize("kw", [
        dict(num_requests=50, zipf_s=0.9, zipf_drift=0.0, drift_period=7),
        dict(num_requests=100, zipf_s=0.8, zipf_drift=0.5, drift_period=5),
        dict(num_requests=10_000, zipf_s=0.8, zipf_drift=0.5, drift_period=0),
        dict(num_requests=33, zipf_s=1.0, zipf_drift=-0.4, drift_period=0),
    ], ids=["zero_drift", "period", "grid", "negative_grid"])
    def test_exponents_equal_jax_package(self, kw):
        port = t_requests.drift_exponents(T.TrafficConfig(**kw))
        ref = r_requests.drift_exponents(R.TrafficConfig(**kw))
        assert port.dtype == ref.dtype and np.array_equal(port, ref)

    def test_zero_drift_is_exact_base_exponent(self):
        cfg = T.TrafficConfig(num_requests=50, zipf_s=0.9, zipf_drift=0.0, drift_period=7)
        assert np.array_equal(t_requests.drift_exponents(cfg), np.full(50, 0.9))

    def test_distinct_exponents_bounded_by_epochs(self):
        exps = t_requests.drift_exponents(
            T.TrafficConfig(num_requests=100, zipf_s=0.8, zipf_drift=0.5, drift_period=5))
        assert len(np.unique(exps)) <= 20 and (np.diff(exps) >= 0).all()
        assert (exps[:5] == exps[0]).all() and exps[5] != exps[0]

    def test_no_period_uses_fixed_grid(self):
        cfg = T.TrafficConfig(num_requests=10_000, zipf_s=0.8, zipf_drift=0.5, drift_period=0)
        assert len(np.unique(t_requests.drift_exponents(cfg))) <= t_requests._DRIFT_GRID

    def test_cdf_cache_stays_bounded(self, monkeypatch):
        """One ``zipf_probs`` cumsum per distinct exponent in the port's
        copy, as in the JAX package's — the same count in both."""
        counts = []
        for mod, P in ((t_requests, PORT), (r_requests, REF)):
            calls = []
            real = mod.zipf_probs
            monkeypatch.setattr(mod, "zipf_probs", lambda n, s, real=real, calls=calls:
                                calls.append(s) or real(n, s))
            P.core.generate_requests(P.SPEC, P.core.TrafficConfig(
                num_requests=96, zipf_s=0.8, zipf_drift=0.5, drift_period=8))
            assert len(calls) == len(set(calls)) <= 12
            counts.append(calls)
        assert counts[0] == counts[1]
        assert callable(t_requests._zipf_cdf)

    def test_drifting_stream_deterministic(self):
        kw = dict(num_requests=40, zipf_drift=0.4, drift_period=8)
        reqs = T.generate_requests(PORT.SPEC, T.TrafficConfig(**kw))
        same_requests(reqs, T.generate_requests(PORT.SPEC, T.TrafficConfig(**kw)))
        same_requests(reqs, R.generate_requests(REF.SPEC, R.TrafficConfig(**kw)))


class TestZeroMakespanGuard:
    @staticmethod
    def _result(P, makespan, completed=0):
        z = np.zeros(0, dtype=np.int64)
        return P.ServingResult(
            scenario="s", hardware="h", policy="p", clock_ghz=1.0, offered=0,
            completed=completed, shed=0, timed_out=0, retries=0, abandoned=0,
            degraded_batches=0, dropped_cold_rows=0, bypassed_lookups=0, num_batches=0,
            makespan_cycles=makespan, goodput=0.0, latency_cycles=z, queue_cycles=z,
            service_cycles=z)

    def test_summary_does_not_raise(self):
        s = self._result(PORT, 0).summary()
        assert np.isnan(s["sustained_qps"]) and np.isnan(s["sustained_qps_per_mcycle"])
        assert_bitwise_equal_results(s, self._result(REF, 0).summary(), "zero makespan")

    def test_nonzero_makespan_unaffected(self):
        r = self._result(PORT, 1_000_000, completed=10)
        assert r.sustained_qps_per_mcycle == pytest.approx(10.0)
        assert_bitwise_equal_results(r.summary(),
                                     self._result(REF, 1_000_000, completed=10).summary())
