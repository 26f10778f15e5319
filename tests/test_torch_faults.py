"""Fault-tolerant sweep execution in the port against the JAX package: every
fault schedule of ``tests/test_faults.py`` (crash failover, a double
transient retry, retry exhaustion, a hung shard under the watchdog, a kill
in the middle of a failover, a combined chaos schedule, ``strict`` raising
with shard context) run through both packages' ``sweep`` on the CPU with 4
shards, each bitwise equal to the fault-free reference and with equal
``FaultTelemetry`` counts; the backoff delays, chaos plans and exception
taxonomy value for value; and the port's unit-level supervisor rules.
"""
import dataclasses
import os

import pytest
from test_torch_sweep import WORKLOAD, same_sweep

import repro.core as R
import repro.core.faults as RF
import repro_torch.core as T
import repro_torch.core.faults as TF
from repro_torch.distributed.sweep_shard import (
    FaultInjector,
    evaluate_sharded,
    resolve_shard_plan,
)

GRID = dict(policies=("spm", "lru", "srrip", "pinning"),
            capacities=(1 << 16, 1 << 17, 1 << 18), ways=(4, 8), zipf_s=0.9, seed=0)
SHARDS = 4
# The watchdog bound of the hang schedules, as in tests/test_faults.py:
# generous against a wave's evaluation time, so only the injected hang trips it.
HANG_TIMEOUT_S = 5.0

# name -> (events as (kind, shard, round, count), tolerance, journal cadence)
SCHEDULES = {
    "crash_failover": ((("crash", 1, 0, 1),), {}, None),
    "transient_double_retry": ((("transient", 0, 0, 2),),
                               dict(max_retries=2, backoff_base_s=0.01), None),
    "retry_exhaustion": ((("transient", 2, 0, 3),), dict(max_retries=1, backoff_base_s=0.01),
                         None),
    "hung_shard_watchdog": ((("hang", 2, 0, 1),),
                            dict(shard_timeout_s=HANG_TIMEOUT_S, backoff_base_s=0.01), None),
    "combined_chaos": ((("transient", 0, 0, 2), ("crash", 1, 0, 1), ("hang", 2, 1, 1)),
                       dict(max_retries=2, backoff_base_s=0.01, shard_timeout_s=HANG_TIMEOUT_S),
                       8),
}


def _plan(pkg, events):
    return pkg.FaultPlan(events=tuple(pkg.FaultEvent(k, shard=s, round=r, count=c)
                                      for k, s, r, c in events))


def _shards(tele):
    """Per shard: keys evaluated, retries and the failures seen (not wall
    times or device names)."""
    return {i: (rec["keys"], rec["retries"], rec["failures"]) for i, rec in tele.shards.items()}


@pytest.fixture(scope="module")
def wls():
    return R.dlrm_rmc2_small(**WORKLOAD), T.dlrm_rmc2_small(**WORKLOAD)


@pytest.fixture(scope="module")
def ref(wls):
    """The fault-free unsharded reference of the JAX package."""
    return R.sweep(wls[0], R.tpuv6e(), **GRID)


def _run(pkg, wl, name, path):
    events, tol, cadence = SCHEDULES[name]
    tele = pkg.FaultTelemetry()
    kw = dict(devices=SHARDS, fault_plan=_plan(pkg, events),
              fault_tolerance=pkg.FaultTolerance(**tol), fault_telemetry=tele, **GRID)
    if pkg is T:
        kw["device"] = "cpu"
    ck = None
    if cadence:
        ck = kw["checkpoint"] = pkg.SweepCheckpoint(path, cadence=cadence)
    try:
        return pkg.sweep(wl, pkg.tpuv6e(), **kw), tele
    finally:
        if ck is not None:
            ck.close()


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_fault_schedule_equals_jax_package(wls, ref, tmp_path, name):
    port, port_tele = _run(T, wls[1], name, str(tmp_path / "port.ckpt"))
    ref_run, ref_tele = _run(R, wls[0], name, str(tmp_path / "ref.ckpt"))
    same_sweep(port, ref, name)
    same_sweep(ref_run, ref, f"{name} (reference run)")
    assert port.telemetry is port_tele
    assert port_tele.brief() == ref_tele.brief()
    assert _shards(port_tele) == _shards(ref_tele)
    assert port_tele.any_faults


def test_fault_free_sharded_telemetry_is_all_zero(wls, ref):
    got = T.sweep(wls[1], T.tpuv6e(), devices=SHARDS, device="cpu", **GRID)
    same_sweep(got, ref, "fault-free sharded")
    assert got.telemetry.brief() == {f: 0 for f in T.FaultTelemetry.COUNTER_FIELDS}


def test_kill_mid_failover_then_resume_equals_jax_package(wls, ref, tmp_path):
    """Round 0 crashes a shard (failover), round 1 dies mid journal append;
    the resume restores every intact key and re-evaluates the torn one."""
    events = (("crash", 1, 0, 1), ("torn_write", 0, 1, 1))
    teles = {}
    for pkg, wl in ((T, wls[1]), (R, wls[0])):
        path = str(tmp_path / f"{pkg.__name__}.ckpt")
        tele = pkg.FaultTelemetry()
        extra = dict(device="cpu") if pkg is T else {}
        ck = pkg.SweepCheckpoint(path, cadence=8)
        with pytest.raises(KeyboardInterrupt):
            pkg.sweep(wl, pkg.tpuv6e(), devices=SHARDS, checkpoint=ck,
                      fault_plan=_plan(pkg, events), fault_telemetry=tele, **GRID, **extra)
        ck.close()
        teles[pkg] = tele
        resumed = pkg.sweep(wl, pkg.tpuv6e(), devices=SHARDS, checkpoint=path, **GRID, **extra)
        same_sweep(resumed, ref, f"kill mid failover, resumed ({pkg.__name__})")
        assert resumed.resumed_keys == resumed.distinct_memo_keys - 1
        assert not os.path.exists(path + ".lock")
    assert teles[T].brief() == teles[R].brief()
    assert (teles[T].worker_crashes, teles[T].failovers, teles[T].torn_writes) == (1, 1, 1)


@pytest.mark.parametrize("kind", ["crash_strict", "fatal"])
def test_unrecovered_failure_raises_with_shard_context(wls, ref, tmp_path, kind):
    """``strict`` raises on a crash instead of failing over; a fatal error
    always raises. Both carry the shard's context and the completed sibling
    shards' keys, and the journal keeps those keys for the rerun."""
    errors = {}
    for pkg, wl in ((T, wls[1]), (R, wls[0])):
        extra = dict(device="cpu") if pkg is T else {}
        path = str(tmp_path / f"{pkg.__name__}.ckpt")
        if kind == "crash_strict":
            plan, tol = _plan(pkg, (("crash", 0, 0, 1),)), pkg.FaultTolerance(strict=True)
        else:
            plan, tol = _plan(pkg, (("fatal", 3, 0, 1),)), pkg.FaultTolerance()
        with pytest.raises(pkg.ShardEvaluationError) as ei:
            pkg.sweep(wl, pkg.tpuv6e(), devices=SHARDS, fault_plan=plan, fault_tolerance=tol,
                      checkpoint=path, **GRID, **extra)
        errors[pkg] = ei.value
        resumed = pkg.sweep(wl, pkg.tpuv6e(), devices=SHARDS, checkpoint=path, **GRID, **extra)
        same_sweep(resumed, ref, f"{kind} then resume ({pkg.__name__})")
        assert resumed.resumed_keys == len(ei.value.completed)
    port, reference = errors[T], errors[R]
    assert (port.shard, port.keys, port.class_groups) == \
        (reference.shard, reference.keys, reference.class_groups)
    assert set(port.completed) == set(reference.completed) and port.completed
    assert port.device == "cpu"
    assert type(port.cause).__name__ == type(reference.cause).__name__
    if kind == "crash_strict":
        assert "strict" in str(port)


@pytest.mark.parametrize("shard", [0, 1, 3])
@pytest.mark.parametrize("attempt", [1, 2, 3, 5])
def test_backoff_seconds_equal_jax_package(shard, attempt):
    for kw in (dict(), dict(backoff_base_s=0.05, backoff_factor=2.0, jitter_frac=0.25, seed=7),
               dict(backoff_base_s=0.01, backoff_factor=3.0, jitter_frac=0.5, seed=3)):
        t = TF.backoff_seconds(TF.FaultTolerance(**kw), shard, attempt)
        assert t == RF.backoff_seconds(RF.FaultTolerance(**kw), shard, attempt)


@pytest.mark.parametrize("seed", range(0, 25, 4))
def test_chaos_plan_equals_jax_package(seed):
    for shards, rounds, n in ((4, 3, 6), (2, 1, 3), (1, 2, 4)):
        port = TF.FaultPlan.chaos(seed, num_shards=shards, num_rounds=rounds, events=n)
        ref = RF.FaultPlan.chaos(seed, num_shards=shards, num_rounds=rounds, events=n)
        assert [dataclasses.astuple(e) for e in port.events] == \
            [dataclasses.astuple(e) for e in ref.events]
        assert port.seed == ref.seed


def test_exception_taxonomy_equals_jax_package():
    for name in ("TransientEvalError", "InjectedTransientError", "InjectedWorkerCrash",
                 "InjectedFatalError", "InjectedHang", "InjectedKill"):
        assert TF.classify_exception(getattr(TF, name)("x")) == \
            RF.classify_exception(getattr(RF, name)("x")), name
    for exc in (OSError("disk"), RuntimeError("UNAVAILABLE: backend"),
                RuntimeError("RESOURCE_EXHAUSTED"), RuntimeError("device lost"),
                RuntimeError("DATA_LOSS"), KeyboardInterrupt(), SystemExit(), ValueError("bug")):
        assert TF.classify_exception(exc) == RF.classify_exception(exc), repr(exc)


@pytest.mark.parametrize("cap", [None, 1])
def test_all_shards_dead_or_failover_depth_exhausts_tolerance(cap):
    """Crash every shard: no device is left to fail over onto (cap None), or
    the failover depth cap stops a fault that follows the keys (cap 1)."""
    items = {(i,): (None, ("g", i)) for i in range(6)}
    inj = FaultInjector(TF.FaultPlan(events=tuple(
        TF.FaultEvent("crash", shard=s, round=0) for s in range(3))))
    inj.begin_round()
    with pytest.raises(TF.FaultToleranceExhausted):
        evaluate_sharded(items, resolve_shard_plan(3, "cpu"),
                         lambda part, dev: {k: [0] for k in part},
                         tolerance=TF.FaultTolerance(max_failover_rounds=cap), injector=inj)


def test_shard_worker_is_handed_its_device():
    items = {(i,): (None, ("g", i)) for i in range(6)}
    seen = []
    out = evaluate_sharded(items, resolve_shard_plan(3, "cpu"),
                           lambda part, dev: seen.append(dev) or {k: [str(dev)] for k in part})
    assert list(out) == list(items) and all(v == ["cpu"] for v in out.values())
    assert len(seen) == 3


@pytest.mark.parametrize("kind,match", [("crash", "not sharded"), ("hang", "watchdog")])
def test_plan_validation(wls, kind, match):
    plan = TF.FaultPlan(events=(TF.FaultEvent(kind, shard=0, round=0),))
    devices = SHARDS if kind == "hang" else None
    with pytest.raises(ValueError, match=match):
        T.sweep(wls[1], T.tpuv6e(), devices=devices, fault_plan=plan, device="cpu", **GRID)
