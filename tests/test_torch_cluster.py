"""The port's sharded cluster and chaos harness, held to the reference's
own suites (``tests/test_cluster.py`` and ``tests/test_chaos.py``, each test
under its reference name).

* ``ShardedStorage``: URL parsing, consistent-hash routing, id
  virtualization, full-contract parity against a single server, per-shard
  batching, and a TPE study through the router with the cache.
* The chaos harness: injector primitives, replication, promotion, client
  failover, stale-trial reclamation, journal crash recovery, cached-flush
  outage survival, and the acceptance storm: a seeded run that loses a
  shard primary mid-flight and must converge bit-identical to an
  uninterrupted run with zero lost tells.  The port's storm runs 32
  workers (the reference's 100) and waits on events where the reference
  sleeps and polls, so its kill lands after the same tell every run.
"""

import threading
import time

import pytest

from repro_torch.core import telemetry
from repro_torch.core.distributions import FloatDistribution
from repro_torch.core.exceptions import RetryableStorageError, StorageUnavailableError
from repro_torch.core.frozen import StudyDirection, TrialState
from repro_torch.core.storage import (
    CachedStorage,
    InMemoryStorage,
    JournalStorage,
    RemoteStorage,
    ShardedStorage,
    StorageServer,
    get_storage,
)
from repro_torch.core.storage.chaos import ChaosCluster, FaultInjector
from repro_torch.core.storage.cluster import HashRing, parse_sharded_url


# -- the sharded cluster (tests/test_cluster.py) -------------------------------


@pytest.fixture
def pool():
    servers = [StorageServer(InMemoryStorage()).start() for _ in range(3)]
    yield servers
    for s in servers:
        s.stop()


def _sharded(pool, **kw):
    return ShardedStorage([s.url for s in pool], **kw)


class TestParsing:
    def test_split_keeps_scheme_and_token(self):
        assert parse_sharded_url("remote://tok@a:1,b:2,c:3") == [
            "remote://tok@a:1",
            "remote://tok@b:2",
            "remote://tok@c:3",
        ]

    def test_split_keeps_failover_candidates(self):
        assert parse_sharded_url("remote://a:1+a2:2,b:3") == [
            "remote://a:1+a2:2",
            "remote://b:3",
        ]

    def test_tls_scheme(self):
        assert parse_sharded_url("remote+tls://a:1,b:2") == [
            "remote+tls://a:1",
            "remote+tls://b:2",
        ]

    def test_not_remote_raises(self):
        with pytest.raises(ValueError):
            parse_sharded_url("sqlite:///x.db")

    def test_get_storage_routes_comma_urls(self, pool):
        url = "remote://" + ",".join(s.url.split("://")[1] for s in pool)
        st = get_storage(url)
        assert isinstance(st, ShardedStorage)
        st.close()

    def test_get_storage_single_stays_remote(self, pool):
        st = get_storage(pool[0].url)
        assert isinstance(st, RemoteStorage)
        st.close()


class TestHashRing:
    def test_deterministic_across_instances(self):
        a, b = HashRing(4), HashRing(4)
        keys = [f"study-{i}" for i in range(200)]
        assert [a.lookup(k) for k in keys] == [b.lookup(k) for k in keys]

    def test_spreads_keys(self):
        ring = HashRing(3)
        owners = {ring.lookup(f"study-{i}") for i in range(100)}
        assert owners == {0, 1, 2}

    def test_consistency_under_growth(self):
        # growing the pool must not reshuffle the world: most keys keep
        # their owner (the consistent-hashing property)
        small, big = HashRing(3), HashRing(4)
        keys = [f"study-{i}" for i in range(1000)]
        moved = sum(small.lookup(k) != big.lookup(k) for k in keys)
        assert moved < 500  # naive mod-N hashing would move ~75%


class TestIdVirtualization:
    def test_round_trip(self, pool):
        st = _sharded(pool)
        for gid in [0, 1, 2, 3, 7, 100, 12345]:
            shard, local = st._split(gid)
            assert st._gid(local, shard) == gid
            assert 0 <= shard < 3

    def test_study_and_trial_ids_are_global(self, pool):
        st = _sharded(pool)
        sids = [st.create_new_study([StudyDirection.MINIMIZE], f"s{i}") for i in range(9)]
        assert len(set(sids)) == 9
        assert len({sid % 3 for sid in sids}) > 1  # actually spread
        for i, sid in enumerate(sids):
            assert st.get_study_id_from_name(f"s{i}") == sid
            assert st.get_study_name_from_id(sid) == f"s{i}"
        tids = [st.create_new_trial(sid) for sid in sids for _ in range(2)]
        assert len(set(tids)) == len(tids)
        st.close()

    def test_trials_route_back_to_their_shard(self, pool):
        st = _sharded(pool)
        sid = st.create_new_study([StudyDirection.MINIMIZE], "routed")
        tids = st.create_new_trials(sid, 5)
        for i, tid in enumerate(tids):
            st.set_trial_param(tid, "x", 0.25, FloatDistribution(0, 1))
            assert st.set_trial_state_values(tid, TrialState.COMPLETE, [float(i)])
        trials = st.get_all_trials(sid)
        assert [t.trial_id for t in trials] == tids
        assert [t.number for t in trials] == list(range(5))
        assert st.get_trial(tids[3]).values == [3.0]
        assert st.get_trial_id_from_study_and_number(sid, 3) == tids[3]
        st.close()


class TestContractParity:
    def test_attrs_and_summaries(self, pool):
        st = _sharded(pool)
        sids = [st.create_new_study([StudyDirection.MAXIMIZE], f"p{i}") for i in range(4)]
        for sid in sids:
            st.set_study_user_attr(sid, "team", "a")
            st.set_study_system_attr(sid, "v", 1)
            assert st.get_study_user_attrs(sid) == {"team": "a"}
            assert st.get_study_system_attrs(sid) == {"v": 1}
            assert st.get_study_directions(sid) == [StudyDirection.MAXIMIZE]
        summaries = st.get_all_studies()
        assert sorted(s.study_id for s in summaries) == sorted(sids)
        st.delete_study(sids[0])
        assert len(st.get_all_studies()) == 3
        st.close()

    def test_iv_block_trial_ids_are_globalized(self, pool):
        st = _sharded(pool)
        sid = st.create_new_study([StudyDirection.MINIMIZE], "ivs")
        tids = st.create_new_trials(sid, 3)
        for step in range(2):
            for tid in tids:
                st.set_trial_intermediate_value(tid, step, float(step))
        block = st.get_iv_block(sid)
        assert sorted(int(t) for t in block["trial_ids"]) == sorted(tids)
        # observation blocks and trial events are keyed by per-study numbers
        for tid, v in zip(tids, (1.0, 2.0, 3.0)):
            st.set_trial_state_values(tid, TrialState.COMPLETE, [v])
        obs = st.get_observation_block(sid)
        assert sorted(int(n) for n in obs["numbers"]) == [0, 1, 2]
        ev = st.get_trial_events(sid)
        assert len(ev["kind"]) > 0
        st.close()

    def test_heartbeats_and_reclaim(self, pool):
        st = _sharded(pool)
        sid = st.create_new_study([StudyDirection.MINIMIZE], "hb")
        tid = st.create_new_trial(sid)
        st.record_heartbeat(tid)
        assert st.get_stale_trial_ids(sid, grace_seconds=3600) == []
        assert st.get_stale_trial_ids(sid, grace_seconds=-1.0) == [tid]
        assert st.reclaim_stale_trials(sid, grace_seconds=-1.0, requeue=True) == [tid]
        assert st.get_trial(tid).state == TrialState.WAITING
        st.close()

    def test_revision_and_counts(self, pool):
        st = _sharded(pool)
        sid = st.create_new_study([StudyDirection.MINIMIZE], "rev")
        r0 = st.get_trials_revision(sid)
        tid = st.create_new_trial(sid)
        assert st.get_trials_revision(sid) > r0
        assert st.get_n_trials(sid) == 1
        assert st.get_n_trials(sid, states=(TrialState.COMPLETE,)) == 0
        st.set_trial_user_attr(tid, "k", [1, 2])
        st.set_trial_system_attr(tid, "s", "x")
        t = st.get_trial(tid)
        assert t.user_attrs == {"k": [1, 2]} and t.system_attrs["s"] == "x"
        st.close()

    def test_server_metrics_fan_out(self, pool):
        st = _sharded(pool)
        st.create_new_study([StudyDirection.MINIMIZE], "m")
        metrics = st.get_server_metrics()
        assert len(metrics["shards"]) == 3
        assert all("frames_in" in m for m in metrics["shards"])
        st.close()

    def test_supports_block_fetch(self, pool):
        st = _sharded(pool)
        assert st.supports_block_fetch is True
        st.close()


class TestCallBatch:
    def test_batch_routes_and_reassembles_in_order(self, pool):
        st = _sharded(pool)
        sids = [st.create_new_study([StudyDirection.MINIMIZE], f"b{i}") for i in range(6)]
        tids = [st.create_new_trial(sid) for sid in sids]
        calls = []
        for tid in tids:
            calls.append(("get_trial", (tid,)))
        for sid in sids:
            calls.append(("get_n_trials", (sid, None)))
        out = st.call_batch(calls)
        assert [t.trial_id for t in out[: len(tids)]] == tids
        assert out[len(tids):] == [1] * len(sids)
        st.close()

    def test_batch_writes_and_fused_prune(self, pool):
        st = _sharded(pool)
        sid = st.create_new_study([StudyDirection.MINIMIZE], "fused")
        tid = st.create_new_trial(sid)
        spec = {"name": "median", "n_startup_trials": 100}
        out = st.call_batch(
            [
                ("set_trial_intermediate_value", (tid, 0, 1.5)),
                ("report_and_prune", (sid, tid, 1, 0.5, spec, StudyDirection.MINIMIZE)),
            ]
        )
        assert out[-1] in (True, False)
        assert st.get_trial(tid).intermediate_values == {0: 1.5, 1: 0.5}
        st.close()

    def test_unroutable_method_raises(self, pool):
        st = _sharded(pool)
        with pytest.raises(ValueError):
            st.call_batch([("get_all_studies", ())])
        st.close()


class TestEndToEnd:
    def test_optimize_through_router_with_cache(self, pool):
        from repro_torch.core.samplers import TPESampler
        from repro_torch.core.study import create_study

        url = "remote://" + ",".join(s.url.split("://")[1] for s in pool)
        storage = get_storage(url, cache=True)
        study = create_study(
            storage=storage, study_name="e2e", sampler=TPESampler(seed=7, engine="numpy")
        )
        study.optimize(lambda t: t.suggest_float("x", -5, 5) ** 2, n_trials=15)
        assert len(study.trials) == 15
        assert study.best_value is not None


# -- the chaos harness (tests/test_chaos.py) ----------------------------------


MIN = StudyDirection.MINIMIZE

# a pruner spec that never prunes — exercises the fused path under chaos
NOP_SPEC = {"name": "median", "n_startup_trials": 10_000}


class TestFaultInjector:
    def test_counted_rules_fire_in_order_then_disarm(self):
        fi = FaultInjector(seed=0)
        fi.drop_next_frames(1).blackhole_next(1).delay_next(1, 0.5)
        assert fi.on_frame() == "drop_conn"
        assert fi.on_frame() == "blackhole"
        assert fi.on_frame() == ("delay", 0.5)
        assert fi.on_frame() is None
        assert not fi.armed

    def test_accept_rule(self):
        fi = FaultInjector(seed=0)
        fi.drop_connects(2)
        assert fi.on_accept() and fi.on_accept() and not fi.on_accept()
        assert fi.stats["dropped_connects"] == 2

    def test_random_drop_is_deterministic_under_seed(self):
        a, b = FaultInjector(seed=123).random_drop(0.3), FaultInjector(seed=123).random_drop(0.3)
        seq_a = [a.on_frame() for _ in range(50)]
        seq_b = [b.on_frame() for _ in range(50)]
        assert seq_a == seq_b
        assert "drop_conn" in seq_a and None in seq_a

    def test_clear_disarms_everything(self):
        fi = FaultInjector(seed=0)
        fi.drop_next_frames(5).blackhole_next(5).delay_next(5).drop_connects(5)
        fi.random_drop(1.0)
        fi.clear()
        assert not fi.armed
        assert fi.on_frame() is None and not fi.on_accept()

    def test_counted_rules_take_precedence_over_random(self):
        fi = FaultInjector(seed=0)
        fi.random_drop(1.0)
        fi.blackhole_next(1)
        assert fi.on_frame() == "blackhole"
        assert fi.on_frame() == "drop_conn"  # random takes over after


class TestInjectedFaults:
    def test_blackhole_executes_once_via_dedup(self):
        """The nastiest failure: a tell that executed but whose response was
        swallowed.  The retransmitted frame carries the same op id, so the
        server answers from its dedup window — exactly one execution."""
        fi = FaultInjector(seed=0)
        with StorageServer(InMemoryStorage(), journal=True, fault_injector=fi) as srv:
            st = RemoteStorage(srv.url, timeout=1.0, retries=10, rpc_deadline=15.0)
            sid = st.create_new_study([MIN], "bh")
            tid = st.create_new_trial(sid)
            fi.blackhole_next(1)
            assert st.set_trial_state_values(tid, TrialState.COMPLETE, [1.0]) is True
            trials = srv.storage.get_all_trials(0)
            assert len(trials) == 1 and trials[0].state == TrialState.COMPLETE
            assert srv.get_server_metrics()["dedup_hits"] >= 1
            # the journal recorded the op exactly once
            ops = [m for _, _, m, _ in srv.journal.since(0)]
            assert ops.count("set_trial_state_values") == 1

    def test_drop_conn_loses_request_before_execution(self):
        fi = FaultInjector(seed=0)
        with StorageServer(InMemoryStorage(), fault_injector=fi) as srv:
            st = RemoteStorage(srv.url, timeout=2.0, retries=10, rpc_deadline=15.0)
            sid = st.create_new_study([MIN], "dc")
            fi.drop_next_frames(1)
            assert st.get_n_trials(sid) == 0  # idempotent read retried
            assert fi.stats["dropped_frames"] == 1

    def test_dropped_connects_then_recover(self):
        fi = FaultInjector(seed=0)
        with StorageServer(InMemoryStorage(), fault_injector=fi) as srv:
            st = RemoteStorage(srv.url, timeout=2.0, retries=10, rpc_deadline=15.0)
            st.close()  # force the next call to dial fresh
            fi.drop_connects(2)
            assert st._call("ping") == "pong"
            assert fi.stats["dropped_connects"] == 2

    def test_delay_holds_response(self):
        fi = FaultInjector(seed=0)
        with StorageServer(InMemoryStorage(), fault_injector=fi) as srv:
            st = RemoteStorage(srv.url, timeout=5.0)
            sid = st.create_new_study([MIN], "dl")
            fi.delay_next(1, 0.3)
            t0 = time.monotonic()
            st.get_n_trials(sid)
            assert time.monotonic() - t0 >= 0.25


class TestReplication:
    def test_replica_tails_and_matches_ids(self):
        with StorageServer(InMemoryStorage(), journal=True) as prim:
            rep = StorageServer(InMemoryStorage(), replicate_from=prim.url).start()
            try:
                st = RemoteStorage(prim.url)
                sid = st.create_new_study([MIN], "rep")
                tids = st.create_new_trials(sid, 3)
                st.set_trial_param(tids[0], "x", 0.5, FloatDistribution(0, 1))
                st.set_trial_state_values(tids[0], TrialState.COMPLETE, [1.0])
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    if rep.replication_state()["applied_seq"] >= prim.replication_state()["seq"]:
                        break
                    time.sleep(0.01)
                mirror = rep.storage.get_all_trials(0)
                original = prim.storage.get_all_trials(0)
                assert [t.trial_id for t in mirror] == [t.trial_id for t in original]
                assert [t.state for t in mirror] == [t.state for t in original]
                assert mirror[0].params == original[0].params
            finally:
                rep.stop()

    def test_replica_refuses_writes_until_promoted(self):
        with StorageServer(InMemoryStorage(), journal=True) as prim:
            rep = StorageServer(InMemoryStorage(), replicate_from=prim.url).start()
            try:
                RemoteStorage(prim.url).create_new_study([MIN], "ro")
                # explicit single-node URL to the replica: reads fine
                direct = RemoteStorage(
                    rep.url, retries=2, rpc_deadline=5.0, timeout=2.0
                )
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline and not direct.get_all_studies():
                    time.sleep(0.01)
                assert [s.study_name for s in direct.get_all_studies()] == ["ro"]
                with pytest.raises(StorageUnavailableError):
                    direct.create_new_study([MIN], "nope")
                rep.promote()
                assert rep.role == "primary" and rep.epoch == 2
                direct2 = RemoteStorage(rep.url)
                assert direct2.create_new_study([MIN], "yes") >= 0
            finally:
                rep.stop()

    def test_promote_is_idempotent(self):
        with StorageServer(InMemoryStorage(), journal=True) as prim:
            rep = StorageServer(InMemoryStorage(), replicate_from=prim.url).start()
            try:
                rep.promote()
                e1 = rep.epoch
                rep.promote()
                assert rep.epoch == e1  # second promote is a no-op
            finally:
                rep.stop()

    def test_kill_abandons_held_responses(self):
        """A write held for the replica's ack is never acknowledged by a
        primary that crashes: closing its sockets must not release the held
        response to a client whose socket has not been closed yet (the lost
        tell of the failover storm)."""
        with StorageServer(InMemoryStorage(), journal=True, sync_replication=True) as prim:
            rep = StorageServer(InMemoryStorage(), replicate_from=prim.url).start()
            gate = threading.Event()
            try:
                st = RemoteStorage(prim.url, timeout=2.0, retries=1, rpc_deadline=5.0)
                sid = st.create_new_study([MIN], "held")
                tid = st.create_new_trial(sid)
                deadline = time.monotonic() + 10  # subscribed and caught up
                while rep.replication_state()["applied_seq"] < prim.replication_state()["seq"]:
                    assert time.monotonic() < deadline, "the replica never caught up"
                    time.sleep(0.01)
                tail = rep._tail
                apply = tail._apply

                def gated_apply(*args):
                    gate.wait(30)
                    return apply(*args)

                tail._apply = gated_apply  # the replica receives but never acks
                told = []

                def tell():
                    try:
                        told.append(st.set_trial_state_values(tid, TrialState.COMPLETE, [1.0]))
                    except Exception as e:
                        told.append(e)

                teller = threading.Thread(target=tell)
                teller.start()
                deadline = time.monotonic() + 10
                while prim.get_server_metrics()["replication"]["held_responses"] < 1:
                    assert time.monotonic() < deadline, "the write was never held"
                    time.sleep(0.01)
                node = prim._server  # the crashed node's reactor, read after the kill
                prim.kill()
                teller.join(timeout=30)
                assert node.server_metrics()["replication"]["degraded"] == 0
                assert len(told) == 1 and told[0] is not True, told
                assert isinstance(told[0], (RetryableStorageError, StorageUnavailableError))
            finally:
                gate.set()
                rep.stop()

    def test_client_fails_over_to_promoted_replica(self):
        cc = ChaosCluster(n_shards=1, replicated=(0,), seed=1)
        try:
            st = cc.storage(timeout=2.0, retries=40, rpc_deadline=30.0, backoff_seed=3)
            sid = st.create_new_study([MIN], "fo")
            tid = st.create_new_trial(sid)
            cc.wait_replicated(0)
            cc.kill_primary(0)
            cc.promote_replica(0)
            assert st.set_trial_state_values(tid, TrialState.COMPLETE, [4.0])
            trials = st.get_all_trials(sid)
            assert len(trials) == 1 and trials[0].values == [4.0]
        finally:
            cc.stop()

    def test_fenced_old_primary_is_refused(self):
        cc = ChaosCluster(n_shards=1, replicated=(0,), seed=1)
        try:
            st = cc.storage(timeout=2.0, retries=40, rpc_deadline=30.0, backoff_seed=3)
            sid = st.create_new_study([MIN], "fence")
            cc.wait_replicated(0)
            cc.kill_primary(0)
            cc.promote_replica(0)
            assert st.get_n_trials(sid) == 0  # failed over
            # the dead primary restarts with its stale epoch: cluster-aware
            # clients must keep talking to the promoted replica
            cc.restart_primary(0)
            tid = st.create_new_trial(sid)
            assert st.set_trial_state_values(tid, TrialState.COMPLETE, [1.0])
            # the write landed on the promoted node, not the stale restart
            assert len(cc.replicas[0].storage.get_all_trials(0)) == 1
            assert len(cc.primaries[0].storage.get_all_trials(0)) == 0
        finally:
            cc.stop()


class TestReclaim:
    def test_server_sweep_fails_stale_running_trials(self):
        with StorageServer(
            InMemoryStorage(), reclaim_grace=0.2, reclaim_interval=0.05
        ) as srv:
            st = RemoteStorage(srv.url)
            sid = st.create_new_study([MIN], "sweep")
            tid = st.create_new_trial(sid)  # RUNNING
            st.record_heartbeat(tid)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                if st.get_trial(tid).state == TrialState.FAIL:
                    break
                time.sleep(0.05)
            assert st.get_trial(tid).state == TrialState.FAIL
            assert srv.get_server_metrics()["reclaimed_trials"] >= 1

    def test_server_sweep_requeues_behind_flag(self):
        with StorageServer(
            InMemoryStorage(), reclaim_grace=0.2, reclaim_requeue=True,
            reclaim_interval=0.05,
        ) as srv:
            st = RemoteStorage(srv.url)
            sid = st.create_new_study([MIN], "requeue")
            tid = st.create_new_trial(sid)
            st.record_heartbeat(tid)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                if st.get_trial(tid).state == TrialState.WAITING:
                    break
                time.sleep(0.05)
            assert st.get_trial(tid).state == TrialState.WAITING
            # the requeued trial is claimable again (its heartbeat clock was
            # re-armed, so it is not instantly re-swept as stale)
            assert st.set_trial_state_values(tid, TrialState.RUNNING)

    def test_reclaim_ops_are_journaled_for_replicas(self):
        with StorageServer(
            InMemoryStorage(), journal=True, reclaim_grace=0.2, reclaim_interval=0.05
        ) as prim:
            rep = StorageServer(InMemoryStorage(), replicate_from=prim.url).start()
            try:
                st = RemoteStorage(prim.url)
                sid = st.create_new_study([MIN], "rj")
                tid = st.create_new_trial(sid)
                st.record_heartbeat(tid)
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    mirror = rep.storage.get_all_trials(0) if rep.storage.get_all_studies() else []
                    if mirror and mirror[0].state == TrialState.FAIL:
                        break
                    time.sleep(0.05)
                assert rep.storage.get_all_trials(0)[0].state == TrialState.FAIL
            finally:
                rep.stop()


class TestJournalCrashRecovery:
    def test_torn_tail_is_ignored_then_truncated_on_append(self, tmp_path):
        path = str(tmp_path / "study.journal")
        st = JournalStorage(path)
        sid = st.create_new_study([MIN], "crash")
        tid = st.create_new_trial(sid)
        # a worker dies mid-append: half a JSON line, no newline
        with open(path, "a") as f:
            f.write('{"op":"set_state","trial_id":0,"TORN')
        # readers never see the torn line
        st2 = JournalStorage(path)
        assert st2.get_trial(tid).state == TrialState.RUNNING
        # the next append repairs the tail (truncate + warn) before writing
        with pytest.warns(RuntimeWarning, match="torn final line"):
            st2.set_trial_state_values(tid, TrialState.COMPLETE, [1.0])
        with open(path, "rb") as f:
            data = f.read()
        assert data.endswith(b"\n") and b"TORN" not in data
        # a fresh replay sees a clean history
        st3 = JournalStorage(path)
        assert st3.get_trial(tid).state == TrialState.COMPLETE
        assert st3.get_trial(tid).values == [1.0]

    def test_corrupt_interior_line_warns_and_skips(self, tmp_path):
        path = str(tmp_path / "corrupt.journal")
        st = JournalStorage(path)
        st.create_new_study([MIN], "c0")
        with open(path, "a") as f:
            f.write("NOT JSON AT ALL\n")
        with pytest.warns(RuntimeWarning, match="corrupt line"):
            st.create_new_study([MIN], "c1")
        with pytest.warns(RuntimeWarning, match="corrupt line"):
            st2 = JournalStorage(path)
        assert {s.study_name for s in st2.get_all_studies()} == {"c0", "c1"}

    def test_fsync_flag_and_url_form(self, tmp_path):
        path = str(tmp_path / "nf.journal")
        st = JournalStorage(f"journal://{path}?fsync=0")
        assert st._fsync is False
        sid = st.create_new_study([MIN], "nf")
        assert JournalStorage(path).get_study_id_from_name("nf") == sid
        assert JournalStorage(path)._fsync is True  # default stays durable


class TestCachedFlushOutage:
    def test_buffered_ops_survive_a_server_bounce(self):
        srv = StorageServer(InMemoryStorage()).start()
        try:
            st = CachedStorage(
                RemoteStorage(srv.url, timeout=1.0, retries=2, rpc_deadline=3.0)
            )
            sid = st.create_new_study([MIN], "bounce")
            tid = st.create_new_trial(sid)  # RUNNING -> owned, writes buffer
            st.set_trial_user_attr(tid, "k1", "v1")
            st.set_trial_user_attr(tid, "k2", "v2")
            assert st.pending_ops == 2
            srv.kill()
            with pytest.raises(RetryableStorageError):
                st.flush()
            # nothing was dropped: the buffer survives the failed flush
            assert st.pending_ops == 2
            srv.restart()
            st.flush()
            assert st.pending_ops == 0
            attrs = srv.storage.get_trial(0).user_attrs
            assert attrs == {"k1": "v1", "k2": "v2"}
        finally:
            srv.stop()

    def test_close_during_outage_does_not_raise(self):
        srv = StorageServer(InMemoryStorage()).start()
        st = CachedStorage(
            RemoteStorage(srv.url, timeout=1.0, retries=1, rpc_deadline=2.0)
        )
        sid = st.create_new_study([MIN], "dead")
        tid = st.create_new_trial(sid)
        st.set_trial_user_attr(tid, "k", "v")
        srv.kill()
        st.close()  # buffered op is unflushable; close must still succeed


# -- the acceptance storm -----------------------------------------------------


def _chaos_worker(storage, sid, results, idx, per_worker, on_tell=None):
    try:
        for k in range(per_worker):
            tid = storage.create_new_trial(sid)
            storage.set_trial_param(tid, "x", 0.5, FloatDistribution(0, 1))
            pruned = storage.report_and_prune(
                sid, tid, 0, float(idx), NOP_SPEC, MIN
            )
            assert pruned is False
            value = idx * 1000.0 + k  # deterministic, unique per (worker, k)
            assert storage.set_trial_state_values(tid, TrialState.COMPLETE, [value])
            if on_tell is not None:
                on_tell()
        results[idx] = None
    except Exception as e:  # pragma: no cover - surfaced by asserts below
        results[idx] = e


def _run_storm(kill_mid_run, n_workers=32, per_worker=2, seed=7):
    """Run the seeded storm on a 2-shard cluster (shard of study 'storm'
    replicated, every node's fault injector seeded); optionally kill that
    shard's primary mid-run and promote its replica.  The kill waits on an
    event that the tell which reaches three quarters of the storm sets, and
    the promotion follows the kill at once: no step waits on a sleep.
    Returns (values multiset, states, best, events) read from the node that
    ends up serving the study."""
    storm_shard = HashRing(2).lookup("storm")
    cc = ChaosCluster(n_shards=2, replicated=(storm_shard,), seed=seed)
    try:
        st = cc.storage(
            timeout=2.0, retries=200, rpc_deadline=60.0, backoff_seed=seed
        )
        sid = st.create_new_study([MIN], "storm")
        assert sid % 2 == storm_shard

        killer = None
        on_tell = None
        if kill_mid_run:
            trigger = (n_workers * per_worker * 3) // 4  # mid-storm
            lock = threading.Lock()
            told = [0]
            reached = threading.Event()

            def on_tell():
                with lock:
                    told[0] += 1
                    if told[0] == trigger:
                        reached.set()

            def _killer():
                assert reached.wait(timeout=120)
                cc.kill_primary(storm_shard)
                cc.promote_replica(storm_shard)

            killer = threading.Thread(target=_killer)
            killer.start()

        results = [RuntimeError("never ran")] * n_workers
        threads = [
            threading.Thread(
                target=_chaos_worker, args=(st, sid, results, i, per_worker, on_tell)
            )
            for i in range(n_workers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        if killer is not None:
            killer.join(timeout=30)
            assert not killer.is_alive()
        errors = [e for e in results if e is not None]
        assert not errors, errors[:3]

        # read the surviving node's backend directly (bit-exact, no client)
        node = cc.replicas[storm_shard] if kill_mid_run else cc.primaries[storm_shard]
        local_sid = sid // 2
        trials = node.storage.get_all_trials(local_sid)
        values = sorted(t.values[0] for t in trials)
        states = [t.state for t in trials]
        best = min(values)
        events = node.storage.get_trial_events(local_sid)
        return values, states, best, events
    finally:
        cc.stop()


class TestChaosStormAcceptance:
    @pytest.mark.slow
    def test_failover_storm_zero_lost_tells(self):
        """The reference's storm at 32 workers x 2 tells (it runs 100): the
        primary dies after the 48th acknowledged tell, and every assertion
        is the reference's."""
        n_workers, per_worker = 32, 2
        expected_values = sorted(
            float(i * 1000 + k) for i in range(n_workers) for k in range(per_worker)
        )

        chaos_values, chaos_states, chaos_best, chaos_events = _run_storm(
            kill_mid_run=True, n_workers=n_workers, per_worker=per_worker
        )
        calm_values, calm_states, calm_best, _ = _run_storm(
            kill_mid_run=False, n_workers=n_workers, per_worker=per_worker
        )

        # zero lost tells: every deterministic value is present exactly once
        assert chaos_values == expected_values
        # no double executions: trial count is exact, all COMPLETE
        assert len(chaos_states) == n_workers * per_worker
        assert all(s == TrialState.COMPLETE for s in chaos_states)
        # bit-identical to the uninterrupted run
        assert chaos_values == calm_values
        assert chaos_states == calm_states
        assert chaos_best == calm_best
        # exactly one COMPLETED lifecycle event per trial on the survivor
        completed = [
            n for kind, n in zip(chaos_events["kind"], chaos_events["number"])
            if kind == telemetry.EV_COMPLETED
        ]
        assert sorted(completed) == list(range(n_workers * per_worker))
