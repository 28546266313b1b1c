"""The port's storage server and client, held to the reference.

* The reference's own suites, each test under its reference name: server
  round trips, claim races, cache consistency, the fused report / prune
  RPC, auth tokens and an end-to-end served distributed study (``tests/
  test_remote_storage.py``); the binary codec, hello negotiation and
  back-compat, frame fuzzing, auth scopes, TLS and the mini worker storm on
  both protocols (``tests/test_wire_protocol.py``); the trial event trace,
  server metrics and client spans over the wire (``tests/
  test_telemetry.py``).  Every test of the first file runs on both wire
  protocols.
* Clients and servers cross between the packages: a port client against a
  ``repro`` server and a ``repro`` client against a port server, on
  protocols 1 and 2, make the same seeded study as in-memory storage.
* One frame per report: ``report`` + ``should_prune`` over ``remote://``
  (bare or cached, v1 or v2) is one round trip, counted by wrapping
  ``RemoteStorage._roundtrip``.
"""

import contextlib
import datetime
import json
import multiprocessing
import socket
import struct
import subprocess
import threading

import numpy as np
import pytest

import repro_torch.core as hpo
from repro_torch.core import telemetry
from repro_torch.core.distributions import (
    CategoricalDistribution,
    FloatDistribution,
    IntDistribution,
)
from repro_torch.core.exceptions import RetryableStorageError
from repro_torch.core.frozen import FrozenTrial, StudyDirection, TrialState
from repro_torch.core.records import IntermediateValueStore, ObservationStore
from repro_torch.core.storage import (
    CachedStorage,
    InMemoryStorage,
    RemoteStorage,
    ShardedStorage,
    SQLiteStorage,
    StorageServer,
    get_storage,
    get_trials_since,
)
from repro_torch.core.storage.serde import (
    BINARY_MAGIC,
    bdumps,
    bjoin,
    bloads,
    pack,
    unpack,
)
from repro_torch.core.storage.server import MAX_FRAME_BYTES, recv_frame, send_frame
from repro_torch.core.telemetry import _iter_event_tuples


# -- the server and client (tests/test_remote_storage.py) ---------------------


# every test in this module runs against both wire protocols: v1 pins the
# server to legacy JSON frames (clients transparently fall back), v2
# negotiates the binary framing via hello
@pytest.fixture(params=[1, 2], ids=["v1", "v2"])
def server(request):
    srv = StorageServer(InMemoryStorage(), max_protocol=request.param).start()
    yield srv
    srv.stop()


@pytest.fixture
def remote(server):
    return RemoteStorage(server.url)


class TestProtocolRoundTrip:
    """Every BaseStorage method crosses the wire and comes back intact."""

    def test_study_methods(self, remote):
        sid = remote.create_new_study([StudyDirection.MINIMIZE, StudyDirection.MAXIMIZE], "s1")
        assert remote.get_study_id_from_name("s1") == sid
        assert remote.get_study_name_from_id(sid) == "s1"
        assert remote.get_study_directions(sid) == [
            StudyDirection.MINIMIZE, StudyDirection.MAXIMIZE,
        ]
        remote.set_study_user_attr(sid, "u", {"nested": [1, "two"]})
        remote.set_study_system_attr(sid, "s", 3.5)
        assert remote.get_study_user_attrs(sid) == {"u": {"nested": [1, "two"]}}
        assert remote.get_study_system_attrs(sid) == {"s": 3.5}
        summaries = remote.get_all_studies()
        assert len(summaries) == 1 and summaries[0].study_name == "s1"
        with pytest.raises(hpo.DuplicatedStudyError):
            remote.create_new_study([StudyDirection.MINIMIZE], "s1")
        remote.delete_study(sid)
        with pytest.raises(KeyError):
            remote.get_study_id_from_name("s1")

    def test_trial_methods(self, remote):
        sid = remote.create_new_study([StudyDirection.MINIMIZE], "s")
        tid = remote.create_new_trial(sid)
        remote.set_trial_param(tid, "f", 0.25, FloatDistribution(0, 1, log=False))
        remote.set_trial_param(tid, "i", 3.0, IntDistribution(1, 10))
        remote.set_trial_param(tid, "c", 1.0, CategoricalDistribution([None, "b", 4]))
        remote.set_trial_intermediate_value(tid, 1, 5.0)
        remote.set_trial_intermediate_value(tid, 2, 4.0)
        remote.set_trial_user_attr(tid, "k", [1, 2])
        remote.set_trial_system_attr(tid, "sys", "v")
        assert remote.set_trial_state_values(tid, TrialState.COMPLETE, [0.5])
        t = remote.get_trial(tid)
        assert t.params == {"f": 0.25, "i": 3, "c": "b"}
        assert isinstance(t.distributions["c"], CategoricalDistribution)
        assert t.intermediate_values == {1: 5.0, 2: 4.0}
        assert t.user_attrs == {"k": [1, 2]}
        assert t.system_attrs == {"sys": "v"}
        assert t.values == [0.5] and t.state == TrialState.COMPLETE
        assert t.datetime_start is not None and t.datetime_complete is not None
        assert remote.get_trial_id_from_study_and_number(sid, t.number) == tid
        assert remote.get_n_trials(sid) == 1
        assert remote.get_n_trials(sid, states=(TrialState.FAIL,)) == 0
        # server-side errors surface as the right client-side exception types
        with pytest.raises(KeyError):
            remote.get_trial(tid + 999)
        with pytest.raises(RuntimeError):
            remote.set_trial_param(tid, "f", 0.1, FloatDistribution(0, 1))

    def test_template_trial_and_states_filter(self, remote):
        sid = remote.create_new_study([StudyDirection.MINIMIZE], "s")
        template = FrozenTrial(
            number=-1, state=TrialState.WAITING, system_attrs={"fixed_params": {"x": 1.0}},
        )
        remote.create_new_trial(sid, template_trial=template)
        remote.create_new_trial(sid)  # RUNNING
        waiting = remote.get_all_trials(sid, states=(TrialState.WAITING,))
        assert len(waiting) == 1
        assert waiting[0].system_attrs["fixed_params"] == {"x": 1.0}

    def test_heartbeat_failover(self, remote):
        sid = remote.create_new_study([StudyDirection.MINIMIZE], "s")
        tid = remote.create_new_trial(sid)
        remote.record_heartbeat(tid)
        assert remote.get_stale_trial_ids(sid, grace_seconds=3600) == []
        assert remote.fail_stale_trials(sid, grace_seconds=-1) == [tid]
        assert remote.get_trial(tid).state == TrialState.FAIL

    def test_batched_requests(self, remote):
        sid = remote.create_new_study([StudyDirection.MINIMIZE], "s")
        tid = remote.create_new_trial(sid)
        results = remote.call_batch(
            [
                ("set_trial_param", (tid, "x", 0.5, FloatDistribution(0, 1))),
                ("set_trial_user_attr", (tid, "a", 1)),
                ("get_trial", (tid,)),
            ]
        )
        assert results[2].params == {"x": 0.5}
        assert results[2].user_attrs == {"a": 1}

    def test_reconnect_after_dropped_connection(self, remote):
        sid = remote.create_new_study([StudyDirection.MINIMIZE], "s")
        # sever this thread's socket out from under the client
        remote._local.sock.close()
        remote._local.sock = None
        assert remote.get_study_id_from_name("s") == sid

    def test_bad_url_fails_fast(self):
        with pytest.raises(RetryableStorageError):
            RemoteStorage("remote://127.0.0.1:1", retries=1)
        with pytest.raises(ValueError):
            RemoteStorage("remote://noport")


class TestClaimRace:
    def test_exactly_one_client_wins_waiting_claim(self, server):
        c1 = RemoteStorage(server.url)
        c2 = RemoteStorage(server.url)
        sid = c1.create_new_study([StudyDirection.MINIMIZE], "s")
        results = []
        for _ in range(10):
            tid = c1.create_new_trial(
                sid, template_trial=FrozenTrial(number=-1, state=TrialState.WAITING)
            )
            barrier = threading.Barrier(2)
            wins = []

            def claim(client):
                barrier.wait()
                wins.append(client.set_trial_state_values(tid, TrialState.RUNNING))

            ts = [threading.Thread(target=claim, args=(c,)) for c in (c1, c2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            results.append(sorted(wins))
        assert all(r == [False, True] for r in results), results

    def test_cached_clients_claim_through_backend(self, server):
        """The cache must not short-circuit the compare-and-set."""
        c1 = CachedStorage(RemoteStorage(server.url))
        c2 = CachedStorage(RemoteStorage(server.url))
        sid = c1.create_new_study([StudyDirection.MINIMIZE], "s")
        tid = c1.create_new_trial(
            sid, template_trial=FrozenTrial(number=-1, state=TrialState.WAITING)
        )
        for c in (c1, c2):  # both observe the WAITING trial
            assert [t.trial_id for t in c.get_all_trials(sid, states=(TrialState.WAITING,))] == [tid]
        wins = [c.set_trial_state_values(tid, TrialState.RUNNING) for c in (c1, c2)]
        assert sorted(wins) == [False, True]


class TestSinceFetch:
    @pytest.mark.parametrize("kind", ["memory", "sqlite", "journal", "remote"])
    def test_since_matches_filtered_full_read(self, kind, tmp_path, server):
        if kind == "memory":
            st = InMemoryStorage()
        elif kind == "sqlite":
            st = SQLiteStorage(str(tmp_path / "s.db"))
        elif kind == "journal":
            st = hpo.JournalStorage(str(tmp_path / "s.journal"))
        else:
            st = RemoteStorage(server.url)
        sid = st.create_new_study([StudyDirection.MINIMIZE], "s")
        for i in range(7):
            tid = st.create_new_trial(sid)
            if i < 4:
                st.set_trial_state_values(tid, TrialState.COMPLETE, [float(i)])
        full = st.get_all_trials(sid, deepcopy=False)
        suffix = st.get_all_trials(sid, deepcopy=False, since=4)
        assert [t.number for t in suffix] == [4, 5, 6]
        assert [t.number for t in full] == list(range(7))
        # helper falls back cleanly for backends without native support
        assert [t.number for t in get_trials_since(st, sid, 5, deepcopy=False)] == [5, 6]

    def test_cached_storage_stops_refetching_finished_trials(self, server):
        probe = RemoteStorage(server.url)
        cs = CachedStorage(RemoteStorage(server.url))
        sid = cs.create_new_study([StudyDirection.MINIMIZE], "s")
        for i in range(20):
            tid = cs.create_new_trial(sid)
            cs.set_trial_state_values(tid, TrialState.COMPLETE, [float(i)])
        cs.get_all_trials(sid, deepcopy=False)
        assert cs._studies[sid].watermark == 20  # nothing left to re-read
        # and the cache still sees new work from other clients
        other = probe.create_new_trial(sid)
        assert [t.trial_id for t in cs.get_all_trials(sid, states=(TrialState.RUNNING,))] == [other]


class TestCachedConsistency:
    def test_interleaved_writes_match_backend(self, server):
        """Writes through the proxy and direct backend writes interleave;
        the proxy's view must converge to the backend's."""
        backend = RemoteStorage(server.url)
        cs = CachedStorage(RemoteStorage(server.url))
        sid = cs.create_new_study([StudyDirection.MINIMIZE], "s")

        t_own = cs.create_new_trial(sid)  # owned by the proxy
        t_other = backend.create_new_trial(sid)  # some other worker's trial

        cs.set_trial_param(t_own, "x", 0.5, FloatDistribution(0, 1))  # buffered
        backend.set_trial_param(t_other, "x", 0.9, FloatDistribution(0, 1))
        cs.set_trial_intermediate_value(t_own, 1, 3.0)  # forces a flush
        backend.set_trial_state_values(t_other, TrialState.COMPLETE, [9.0])
        cs.set_trial_user_attr(t_own, "note", "mine")  # buffered again
        cs.set_trial_state_values(t_own, TrialState.COMPLETE, [1.0])  # flush + finish

        ours = {t.number: t for t in cs.get_all_trials(sid)}
        theirs = {t.number: t for t in backend.get_all_trials(sid)}
        assert ours.keys() == theirs.keys()
        for n in ours:
            a, b = ours[n], theirs[n]
            assert (a.state, a.values, a.params, a.intermediate_values, a.user_attrs) == (
                b.state, b.values, b.params, b.intermediate_values, b.user_attrs,
            )

    def test_explicit_flush_pushes_buffered_writes(self, server):
        backend = RemoteStorage(server.url)
        cs = CachedStorage(RemoteStorage(server.url))
        sid = cs.create_new_study([StudyDirection.MINIMIZE], "s")
        tid = cs.create_new_trial(sid)
        cs.set_trial_param(tid, "x", 0.5, FloatDistribution(0, 1))
        assert backend.get_trial(tid).params == {}  # write-behind: not yet visible
        cs.flush()
        assert backend.get_trial(tid).params == {"x": 0.5}

    def test_own_reads_never_hit_backend_midtrial(self, server):
        cs = CachedStorage(RemoteStorage(server.url))
        sid = cs.create_new_study([StudyDirection.MINIMIZE], "s")
        tid = cs.create_new_trial(sid)
        cs.set_trial_param(tid, "x", 0.5, FloatDistribution(0, 1))
        t = cs.get_trial(tid)  # served from the local copy, incl. unflushed param
        assert t.params == {"x": 0.5}


class TestStudyOverRemote:
    def test_optimize_through_remote_url(self, server):
        study = hpo.create_study(
            study_name="remote-study", storage=get_storage(server.url), engine="numpy"
        )
        study.optimize(lambda tr: (tr.suggest_float("x", -5, 5) - 1) ** 2, n_trials=15)
        assert len(study.trials) == 15
        assert study.best_value is not None

    def test_optimize_through_cached_remote(self, server):
        storage = get_storage(server.url, cache=True)
        study = hpo.create_study(study_name="cached-study", storage=storage, engine="numpy")
        study.optimize(lambda tr: (tr.suggest_float("x", -5, 5) - 1) ** 2, n_trials=15)
        trials = study.get_trials(states=(TrialState.COMPLETE,))
        assert len(trials) == 15
        # invariants also hold on the server's authoritative copy
        raw = RemoteStorage(server.url)
        sid = raw.get_study_id_from_name("cached-study")
        backend_trials = raw.get_all_trials(sid)
        assert [t.number for t in backend_trials] == list(range(15))
        assert all(t.state == TrialState.COMPLETE for t in backend_trials)
        assert all("x" in t.params for t in backend_trials)


def _served_objective(trial):
    x = trial.suggest_float("x", -5, 5)
    trial.report(x * x, 1)
    return (x - 1) ** 2


class TestServedDistributedStudy:
    def test_run_workers_serve_storage_end_to_end(self, tmp_path):
        """>= 2 worker processes through remote:// (server wrapping SQLite)
        keep the single-process storage invariants: dense trial numbers and
        exactly one claim per enqueued WAITING trial."""
        url = f"sqlite:///{tmp_path}/served.db"
        study = hpo.create_study(study_name="fleet", storage=url, engine="numpy")
        study.enqueue_trial({"x": 1.0})
        study.enqueue_trial({"x": -1.0})
        hpo.run_workers(
            2, url, "fleet", _served_objective,
            n_trials_per_worker=5,
            sampler_factory=lambda: hpo.RandomSampler(),
            serve_storage=True,
        )
        trials = study.get_trials()
        assert len(trials) == 10
        assert [t.number for t in trials] == list(range(10))  # dense numbering
        finished = [t for t in trials if t.state == TrialState.COMPLETE]
        assert len(finished) == 10
        # the two enqueued WAITING trials were each claimed exactly once
        fixed = [t for t in trials if "fixed_params" in t.system_attrs]
        assert sorted(t.params["x"] for t in fixed) == [-1.0, 1.0]
        assert study.best_value == pytest.approx(0.0)


class TestAuthToken:
    """Shared-secret handshake on the remote protocol."""

    @pytest.fixture
    def auth_server(self):
        srv = StorageServer(InMemoryStorage(), auth_token="sekrit").start()
        yield srv
        srv.stop()

    def test_authenticated_client_works(self, auth_server):
        client = RemoteStorage(auth_server.url, auth_token="sekrit")
        sid = client.create_new_study([StudyDirection.MINIMIZE], "a")
        assert client.get_study_id_from_name("a") == sid
        client.close()

    def test_token_in_url(self, auth_server):
        url = f"remote://sekrit@{auth_server.host}:{auth_server.port}"
        client = get_storage(url)
        sid = client.create_new_study([StudyDirection.MINIMIZE], "u")
        assert client.get_study_name_from_id(sid) == "u"
        # the secret never leaks through the url property
        assert "sekrit" not in client.url
        client.close()

    def test_unauthenticated_client_rejected(self, auth_server):
        with pytest.raises(PermissionError):
            RemoteStorage(auth_server.url)

    def test_wrong_token_rejected(self, auth_server):
        with pytest.raises(PermissionError):
            RemoteStorage(auth_server.url, auth_token="wrong")

    def test_token_ignored_when_server_open(self, server):
        # an auth frame against an open server is accepted idempotently
        client = RemoteStorage(server.url, auth_token="whatever")
        client.create_new_study([StudyDirection.MINIMIZE], "open")
        client.close()

    def test_reconnect_reauthenticates(self, auth_server):
        client = RemoteStorage(auth_server.url, auth_token="sekrit")
        sid = client.create_new_study([StudyDirection.MINIMIZE], "r")
        client.close()  # drop this thread's socket; next call re-dials + re-auths
        assert client.get_study_id_from_name("r") == sid
        client.close()


class TestBatchedCreateOverRemote:
    def test_create_new_trials_single_round_trip(self, server, remote):
        sid = remote.create_new_study([StudyDirection.MINIMIZE], "batch")
        tids = remote.create_new_trials(sid, 5)
        assert len(tids) == 5 and len(set(tids)) == 5
        assert remote.get_n_trials(sid) == 5

    def test_ask_n_over_cached_remote(self, remote):
        cached = CachedStorage(remote)
        study = hpo.create_study(
            study_name="askn", storage=cached, sampler=hpo.RandomSampler(seed=0)
        )
        trials = study.ask(4)
        assert len(trials) == 4
        for t in trials:
            t.suggest_float("x", 0, 1)
        study.tell_batch([(t, float(i)) for i, t in enumerate(trials)])
        assert study.observations().n_observations == 4

    def test_remote_revision_counter(self, remote):
        sid = remote.create_new_study([StudyDirection.MINIMIZE], "rev")
        r0 = remote.get_trials_revision(sid)
        remote.create_new_trial(sid)
        assert remote.get_trials_revision(sid) > r0


class TestFusedReportPrune:
    """The fused report_and_prune storage op: one wire frame per
    report+should_prune, with the prune decision computed server-side."""

    def _count_frames(self, remote):
        counter = {"n": 0}
        orig = remote._roundtrip

        def counting(request, payloads):
            counter["n"] += 1
            return orig(request, payloads)

        remote._roundtrip = counting
        return counter

    def test_report_plus_should_prune_is_one_round_trip(self, server):
        remote = RemoteStorage(server.url)
        counter = self._count_frames(remote)
        storage = CachedStorage(remote)
        study = hpo.create_study(
            study_name="fused", storage=storage,
            sampler=hpo.RandomSampler(seed=0),
            pruner=hpo.MedianPruner(n_startup_trials=1),
        )
        # two finished peers so the pruner has a cutoff
        for v in (1.0, 2.0):
            t = study.ask()
            t.suggest_float("x", 0, 1)
            t.report(v, 1)
            study.tell(t, v)
        trial = study.ask()
        trial.suggest_float("x", 0, 1)
        counter["n"] = 0
        trial.report(100.0, 1)       # fused frame: write + decision
        assert trial.should_prune()  # answered from the cached decision
        assert counter["n"] == 1

    def test_fused_decision_uses_server_side_peers(self, server):
        """A second worker's reports are visible to the first worker's fused
        decision without any client-side peer fetch."""
        worker1 = hpo.create_study(
            study_name="peers", storage=RemoteStorage(server.url),
            pruner=hpo.SuccessiveHalvingPruner(1, 2, 0), engine="numpy",
        )
        worker2 = hpo.Study(
            "peers", RemoteStorage(server.url),
            pruner=hpo.SuccessiveHalvingPruner(1, 2, 0), engine="numpy",
        )
        peers = [worker2.ask() for _ in range(4)]
        for p in peers:
            p.report(0.0, 1)
        mine = worker1.ask()
        mine.report(9.0, 1)          # worst of 5 at the rung -> pruned
        assert mine.should_prune()
        best = worker1.ask()
        best.report(-1.0, 1)         # best of 6 -> promoted
        assert not best.should_prune()

    def test_fused_matches_unfused_decision(self, server):
        remote = RemoteStorage(server.url)
        study = hpo.create_study(
            study_name="match", storage=remote,
            pruner=hpo.MedianPruner(n_startup_trials=1), engine="numpy",
        )
        for v in (1.0, 2.0, 3.0):
            t = study.ask()
            t.report(v, 1)
            study.tell(t, v)
        t = study.ask()
        t.report(10.0, 1)
        fused = t.should_prune()
        # client-side evaluation on the same history must agree
        frozen = remote.get_trial(t._trial_id)
        assert fused == study.pruner.prune(study, frozen) is True

    def test_nop_pruner_fuses_without_decision_cost(self, server):
        remote = RemoteStorage(server.url)
        counter = self._count_frames(remote)
        study = hpo.create_study(study_name="nop", storage=remote, engine="numpy")
        trial = study.ask()
        counter["n"] = 0
        trial.report(1.0, 1)
        assert not trial.should_prune()
        assert counter["n"] == 1
        # the value still landed
        assert remote.get_trial(trial._trial_id).intermediate_values == {1: 1.0}

    def test_multi_objective_report_is_one_round_trip(self, server):
        """A multi-objective vector report through the Pareto-aware pruner
        rides the same fused frame: scalarize client-side, one
        report_and_prune RPC, decision cached for should_prune."""
        remote = RemoteStorage(server.url)
        counter = self._count_frames(remote)
        study = hpo.create_study(
            study_name="mo-fused", storage=remote,
            directions=["minimize", "maximize"],
            sampler=hpo.RandomSampler(seed=0),
            pruner=hpo.ParetoPruner(hpo.MedianPruner(n_startup_trials=1)),
        )
        for vals in ([1.0, 5.0], [2.0, 4.0]):
            t = study.ask()
            t.suggest_float("x", 0, 1)
            t.report(vals, 1)
            study.tell(t, vals)
        bad = study.ask()
        bad.suggest_float("x", 0, 1)
        counter["n"] = 0
        bad.report([100.0, -100.0], 1)   # fused frame: scalarized write + decision
        assert bad.should_prune()        # answered from the cached decision
        assert counter["n"] == 1
        good = study.ask()
        good.suggest_float("x", 0, 1)
        counter["n"] = 0
        good.report([0.0, 100.0], 1)
        assert not good.should_prune()
        assert counter["n"] == 1


class TestPrunerSpecCache:
    """The fused report's pruner spec is interned per (connection, study):
    full spec once (__spec_def__), then a short __spec_ref__ — shaving the
    spec bytes off every subsequent report frame."""

    def _record_frames(self, remote):
        frames = []
        orig = remote._roundtrip

        def recording(request, payloads):
            result = orig(request, payloads)
            # the encoded wire payload is cached per protocol by the call
            frames.append(max(payloads.values(), key=len) if payloads else b"")
            return result

        remote._roundtrip = recording
        return frames

    def _fused_study(self, server, name):
        remote = RemoteStorage(server.url)
        study = hpo.create_study(
            study_name=name, storage=remote,
            sampler=hpo.RandomSampler(seed=0),
            pruner=hpo.MedianPruner(n_startup_trials=1),
        )
        for v in (1.0, 2.0):
            t = study.ask()
            t.report(v, 1)
            study.tell(t, v)
        return remote, study

    def test_second_report_frame_is_smaller(self, server):
        remote, study = self._fused_study(server, "bytes")
        trial = study.ask()
        remote.close()  # fresh connection: the seeding reports interned already
        frames = self._record_frames(remote)
        trial.report(5.0, 1)
        trial.report(5.0, 2)
        assert len(frames) == 2
        first, second = (len(f) for f in frames)
        # the ref frame drops the whole spec payload: it must be strictly
        # smaller, by at least the size of the serialized MedianPruner spec
        assert second < first - 20, (first, second)
        assert b"__spec_def__" in frames[0] and b"__spec_ref__" not in frames[0]
        assert b"__spec_ref__" in frames[1] and b"median" not in frames[1]

    def test_spec_sent_once_per_connection_and_study(self, server):
        remote, study = self._fused_study(server, "once")
        trials = [study.ask() for _ in range(3)]
        remote.close()  # fresh connection so the def frame is observable
        frames = self._record_frames(remote)
        for step in (1, 2, 3):
            for t in trials:
                t.report(float(step), step)
        defs = [f for f in frames if b"__spec_def__" in f]
        refs = [f for f in frames if b"__spec_ref__" in f]
        assert len(defs) == 1 and len(refs) == len(frames) - 1

    def test_decisions_identical_through_spec_cache(self, server):
        remote, study = self._fused_study(server, "same")
        bad = study.ask()
        bad.report(100.0, 1)   # def frame
        assert bad.should_prune()
        worse = study.ask()
        worse.report(200.0, 1)  # ref frame: same pruner, same peers
        assert worse.should_prune()
        good = study.ask()
        good.report(-1.0, 1)    # ref frame, best value -> promoted
        assert not good.should_prune()

    def test_reconnect_resends_spec_def(self, server):
        remote, study = self._fused_study(server, "reconnect")
        trial = study.ask()
        trial.report(1.5, 1)  # populate the per-connection cache
        remote.close()        # drop socket: both caches die with it
        frames = self._record_frames(remote)
        trial.report(1.5, 2)
        assert any(b"__spec_def__" in f for f in frames)
        assert remote.get_trial(trial._trial_id).intermediate_values[2] == 1.5

    def test_stale_ref_is_resent_as_def(self, server):
        """A ref whose server-side cache entry is gone (torn between encode
        and send) is retried once with the full spec."""
        remote, study = self._fused_study(server, "stale")
        trial = study.ask()
        trial.report(1.0, 1)
        # poison: pretend the spec is cached although this is a new socket
        remote.close()
        remote._local.spec_ids = {
            (study._study_id, '{"n_min_trials": 1, "n_startup_trials": 1, '
             '"n_warmup_steps": 0, "name": "median"}'): 7
        }
        trial.report(2.0, 2)  # ref -> server miss -> auto def resend
        assert remote.get_trial(trial._trial_id).intermediate_values[2] == 2.0


# -- binary codec -------------------------------------------------------------


class TestBinaryCodec:
    def test_scalar_roundtrip(self):
        for v in (None, True, False, 0, -1, 2**40, -(2**40), 1.5, float("inf"),
                  "", "héllo", b"raw\x00bytes", 2**100, -(2**100)):
            got = bloads(bdumps(v))
            assert got == v and type(got) is type(v), v

    def test_nan_roundtrip(self):
        got = bloads(bdumps(float("nan")))
        assert isinstance(got, float) and got != got

    def test_containers_match_json_codec(self):
        # dict int keys are stringified exactly like the JSON path
        obj = {"a": [1, 2.5, None, {"n": [True]}], 3: "three", "t": (1, 2)}
        binary = bloads(bdumps(obj))
        jsonic = unpack(json.loads(json.dumps(pack(obj))))
        assert binary == jsonic
        assert binary["3"] == "three" and binary["t"] == [1, 2]

    def test_ndarray_roundtrip(self):
        for arr in (
            np.arange(6, dtype=np.int64),
            np.arange(6, dtype=np.float64).reshape(2, 3),
            np.array([], dtype=np.float32),
            np.array([[True, False]]),
            np.arange(8, dtype=np.int8)[::2],  # non-contiguous input
        ):
            got = bloads(bdumps(arr))
            assert isinstance(got, np.ndarray)
            assert got.dtype == arr.dtype and got.shape == arr.shape
            assert np.array_equal(got, arr)

    def test_object_array_rejected(self):
        with pytest.raises(TypeError):
            bdumps(np.array([object()]))

    def test_frozen_trial_roundtrip_matches_json_codec(self):
        t = FrozenTrial(
            number=3,
            state=TrialState.PRUNED,
            values=[1.5, -2.0],
            params={"x": 0.25, "c": None},
            distributions={
                "x": FloatDistribution(0, 1, log=False),
                "c": CategoricalDistribution([None, "b", 4]),
            },
            intermediate_values={0: 1.0, 7: float("nan")},
            user_attrs={"k": [1, {"deep": "v"}]},
            system_attrs={"fixed_params": {"x": 0.25}},
            trial_id=17,
            datetime_start=datetime.datetime(2026, 8, 8, 12, 0, 1, 5),
            datetime_complete=datetime.datetime(2026, 8, 8, 12, 0, 2),
        )
        for got in (bloads(bdumps(t)), unpack(json.loads(json.dumps(pack(t))))):
            assert got.number == 3 and got.state is TrialState.PRUNED
            assert got.values == [1.5, -2.0]
            assert got.params == t.params
            assert isinstance(got.distributions["x"], FloatDistribution)
            assert sorted(got.intermediate_values) == [0, 7]
            assert got.intermediate_values[7] != got.intermediate_values[7]
            assert got.user_attrs == t.user_attrs
            assert got.trial_id == 17
            assert got.datetime_start == t.datetime_start
            assert got.datetime_complete == t.datetime_complete

    def test_enum_types_preserved(self):
        got = bloads(bdumps([TrialState.COMPLETE, StudyDirection.MAXIMIZE]))
        assert got[0] is TrialState.COMPLETE
        assert got[1] is StudyDirection.MAXIMIZE

    def test_bjoin_decodes_as_list(self):
        blobs = [bdumps(i) for i in range(5)]
        assert bloads(bjoin(blobs)) == [0, 1, 2, 3, 4]

    @pytest.mark.parametrize(
        "payload",
        [
            b"",                              # empty
            bytes([0xEE]),                    # unknown tag
            bytes([0x05]) + b"\x00\x00\x01",  # truncated str length
            bytes([0x05]) + struct.pack(">I", 100) + b"short",  # str overruns
            bytes([0x07]) + struct.pack(">I", 3) + bdumps(1),   # list underruns
            bytes([0x09]) + b"\x03<f8",       # truncated ndarray header
            bdumps(1) + b"tail",              # trailing bytes
        ],
    )
    def test_malformed_input_raises_cleanly(self, payload):
        with pytest.raises((ValueError, struct.error)):
            bloads(payload)


# -- hello negotiation / back-compat -----------------------------------------


class TestNegotiation:
    def test_v2_negotiated_by_default(self):
        with StorageServer(InMemoryStorage()) as srv:
            r = RemoteStorage(srv.url)
            assert r.protocol == 2
            assert r.supports_block_fetch

    def test_v2_client_falls_back_to_json_only_server(self):
        with StorageServer(InMemoryStorage(), max_protocol=1) as srv:
            r = RemoteStorage(srv.url)  # hello answered as unknown method
            assert r.protocol == 1
            assert not r.supports_block_fetch
            sid = r.create_new_study([StudyDirection.MINIMIZE], "s")
            assert r.get_study_name_from_id(sid) == "s"

    def test_client_pinned_to_v1(self):
        with StorageServer(InMemoryStorage()) as srv:
            r = RemoteStorage(srv.url, protocol=1)
            assert r.protocol == 1
            sid = r.create_new_study([StudyDirection.MINIMIZE], "s")
            assert r.get_study_name_from_id(sid) == "s"

    def test_block_rpcs_require_v2(self):
        with StorageServer(InMemoryStorage()) as srv:
            r = RemoteStorage(srv.url)
            sid = r.create_new_study([StudyDirection.MINIMIZE], "s")
            assert r.get_observation_block(sid)["n"] == 0
            r1 = RemoteStorage(srv.url, protocol=1)
            with pytest.raises(NotImplementedError):
                r1.get_observation_block(sid)
            with pytest.raises(NotImplementedError):
                r1.get_iv_block(sid)

    def test_store_falls_back_permanently_on_not_implemented(self):
        class Flaky(InMemoryStorage):
            supports_block_fetch = True

            def get_observation_block(self, study_id, since=0):
                raise NotImplementedError

            def get_iv_block(self, study_id, since=0):
                raise NotImplementedError

        storage = Flaky()
        sid = storage.create_new_study([StudyDirection.MINIMIZE], "s")
        tid = storage.create_new_trial(sid)
        storage.set_trial_state_values(tid, TrialState.COMPLETE, [1.0])
        obs = ObservationStore(storage, sid)
        obs.refresh()
        assert not obs._block_supported  # downgraded, data still ingested
        assert obs.n_observations == 1
        iv = IntermediateValueStore(storage, sid)
        iv.refresh()
        assert not iv._block_supported
        assert iv.n_rows == 1


def _phase_worker(url, protocol, seed, n_trials, out_q):
    try:
        storage = RemoteStorage(url, protocol=protocol)
        study = hpo.load_study(
            study_name="compat", storage=storage, sampler=hpo.TPESampler(seed=seed, engine="numpy"),
            pruner=hpo.MedianPruner(n_startup_trials=2),
        )
        study.optimize(_compat_objective, n_trials=n_trials)
        out_q.put("ok")
    except BaseException as e:  # pragma: no cover - surfaced by the test
        out_q.put(f"worker failed: {e!r}")


def _compat_objective(trial):
    x = trial.suggest_float("x", -5, 5)
    k = trial.suggest_int("k", 1, 4)
    for step in range(3):
        trial.report(x * x + step, step)
        if trial.should_prune():
            raise hpo.TrialPruned()
    return x * x + k * 0.1


def _trial_fingerprint(storage, study_id):
    return [
        (t.number, t.state, tuple(t.values) if t.values else None,
         sorted(t.params.items()), sorted(t.intermediate_values.items()))
        for t in storage.get_all_trials(study_id)
    ]


class TestBackCompatSeededStudy:
    """A seeded 2-process study completes bit-identically to inmemory under
    every protocol pairing: legacy JSON client against the v2 server, and a
    v2 client against a JSON-only server."""

    PHASES = ((7, 10), (23, 10))  # (sampler seed, n_trials) per process

    def _reference(self):
        storage = InMemoryStorage()
        sid = hpo.create_study(study_name="compat", storage=storage, engine="numpy")._study_id
        for seed, n in self.PHASES:
            study = hpo.load_study(
                study_name="compat", storage=storage,
                sampler=hpo.TPESampler(seed=seed, engine="numpy"),
                pruner=hpo.MedianPruner(n_startup_trials=2),
            )
            study.optimize(_compat_objective, n_trials=n)
        return _trial_fingerprint(storage, sid)

    @pytest.mark.parametrize(
        "client_proto,server_max",
        [(1, 2), (2, 1), (2, 2)],
        ids=["json-client-v2-server", "v2-client-json-server", "v2-both"],
    )
    def test_two_process_study_bit_identical(self, client_proto, server_max):
        reference = self._reference()
        with StorageServer(InMemoryStorage(), max_protocol=server_max) as srv:
            admin = RemoteStorage(srv.url, protocol=client_proto)
            sid = hpo.create_study(
                study_name="compat", storage=admin, engine="numpy"
            )._study_id
            # two worker processes run sequentially (deterministic handoff:
            # phase 2 sees exactly phase 1's history, like the reference)
            for seed, n in self.PHASES:
                q = multiprocessing.Queue()
                p = multiprocessing.Process(
                    target=_phase_worker, args=(srv.url, client_proto, seed, n, q)
                )
                p.start()
                result = q.get(timeout=120)
                p.join(timeout=30)
                assert result == "ok", result
            assert _trial_fingerprint(admin, sid) == reference


# -- frame fuzzing / reactor robustness ---------------------------------------


@pytest.fixture(params=[1, 2], ids=["v1", "v2"])
def fuzz_server(request):
    srv = StorageServer(InMemoryStorage(), max_protocol=request.param).start()
    yield srv
    srv.stop()


def _raw_conn(srv):
    sock = socket.create_connection((srv.host, srv.port), timeout=5.0)
    sock.settimeout(5.0)
    return sock


def _server_alive(srv):
    """A fresh client round-trips fine — the loop is still serving."""
    r = RemoteStorage(srv.url)
    sid = r.create_new_study([StudyDirection.MINIMIZE], f"alive-{r._req_id()}")
    assert r.get_study_name_from_id(sid).startswith("alive-")
    r.close()


class TestFrameFuzzing:
    def test_oversized_length_header_drops_connection(self, fuzz_server):
        good = RemoteStorage(fuzz_server.url)  # victim that must survive
        sock = _raw_conn(fuzz_server)
        sock.sendall(struct.pack(">I", MAX_FRAME_BYTES + 1))
        assert sock.recv(1) == b""  # dropped without a byte in response
        assert good.get_all_studies() == []  # other connection unharmed
        _server_alive(fuzz_server)

    def test_garbage_payload_drops_connection(self, fuzz_server):
        sock = _raw_conn(fuzz_server)
        send_frame(sock, b"\x00\xffnot a request under either protocol")
        assert sock.recv(1) == b""
        _server_alive(fuzz_server)

    def test_mid_frame_disconnect_is_isolated(self, fuzz_server):
        for _ in range(3):
            sock = _raw_conn(fuzz_server)
            sock.sendall(struct.pack(">I", 512) + b"x" * 100)  # torn frame
            sock.close()
        _server_alive(fuzz_server)

    def test_partial_frame_completes_after_delay(self, fuzz_server):
        sock = _raw_conn(fuzz_server)
        payload = json.dumps({"id": 1, "method": "ping", "params": []}).encode()
        frame = struct.pack(">I", len(payload)) + payload
        sock.sendall(frame[:3])
        _server_alive(fuzz_server)  # other clients progress meanwhile
        sock.sendall(frame[3:])
        body = recv_frame(sock)
        assert json.loads(body)["result"] == "pong"

    def test_garbage_binary_after_hello_drops_connection(self):
        with StorageServer(InMemoryStorage()) as srv:
            sock = _raw_conn(srv)
            hello = json.dumps(
                {"id": 1, "method": "hello", "params": [{"protocol": 2}]}
            ).encode()
            send_frame(sock, hello)
            assert json.loads(recv_frame(sock))["result"]["protocol"] == 2
            # now binary framing is required: garbage must kill only this conn
            send_frame(sock, bytes([BINARY_MAGIC]) + b"\xee\xee\xee")
            assert sock.recv(1) == b""
            _server_alive(srv)

    def test_unknown_method_is_typed_error_not_drop(self, fuzz_server):
        sock = _raw_conn(fuzz_server)
        send_frame(sock, json.dumps({"id": 5, "method": "no_such", "params": []}).encode())
        resp = json.loads(recv_frame(sock))
        assert resp["ok"] is False and "unknown storage method" in resp["error"]["message"]
        # the connection survives a typed error
        send_frame(sock, json.dumps({"id": 6, "method": "ping", "params": []}).encode())
        assert json.loads(recv_frame(sock))["result"] == "pong"

    def test_protocol_errors_counted(self, fuzz_server):
        before = fuzz_server.get_server_metrics()["protocol_errors"]
        sock = _raw_conn(fuzz_server)
        send_frame(sock, b"{truncated json")
        assert sock.recv(1) == b""
        metrics = fuzz_server.get_server_metrics()
        assert metrics["protocol_errors"] >= before + 1


# -- auth scopes ---------------------------------------------------------------


class TestAuthScopes:
    @pytest.fixture
    def scoped(self):
        backend = InMemoryStorage()
        sid_a = backend.create_new_study([StudyDirection.MINIMIZE], "a")
        sid_b = backend.create_new_study([StudyDirection.MINIMIZE], "b")
        srv = StorageServer(
            backend,
            auth_token="admin",
            auth_tokens=[
                {"token": "viewer", "readonly": True},
                {"token": "team-a", "studies": [sid_a]},
            ],
        ).start()
        yield srv, sid_a, sid_b
        srv.stop()

    def test_readonly_token_blocks_writes(self, scoped):
        srv, sid_a, _ = scoped
        viewer = RemoteStorage(srv.url, auth_token="viewer")
        assert viewer.get_study_name_from_id(sid_a) == "a"  # reads fine
        with pytest.raises(PermissionError):
            viewer.create_new_study([StudyDirection.MINIMIZE], "nope")
        with pytest.raises(PermissionError):
            viewer.create_new_trial(sid_a)
        by_cause = srv.get_server_metrics()["auth_failures_by_cause"]
        assert by_cause["readonly"] == 2  # terminal: one count per violation

    def test_study_scoped_token_allowlist(self, scoped):
        srv, sid_a, sid_b = scoped
        team = RemoteStorage(srv.url, auth_token="team-a")
        tid = team.create_new_trial(sid_a)  # in scope: full access
        team.set_trial_user_attr(tid, "k", 1)
        assert team.get_trial(tid).user_attrs == {"k": 1}
        with pytest.raises(PermissionError):
            team.get_all_trials(sid_b)
        with pytest.raises(PermissionError):
            team.create_new_trial(sid_b)
        with pytest.raises(PermissionError):
            team.get_all_studies()  # not study-addressable
        with pytest.raises(PermissionError):
            team.create_new_study([StudyDirection.MINIMIZE], "c")
        assert srv.get_server_metrics()["auth_failures_by_cause"]["study_scope"] == 4

    def test_trial_addressed_calls_resolve_to_study(self, scoped):
        srv, sid_a, sid_b = scoped
        admin = RemoteStorage(srv.url, auth_token="admin")
        tid_a = admin.create_new_trial(sid_a)
        tid_b = admin.create_new_trial(sid_b)
        team = RemoteStorage(srv.url, auth_token="team-a")
        # a trial the scoped connection never created still resolves (lazy
        # scan of the allowed studies)
        team.set_trial_user_attr(tid_a, "mine", True)
        assert admin.get_trial(tid_a).user_attrs == {"mine": True}
        with pytest.raises(PermissionError):
            team.set_trial_user_attr(tid_b, "theirs", True)
        with pytest.raises(PermissionError):
            team.get_trial(tid_b)

    def test_name_resolution_is_scope_checked(self, scoped):
        srv, sid_a, sid_b = scoped
        team = RemoteStorage(srv.url, auth_token="team-a")
        assert team.get_study_id_from_name("a") == sid_a
        with pytest.raises(PermissionError):
            team.get_study_id_from_name("b")

    def test_bad_token_counted_separately(self, scoped):
        srv, _, _ = scoped
        with pytest.raises(PermissionError):
            RemoteStorage(srv.url, auth_token="wrong")
        metrics = srv.get_server_metrics()
        assert metrics["auth_failures_by_cause"]["bad_token"] >= 1
        assert metrics["auth_failures"] >= 1  # aggregate keeps counting too

    def test_scoped_study_runs_end_to_end(self, scoped):
        srv, sid_a, _ = scoped
        team = RemoteStorage(srv.url, auth_token="team-a")
        study = hpo.load_study(
            study_name="a", storage=team, sampler=hpo.RandomSampler(seed=1)
        )
        study.optimize(lambda t: t.suggest_float("x", 0, 1) ** 2, n_trials=5)
        assert len(study.get_trials(states=(TrialState.COMPLETE,))) == 5


# -- TLS -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def tls_cert(tmp_path_factory):
    d = tmp_path_factory.mktemp("tls")
    cert, key = str(d / "cert.pem"), str(d / "key.pem")
    proc = subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
            "-keyout", key, "-out", cert, "-days", "1",
            "-subj", "/CN=127.0.0.1",
            "-addext", "subjectAltName=IP:127.0.0.1",
        ],
        capture_output=True,
    )
    if proc.returncode != 0:
        pytest.skip(f"openssl unavailable: {proc.stderr.decode()[:200]}")
    return cert, key


class TestTLS:
    def test_tls_study_end_to_end(self, tls_cert):
        cert, key = tls_cert
        with StorageServer(InMemoryStorage(), tls_cert=cert, tls_key=key) as srv:
            assert srv.url.startswith("remote+tls://")
            r = RemoteStorage(srv.url, tls_ca=cert)
            assert r.protocol == 2  # negotiation runs inside the TLS channel
            study = hpo.create_study(study_name="tls", storage=r, engine="numpy")
            study.optimize(lambda t: t.suggest_float("x", -1, 1) ** 2, n_trials=8)
            assert len(study.get_trials(states=(TrialState.COMPLETE,))) == 8

    def test_tls_with_auth_token(self, tls_cert, monkeypatch):
        cert, key = tls_cert
        monkeypatch.setenv("REPRO_STORAGE_TLS_CA", cert)
        with StorageServer(
            InMemoryStorage(), tls_cert=cert, tls_key=key, auth_token="s3c"
        ) as srv:
            url = f"remote+tls://s3c@{srv.host}:{srv.port}"
            client = get_storage(url)  # CA picked up from the env fallback
            sid = client.create_new_study([StudyDirection.MINIMIZE], "t")
            assert client.get_study_name_from_id(sid) == "t"
            with pytest.raises(PermissionError):
                RemoteStorage(srv.url, tls_ca=cert, auth_token="bad")

    def test_plaintext_client_cannot_reach_tls_server(self, tls_cert):
        cert, key = tls_cert
        with StorageServer(InMemoryStorage(), tls_cert=cert, tls_key=key) as srv:
            with pytest.raises(Exception):
                RemoteStorage(f"remote://{srv.host}:{srv.port}", retries=1, timeout=3.0)

    def test_cert_without_key_rejected(self, tls_cert):
        cert, _ = tls_cert
        with pytest.raises(ValueError):
            StorageServer(InMemoryStorage(), tls_cert=cert)


# -- mini worker storm (tier-1 smoke; the full storm lives in benchmarks) ------


def _storm_worker(storage, sid, results, idx):
    try:
        for _ in range(2):
            tid = storage.create_new_trial(sid)
            storage.set_trial_param(tid, "x", 0.5, FloatDistribution(0, 1))
            storage.set_trial_intermediate_value(tid, 0, float(idx))
            assert storage.set_trial_state_values(tid, TrialState.COMPLETE, [float(idx)])
        results[idx] = None
    except Exception as e:  # pragma: no cover - surfaced by the assert below
        results[idx] = e


class TestMiniWorkerStorm:
    @pytest.mark.parametrize("topology", ["single", "sharded"])
    @pytest.mark.parametrize("max_protocol", [1, 2], ids=["v1", "v2"])
    def test_200_worker_storm_smoke(self, max_protocol, topology):
        import contextlib

        n_workers = 200
        n_servers = 1 if topology == "single" else 3
        with contextlib.ExitStack() as stack:
            servers = [
                stack.enter_context(
                    StorageServer(InMemoryStorage(), max_protocol=max_protocol)
                )
                for _ in range(n_servers)
            ]
            if topology == "single":
                storage = RemoteStorage(servers[0].url, timeout=60.0)
                storm_server = servers[0]
            else:
                storage = ShardedStorage([s.url for s in servers], timeout=60.0)
                storm_server = servers[storage.shard_of_study("storm")]
            sid = storage.create_new_study([StudyDirection.MINIMIZE], "storm")
            results = [RuntimeError("never ran")] * n_workers
            threads = [
                threading.Thread(target=_storm_worker, args=(storage, sid, results, i))
                for i in range(n_workers)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            errors = [e for e in results if e is not None]
            assert not errors, errors[:3]
            trials = storage.get_all_trials(sid)
            assert len(trials) == n_workers * 2
            assert sorted(t.number for t in trials) == list(range(n_workers * 2))
            assert all(t.state == TrialState.COMPLETE for t in trials)
            metrics = storm_server.get_server_metrics()
            assert metrics["frames_in"] > 0 and metrics["bytes_out"] > 0
            # serialize-once accounting: per-method bytes_out measures the
            # actual wire payloads
            assert metrics["methods"]["create_new_trial"]["bytes_out"] > 0


# -- the event trace and metrics over the wire (tests/test_telemetry.py) ------


@pytest.fixture
def _clean_registry():
    telemetry.disable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()


def _run_seeded_study(storage):
    s = hpo.create_study(
        study_name="trace",
        storage=storage,
        sampler=hpo.RandomSampler(seed=7),
        pruner=hpo.MedianPruner(n_startup_trials=2, n_warmup_steps=0),
    )

    def obj(t):
        x = t.suggest_float("x", 0, 1)
        for step in range(3):
            t.report(x + step * 0.1, step)
            if t.should_prune():
                raise hpo.TrialPruned()
        return x

    s.optimize(obj, n_trials=12)
    return s._study_id


@pytest.mark.usefixtures("_clean_registry")
class TestRemoteRoundTrip:
    def test_event_trace_survives_remote_protocol(self):
        """The remote run must reconstruct the exact (event, number, step)
        sequence an inmemory run of the same seeded study produces."""
        mem = hpo.InMemoryStorage()
        local_sid = _run_seeded_study(mem)
        local = list(_iter_event_tuples(mem.get_trial_events(local_sid)))

        backend = hpo.InMemoryStorage()
        with hpo.StorageServer(backend) as server:
            remote = hpo.RemoteStorage(server.url)
            remote_sid = _run_seeded_study(remote)
            wire = remote.get_trial_events(remote_sid)
        assert list(_iter_event_tuples(wire)) == local
        # worker ids on the server-recorded trace are the client peers
        assert all(w.count(":") == 1 for w in wire["workers"])

    def test_get_server_metrics_rpc(self):
        backend = hpo.InMemoryStorage()
        with hpo.StorageServer(backend) as server:
            remote = hpo.RemoteStorage(server.url)
            _run_seeded_study(remote)
            m = remote.get_server_metrics()
            m2 = server.get_server_metrics()
        assert m["frames_in"] > 0 and m["bytes_in"] > 0
        assert m["frames_out"] > 0 and m["bytes_out"] > 0
        methods = m["methods"]
        assert "create_new_trial" in methods
        row = methods["create_new_trial"]
        assert row["calls"] == 12 and row["errors"] == 0
        assert row["bytes_out"] > 0
        assert 0 <= row["p50"] <= row["p95"] <= row["p99"] <= row["max"]
        # the in-process accessor serves the same surface
        assert m2["methods"]["create_new_trial"]["calls"] == 12

    def test_client_rpc_spans_when_enabled(self):
        telemetry.enable()
        backend = hpo.InMemoryStorage()
        with hpo.StorageServer(backend) as server:
            remote = hpo.RemoteStorage(server.url)
            sid = remote.create_new_study(
                [hpo.StudyDirection.MINIMIZE], "spans"
            )
            for _ in range(3):
                remote.create_new_trial(sid)
        snap = telemetry.snapshot()
        assert snap["counters"]["client.frames_out"] >= 4
        assert snap["counters"]["client.bytes_out"] > 0
        assert snap["histograms"]["client.rpc.create_new_trial"]["count"] == 3

    def test_cached_storage_counters(self):
        telemetry.enable()
        st = hpo.CachedStorage(hpo.InMemoryStorage())
        sid = st.create_new_study([hpo.StudyDirection.MINIMIZE], "cc")
        tid = st.create_new_trial(sid)
        st.get_trial(tid)  # own RUNNING trial -> cache hit
        snap = telemetry.snapshot()
        assert snap["counters"].get("cached.get_trial.hit_own", 0) >= 1


# -- clients and servers cross between the packages ----------------------------


def _reference():
    """``repro.core`` (the JAX package); these cases skip without jax."""
    pytest.importorskip("jax")
    import repro.core as ref

    return ref


def _cross_objective(core):
    def objective(trial):
        x = trial.suggest_float("x", -5.0, 5.0)
        lr = trial.suggest_float("lr", 1e-5, 1e-1, log=True)
        k = trial.suggest_int("k", 1, 4)
        act = trial.suggest_categorical("act", ["relu", "tanh", None])
        loss = (x - 1.0) ** 2 + (np.log10(lr) + 3.0) ** 2 + 0.1 * k + 0.3 * (act != "relu")
        for step in range(3):
            trial.report(float(loss) * (1.0 + 1.0 / (step + 1)), step)
            if trial.should_prune():
                raise core.TrialPruned()
        return float(loss)

    return objective


def _cross_study(core, storage):
    study = core.create_study(
        study_name="cross", storage=storage,
        sampler=core.TPESampler(seed=11, engine="numpy", n_startup_trials=5),
        pruner=core.MedianPruner(n_startup_trials=3),
    )
    study.optimize(_cross_objective(core), n_trials=32)
    return _trial_fingerprint(study._storage, study._study_id)


@pytest.mark.parametrize("protocol", [1, 2], ids=["v1", "v2"])
@pytest.mark.parametrize("client", ["repro_torch", "repro"])
def test_clients_and_servers_cross_between_packages(client, protocol):
    """A port client against a ``repro`` server, and a ``repro`` client
    against a port server: the seeded study (through the client's cache, so
    v2 refreshes by block) equals the in-memory one, on the client and in
    the server's backend."""
    ref = _reference()
    cores = {"repro": ref, "repro_torch": hpo}
    client_core = cores[client]
    server_core = cores["repro" if client == "repro_torch" else "repro_torch"]
    expected = _cross_study(hpo, InMemoryStorage())
    assert _cross_study(ref, ref.InMemoryStorage()) == expected
    with server_core.StorageServer(server_core.InMemoryStorage()) as srv:
        remote = client_core.RemoteStorage(srv.url, protocol=protocol)
        assert remote.protocol == protocol
        assert remote.supports_block_fetch == (protocol == 2)
        assert _cross_study(client_core, client_core.CachedStorage(remote)) == expected
        assert _trial_fingerprint(srv.storage, 0) == expected
        remote.close()


# -- one frame per report ------------------------------------------------------


@pytest.mark.parametrize("cached", [False, True], ids=["bare", "cached"])
@pytest.mark.parametrize("protocol", [1, 2], ids=["v1", "v2"])
def test_report_and_prune_is_one_frame_per_report(protocol, cached):
    """Each ``trial.report`` + ``should_prune`` pair of a pruned study over
    ``remote://`` crosses the wire in exactly one frame."""
    with StorageServer(InMemoryStorage()) as srv:
        remote = RemoteStorage(srv.url, protocol=protocol)
        frames = {"n": 0}
        roundtrip = remote._roundtrip

        def counting(request, payloads):
            frames["n"] += 1
            return roundtrip(request, payloads)

        remote._roundtrip = counting
        study = hpo.create_study(
            study_name="frames", storage=CachedStorage(remote) if cached else remote,
            sampler=hpo.RandomSampler(seed=0), pruner=hpo.MedianPruner(n_startup_trials=2),
        )
        reports, pruned = 0, 0
        for i in range(12):
            trial = study.ask()
            x = trial.suggest_float("x", 0, 1)
            for step in range(4):
                before = frames["n"]
                trial.report(x + (i % 3) + step, step)
                prune = trial.should_prune()
                assert frames["n"] - before == 1, (i, step)
                reports += 1
                if prune:
                    break
            if prune:
                pruned += 1
                study.tell(trial, state=TrialState.PRUNED)
            else:
                study.tell(trial, x)
        assert reports > 12 and pruned > 0
        assert len(srv.storage.get_all_trials(0)) == 12
        remote.close()
