"""The port's storage backends and wire codecs, held to the reference.

* The reference's own suites, each test under its reference name: the
  backend contract, journal specifics and heartbeats (``tests/
  test_storage.py``), the revision counter on every backend and study
  attrs on sqlite (``tests/test_records.py``, ``tests/test_study.py``), and
  the vectorized model-space codecs (``tests/test_codecs.py``,
  ``tests/test_codecs_hypothesis.py``).
* Same bytes: ``serde.pack`` / ``bdumps`` and ``build_observation_block`` /
  ``build_iv_block`` give the reference's bytes and columns for a payload
  corpus and for the trials of the same seeded studies.
* Blocks: ``get_observation_block`` / ``get_iv_block`` stores ingest the same
  columns as the per-trial path, in process and over the wire.
* Bit identity: a seeded ``engine="numpy"`` TPE study makes the same trials
  on in-memory, sqlite, journal, remote v1, remote v2 with the cache and
  two-shard storage, and the same as ``repro``'s study; the ``"torch"``
  engine on ``device="cpu"`` makes the same trials on every backend.
* Files cross between the packages: sqlite and journal files written by
  ``repro`` read back in ``repro_torch`` with the same trials, and the other
  way round.
* A NaN report reads back as NaN on every backend and is pruned; the
  reference's sqlite storage reads it back as None (a fault it keeps).
"""

import contextlib
import datetime
import json
import math
import threading

import numpy as np
import pytest

import repro_torch.core as hpo
from repro_torch.core import telemetry
from repro_torch.core.distributions import (
    CategoricalDistribution,
    FloatDistribution,
    IntDistribution,
    round_to_step,
)
from repro_torch.core.frozen import FrozenTrial, StudyDirection, TrialState
from repro_torch.core.records import IntermediateValueStore, ObservationStore
from repro_torch.core.storage import (
    CachedStorage,
    InMemoryStorage,
    JournalStorage,
    RemoteStorage,
    ShardedStorage,
    SQLiteStorage,
    StorageServer,
    get_storage,
)
from repro_torch.core.storage import serde

try:
    from hypothesis import given, settings, strategies as hst
except ImportError:  # pragma: no cover - the reference's module skips then too
    hst = None


def _reference():
    """``repro.core`` (the JAX package); the cross-package cases skip without jax."""
    pytest.importorskip("jax")
    import repro.core as ref

    return ref


# -- the backend contract (tests/test_storage.py) ------------------------------


BACKENDS = ["memory", "sqlite", "journal"]


def make_storage(kind, tmp_path):
    if kind == "memory":
        return InMemoryStorage()
    if kind == "sqlite":
        return SQLiteStorage(str(tmp_path / f"s.db"))
    return JournalStorage(str(tmp_path / "s.journal"))


@pytest.mark.parametrize("kind", BACKENDS)
class TestContract:
    def test_study_lifecycle(self, kind, tmp_path):
        st = make_storage(kind, tmp_path)
        sid = st.create_new_study([StudyDirection.MINIMIZE], "s1")
        assert st.get_study_id_from_name("s1") == sid
        assert st.get_study_name_from_id(sid) == "s1"
        assert st.get_study_directions(sid) == [StudyDirection.MINIMIZE]
        with pytest.raises(hpo.DuplicatedStudyError):
            st.create_new_study([StudyDirection.MINIMIZE], "s1")
        st.set_study_user_attr(sid, "k", {"nested": [1, 2]})
        assert st.get_study_user_attrs(sid)["k"] == {"nested": [1, 2]}
        st.delete_study(sid)
        with pytest.raises(KeyError):
            st.get_study_id_from_name("s1")

    def test_trial_lifecycle(self, kind, tmp_path):
        st = make_storage(kind, tmp_path)
        sid = st.create_new_study([StudyDirection.MINIMIZE], "s")
        tid = st.create_new_trial(sid)
        st.set_trial_param(tid, "x", 0.5, FloatDistribution(0, 1))
        st.set_trial_intermediate_value(tid, 1, 10.0)
        st.set_trial_intermediate_value(tid, 1, 9.0)  # overwrite
        st.set_trial_user_attr(tid, "note", "hi")
        assert st.set_trial_state_values(tid, TrialState.COMPLETE, [1.5])
        t = st.get_trial(tid)
        assert t.params["x"] == 0.5
        assert t.intermediate_values == {1: 9.0}
        assert t.user_attrs["note"] == "hi"
        assert t.values == [1.5]
        assert t.state == TrialState.COMPLETE
        assert t.datetime_complete is not None
        # finished trials reject writes
        with pytest.raises(RuntimeError):
            st.set_trial_param(tid, "y", 0.1, FloatDistribution(0, 1))
        with pytest.raises(RuntimeError):
            st.set_trial_intermediate_value(tid, 2, 0.0)

    def test_trial_numbers_dense(self, kind, tmp_path):
        st = make_storage(kind, tmp_path)
        sid = st.create_new_study([StudyDirection.MINIMIZE], "s")
        tids = [st.create_new_trial(sid) for _ in range(10)]
        numbers = [st.get_trial(t).number for t in tids]
        assert numbers == list(range(10))

    def test_waiting_claim_race(self, kind, tmp_path):
        st = make_storage(kind, tmp_path)
        sid = st.create_new_study([StudyDirection.MINIMIZE], "s")
        tid = st.create_new_trial(
            sid, template_trial=FrozenTrial(number=-1, state=TrialState.WAITING)
        )
        assert st.set_trial_state_values(tid, TrialState.RUNNING)
        assert not st.set_trial_state_values(tid, TrialState.RUNNING)  # second claim loses

    def test_threaded_writers(self, kind, tmp_path):
        st = make_storage(kind, tmp_path)
        sid = st.create_new_study([StudyDirection.MINIMIZE], "s")
        errs = []

        def worker(i):
            try:
                for _ in range(10):
                    tid = st.create_new_trial(sid)
                    st.set_trial_param(tid, "x", 0.1, FloatDistribution(0, 1))
                    st.set_trial_state_values(tid, TrialState.COMPLETE, [float(i)])
            except Exception as e:  # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        trials = st.get_all_trials(sid)
        assert len(trials) == 40
        assert sorted(t.number for t in trials) == list(range(40))


class TestJournalSpecifics:
    def test_two_handles_share_state(self, tmp_path):
        path = str(tmp_path / "j.journal")
        a = JournalStorage(path)
        b = JournalStorage(path)
        sid = a.create_new_study([StudyDirection.MINIMIZE], "s")
        tid = a.create_new_trial(sid)
        a.set_trial_state_values(tid, TrialState.COMPLETE, [3.0])
        # b sees a's writes after sync
        assert b.get_trial(tid).values == [3.0]
        # and b can extend
        tid2 = b.create_new_trial(sid)
        assert a.get_trial(tid2).number == 1

    def test_torn_tail_line_ignored(self, tmp_path):
        path = str(tmp_path / "j.journal")
        a = JournalStorage(path)
        sid = a.create_new_study([StudyDirection.MINIMIZE], "s")
        a.create_new_trial(sid)
        with open(path, "a") as f:
            f.write('{"op": "create_trial", "trial_id": 99')  # torn write, no newline
        b = JournalStorage(path)
        assert len(b.get_all_trials(sid)) == 1  # torn line invisible

    def test_replay_after_restart(self, tmp_path):
        path = str(tmp_path / "j.journal")
        a = JournalStorage(path)
        sid = a.create_new_study([StudyDirection.MAXIMIZE], "s")
        for i in range(5):
            tid = a.create_new_trial(sid)
            a.set_trial_state_values(tid, TrialState.COMPLETE, [float(i)])
        del a
        b = JournalStorage(path)
        sid2 = b.get_study_id_from_name("s")
        assert sid2 == sid
        assert len(b.get_all_trials(sid)) == 5


class TestHeartbeat:
    @pytest.mark.parametrize("kind", BACKENDS)
    def test_stale_detection_and_failover(self, kind, tmp_path):
        import time

        st = make_storage(kind, tmp_path)
        sid = st.create_new_study([StudyDirection.MINIMIZE], "s")
        tid = st.create_new_trial(sid)
        st.record_heartbeat(tid)
        time.sleep(0.03)
        assert st.get_stale_trial_ids(sid, grace_seconds=0.01) == [tid]
        assert st.get_stale_trial_ids(sid, grace_seconds=60.0) == []
        failed = st.fail_stale_trials(sid, grace_seconds=0.01)
        assert failed == [tid]
        assert st.get_trial(tid).state == TrialState.FAIL


def test_get_storage_url_routing(tmp_path):
    assert isinstance(get_storage(None), InMemoryStorage)
    assert isinstance(get_storage(f"sqlite:///{tmp_path}/a.db"), SQLiteStorage)
    assert isinstance(get_storage(f"journal://{tmp_path}/a.journal"), JournalStorage)
    assert isinstance(get_storage(str(tmp_path / "b.db")), SQLiteStorage)
    with pytest.raises(ValueError):
        get_storage("mysterious://x")


# -- revision counter and study attrs (tests/test_records.py, tests/test_study.py)


class TestRevisionCounter:
    def _check(self, storage):
        sid = storage.create_new_study([hpo.StudyDirection.MINIMIZE], "rev-study")
        r0 = storage.get_trials_revision(sid)
        tid = storage.create_new_trial(sid)
        r1 = storage.get_trials_revision(sid)
        assert r1 > r0
        storage.set_trial_param(tid, "x", 0.5, FloatDistribution(0, 1))
        r2 = storage.get_trials_revision(sid)
        assert r2 > r1
        # in-place update to a RUNNING trial is visible (a number-based
        # since= poll could not see it)
        storage.set_trial_intermediate_value(tid, 0, 1.0)
        r3 = storage.get_trials_revision(sid)
        assert r3 > r2
        storage.set_trial_system_attr(tid, "k", "v")
        r4 = storage.get_trials_revision(sid)
        assert r4 > r3
        storage.set_trial_state_values(tid, TrialState.COMPLETE, [1.0])
        assert storage.get_trials_revision(sid) > r4

    def test_inmemory(self):
        self._check(hpo.InMemoryStorage())

    def test_sqlite(self, tmp_sqlite):
        self._check(hpo.get_storage(tmp_sqlite))

    def test_journal(self, tmp_journal):
        self._check(hpo.get_storage(tmp_journal))

    def test_remote(self):
        backend = hpo.InMemoryStorage()
        with hpo.StorageServer(backend) as server:
            remote = hpo.RemoteStorage(server.url)
            self._check(remote)
            remote.close()


def test_study_user_attrs_and_system_attrs(tmp_sqlite):
    s = hpo.create_study(study_name="attrs", storage=tmp_sqlite, engine="numpy")
    s.set_user_attr("dataset", "svhn")
    s.set_system_attr("version", 2)
    s2 = hpo.load_study("attrs", tmp_sqlite, engine="numpy")
    assert s2.user_attrs["dataset"] == "svhn"
    assert s2.system_attrs["version"] == 2


# -- model-space codecs (tests/test_codecs.py, tests/test_codecs_hypothesis.py)


RNG = np.random.RandomState(20260726)

FLOAT_DISTS = [
    FloatDistribution(-5.0, 5.0),
    FloatDistribution(0.0, 1.0, step=0.25),
    FloatDistribution(1e-6, 1.0, log=True),
    FloatDistribution(2.5, 2.5),
    FloatDistribution(-1e6, 1e6),
]
INT_DISTS = [
    IntDistribution(1, 100),
    IntDistribution(-50, 50, step=5),
    IntDistribution(1, 1024, log=True),
    IntDistribution(7, 7),
]
CAT_DISTS = [
    CategoricalDistribution(["a", "b", "c"]),
    CategoricalDistribution([None, True, 0, 1.5, "x"]),
    CategoricalDistribution([1, True]),  # int/bool must not conflate
]


def _domain_samples(dist, n=200):
    if isinstance(dist, FloatDistribution):
        if dist.step is not None:
            k = int(np.floor((dist.high - dist.low) / dist.step + 1e-12)) + 1
            return dist.low + RNG.randint(k, size=n) * dist.step
        if dist.log:
            return np.exp(RNG.uniform(np.log(dist.low), np.log(dist.high), size=n))
        return RNG.uniform(dist.low, dist.high, size=n)
    if isinstance(dist, IntDistribution):
        k = (dist.high - dist.low) // dist.step + 1
        return dist.low + RNG.randint(k, size=n) * dist.step
    return [dist.choices[i] for i in RNG.randint(len(dist.choices), size=n)]


@pytest.mark.parametrize("dist", FLOAT_DISTS + INT_DISTS)
def test_numeric_roundtrip_is_identity_on_domain(dist):
    xs = _domain_samples(dist)
    back = dist.from_internal(dist.to_internal(xs))
    assert np.allclose(back, np.asarray(xs, dtype=float), rtol=1e-12, atol=1e-9)
    # external conversion lands exactly on domain values
    for b in back:
        ext = dist.to_external_repr(float(b))
        assert dist._contains(dist.to_internal_repr(ext))


@pytest.mark.parametrize("dist", CAT_DISTS)
def test_categorical_roundtrip(dist):
    xs = _domain_samples(dist)
    internal = dist.to_internal(xs)
    back = [dist.to_external_repr(v) for v in dist.from_internal(internal)]
    for orig, b in zip(xs, back):
        assert type(orig) is type(b) and orig == b


@pytest.mark.parametrize("dist", FLOAT_DISTS + INT_DISTS + CAT_DISTS)
def test_vectorized_matches_scalar_codec(dist):
    """to_internal must agree with the scalar storage repr composed with the
    model transform (log for log domains)."""
    xs = _domain_samples(dist, n=50)
    vec = dist.to_internal(xs)
    for x, v in zip(xs, vec):
        scalar = dist.to_internal_repr(x)
        if getattr(dist, "log", False):
            scalar = math.log(max(scalar, 1e-12))
        assert v == scalar


@pytest.mark.parametrize("dist", FLOAT_DISTS + INT_DISTS + CAT_DISTS)
def test_from_internal_maps_arbitrary_reals_into_domain(dist):
    lo, hi = dist.internal_bounds(expand_int=True)
    zs = RNG.uniform(lo - 1.0, hi + 1.0, size=200)
    back = dist.from_internal(zs)
    for b in back:
        assert dist._contains(dist.to_internal_repr(dist.to_external_repr(float(b))))


@pytest.mark.parametrize("dist", FLOAT_DISTS + INT_DISTS)
def test_internal_bounds_contain_observations(dist):
    xs = _domain_samples(dist)
    internal = dist.to_internal(xs)
    lo, hi = dist.internal_bounds(expand_int=True)
    assert np.all(internal >= lo - 1e-9) and np.all(internal <= hi + 1e-9)
    lo2, hi2 = dist.internal_bounds()
    assert lo2 <= hi2


@pytest.mark.parametrize("dist", FLOAT_DISTS + INT_DISTS + CAT_DISTS)
def test_sample_uniform_within_domain(dist):
    rng = np.random.RandomState(1)
    vals = dist.sample_uniform(rng, 300)
    assert len(vals) == 300
    for v in vals:
        assert dist._contains(float(v))
        ext = dist.to_external_repr(float(v))
        assert dist._contains(dist.to_internal_repr(ext))


def test_sample_uniform_stream_matches_scalar_draws():
    """size=1 draws consume the RNG exactly like the historical scalar path,
    so seeded studies reproduce across the refactor."""
    for dist in FLOAT_DISTS + INT_DISTS + CAT_DISTS:
        r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
        a = [float(dist.sample_uniform(r1, 1)[0]) for _ in range(20)]
        b = list(map(float, dist.sample_uniform(r2, 20)))
        assert a == b


def test_internal_to_unit_roundtrip():
    for dist in FLOAT_DISTS + INT_DISTS:
        if dist.single():
            continue
        xs = _domain_samples(dist, n=100)
        u = dist.internal_to_unit(dist.to_internal(xs))
        assert np.all(u >= -1e-12) and np.all(u <= 1 + 1e-12)


def test_round_to_step_array_matches_scalar():
    xs = RNG.uniform(-10, 10, 100)
    arr = round_to_step(xs, -10.0, 10.0, 0.3)
    for x, a in zip(xs, arr):
        assert a == round_to_step(float(x), -10.0, 10.0, 0.3)


if hst is not None:

    class TestCodecsHypothesis:
        """The reference's hypothesis properties (``tests/test_codecs_hypothesis.py``)."""

        @settings(deadline=None, max_examples=50)
        @given(
            low=hst.floats(-1e6, 1e6, allow_nan=False),
            width=hst.floats(1e-6, 1e6, allow_nan=False),
            data=hst.lists(hst.floats(0.0, 1.0), min_size=1, max_size=16),
        )
        def test_float_roundtrip(self, low, width, data):
            d = FloatDistribution(low, low + width)
            xs = np.asarray([low + u * width for u in data])
            back = d.from_internal(d.to_internal(xs))
            assert np.all(back >= d.low) and np.all(back <= d.high)
            assert np.allclose(back, xs, rtol=1e-12, atol=1e-9)

        @settings(deadline=None, max_examples=50)
        @given(
            low=hst.floats(1e-8, 1e3),
            mult=hst.floats(1.5, 1e3),
            data=hst.lists(hst.floats(0.0, 1.0), min_size=1, max_size=16),
        )
        def test_float_log_roundtrip(self, low, mult, data):
            d = FloatDistribution(low, low * mult, log=True)
            xs = np.exp(np.log(low) + np.asarray(data) * np.log(mult))
            back = d.from_internal(d.to_internal(xs))
            assert np.all(back >= d.low) and np.all(back <= d.high)
            assert np.allclose(back, xs, rtol=1e-9)

        @settings(deadline=None, max_examples=50)
        @given(
            low=hst.integers(-1000, 1000),
            width=hst.integers(0, 1000),
            step=hst.integers(1, 7),
            data=hst.lists(hst.integers(0, 10**6), min_size=1, max_size=16),
        )
        def test_int_roundtrip(self, low, width, step, data):
            d = IntDistribution(low, low + width, step=step)
            n_cells = (d.high - d.low) // d.step + 1
            xs = [d.low + (v % n_cells) * d.step for v in data]
            back = d.from_internal(d.to_internal(xs))
            assert list(back.astype(int)) == xs

        @settings(deadline=None, max_examples=50)
        @given(
            hst.lists(
                hst.one_of(hst.integers(), hst.text(max_size=6), hst.booleans(), hst.none()),
                min_size=1, max_size=8, unique_by=lambda x: (type(x).__name__, x),
            ),
            hst.lists(hst.integers(0, 10**6), min_size=1, max_size=16),
        )
        def test_categorical_roundtrip(self, choices, picks):
            d = CategoricalDistribution(choices)
            xs = [choices[p % len(choices)] for p in picks]
            back = [d.to_external_repr(v) for v in d.from_internal(d.to_internal(xs))]
            assert all(type(a) is type(b) and a == b for a, b in zip(xs, back))


# -- same bytes as the reference -----------------------------------------------


def _payload_corpus(core):
    """Payloads the wire carries, built from ``core``'s own classes (``core``
    is ``repro.core`` or ``repro_torch.core``)."""
    from importlib import import_module

    d = import_module(core.__name__ + ".distributions")
    fz = import_module(core.__name__ + ".frozen")
    base = import_module(core.__name__ + ".storage.base")
    when = datetime.datetime(2026, 8, 8, 12, 0, 1, 5)
    trial = fz.FrozenTrial(
        number=3,
        state=fz.TrialState.PRUNED,
        values=[1.5, -2.0],
        params={"x": 0.25, "c": None, "n": 4},
        distributions={
            "x": d.FloatDistribution(0, 1, log=False),
            "c": d.CategoricalDistribution([None, "b", 4]),
            "n": d.IntDistribution(1, 16, log=True),
        },
        intermediate_values={0: 1.0, 7: float("nan"), 9: float("inf")},
        user_attrs={"k": [1, {"deep": "v"}]},
        system_attrs={"fixed_params": {"x": 0.25}, "iv_vec:0": [1.0, 2.0]},
        trial_id=17,
        datetime_start=when,
        datetime_complete=when + datetime.timedelta(seconds=1),
    )
    summary = base.StudySummary(
        study_name="s", directions=[fz.StudyDirection.MINIMIZE, fz.StudyDirection.MAXIMIZE],
        user_attrs={"u": 1}, system_attrs={}, n_trials=4, study_id=2,
    )
    return [
        None, True, False, 0, -1, 2**40, -(2**40), 2**100, -(2**100), 1.5, float("inf"),
        float("-inf"), float("nan"), "", "héllo", b"raw\x00bytes",
        {"a": [1, 2.5, None, {"n": [True]}], 3: "three", "t": (1, 2)},
        np.arange(6, dtype=np.int64), np.arange(6, dtype=np.float64).reshape(2, 3),
        np.array([], dtype=np.float32), np.array([[True, False]]),
        np.arange(8, dtype=np.int8)[::2],
        fz.TrialState.COMPLETE, fz.StudyDirection.MAXIMIZE,
        d.FloatDistribution(1e-5, 1e-1, log=True), d.FloatDistribution(0, 1, step=0.25),
        d.IntDistribution(-50, 50, step=5), d.CategoricalDistribution([None, True, 0, 1.5, "x"]),
        when, trial, [trial, trial], summary,
    ]


def _seeded_trials(core, kind):
    """The trials of a seeded study run on ``core`` in memory: ``"tpe"`` a
    pruned single-objective TPE study (numpy engine), ``"vector"`` a
    two-objective study with vector reports and a failed trial."""
    if kind == "tpe":
        study = core.create_study(
            sampler=core.TPESampler(seed=0, engine="numpy", n_startup_trials=5),
            pruner=core.MedianPruner(n_startup_trials=5),
        )
        study.optimize(_objective(core), n_trials=24)
    else:
        study = core.create_study(
            directions=["minimize", "maximize"], sampler=core.RandomSampler(seed=3),
            pruner=core.NopPruner(),
        )
        for i in range(6):
            t = study.ask()
            x = t.suggest_float("x", 0, 1)
            n = t.suggest_int("n", 1, 9)
            for step in range(3):
                t.report([x + step, n - step], step)
            if i == 4:
                study.tell(t, state=core.TrialState.FAIL)
            else:
                study.tell(t, [x, float(n)])
        study.ask()  # a RUNNING trial: in the IV block, not the observation block
    return study._storage.get_all_trials(study._study_id, deepcopy=False), len(study.directions)


def _assert_same_columns(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, key
            assert x.tobytes() == y.tobytes(), key
        elif isinstance(x, dict):
            _assert_same_columns(x, y)
        else:
            assert x == y, key


def test_bdumps_and_pack_give_the_reference_bytes():
    ref = _reference()
    from repro.core.storage import serde as ref_serde

    ours, theirs = _payload_corpus(hpo), _payload_corpus(ref)
    for a, b in zip(ours, theirs):
        assert serde.bdumps(a) == ref_serde.bdumps(b), a
        try:
            expected = json.dumps(ref_serde.pack(b))
        except TypeError:  # v1 carries no bytes or arrays: both refuse them
            with pytest.raises(TypeError):
                serde.pack(a)
        else:
            assert json.dumps(serde.pack(a)) == expected, a
    assert serde.bjoin([serde.bdumps(p) for p in ours]) == ref_serde.bjoin(
        [ref_serde.bdumps(p) for p in theirs]
    )
    # each package decodes the other's bytes to its own classes
    decoded = serde.bloads(ref_serde.bdumps(theirs[-2]))
    assert isinstance(decoded[0], FrozenTrial) and decoded[0].state is TrialState.PRUNED


@pytest.mark.parametrize("kind", ["tpe", "vector"])
def test_blocks_give_the_reference_bytes_and_columns(kind):
    ref = _reference()
    from repro.core.storage import serde as ref_serde

    ours, m = _seeded_trials(hpo, kind)
    theirs, _ = _seeded_trials(ref, kind)
    obs = serde.build_observation_block(ours, m)
    ref_obs = ref_serde.build_observation_block(theirs, m)
    _assert_same_columns(obs, ref_obs)
    assert serde.bdumps(obs) == ref_serde.bdumps(ref_obs)
    iv, ref_iv = serde.build_iv_block(ours), ref_serde.build_iv_block(theirs)
    _assert_same_columns(iv, ref_iv)
    assert serde.bdumps(iv) == ref_serde.bdumps(ref_iv)
    assert ("vec_numbers" in iv) == (kind == "vector")
    assert obs["n"] == sum(t.state.is_finished() for t in ours) < len(ours) + (kind == "tpe")


# -- blocks: the same columns as the per-trial path ----------------------------


class _BlockMemory(InMemoryStorage):
    """In-memory storage that offers the block fetch (built by ``serde``)."""

    supports_block_fetch = True


def _store_columns(obs, iv):
    names = obs.param_names()
    cols = {
        "numbers": obs.numbers, "states": obs.states, "values": obs.values,
        "values_matrix": obs.values_matrix, "values_arity": obs.values_arity,
        "last_iv": obs.last_intermediate_values, "grid_ids": obs.grid_ids,
        "iv_steps": iv.steps, "iv_states": iv.states, "iv_trial_ids": iv.trial_ids,
        "iv_matrix": iv.matrix, "iv_arity": iv.iv_arity,
    }
    for k in range(iv.n_objectives):
        cols[f"iv_objective_{k}"] = iv.objective_matrix(k)
    for name in names:
        cols[f"param_{name}"] = obs.column(name)
        cols[f"dist_{name}"] = np.frombuffer(
            json.dumps(serde.pack(obs.distribution(name))).encode(), dtype=np.uint8
        )
    return names, cols


def _replay(storage, trials, sid):
    """Write ``trials`` into ``storage`` in stages, refreshing both stores
    after each stage (incremental ingest), and return their columns."""
    obs, iv = ObservationStore(storage, sid), IntermediateValueStore(storage, sid)
    for lo in range(0, len(trials), 5):
        for t in trials[lo:lo + 5]:
            tid = storage.create_new_trial(sid)
            for name, value in t.params.items():
                storage.set_trial_param(
                    tid, name, t.distributions[name].to_internal_repr(value), t.distributions[name]
                )
            for key, vec in t.system_attrs.items():
                if key.startswith("iv_vec:"):
                    storage.set_trial_intermediate_vector(tid, int(key[7:]), vec)
            for step, v in t.intermediate_values.items():
                storage.set_trial_intermediate_value(tid, step, v)
            if t.state != TrialState.RUNNING:
                storage.set_trial_state_values(tid, t.state, t.values)
        obs.refresh()
        iv.refresh()
    return obs, iv


@pytest.mark.parametrize("kind", ["tpe", "vector"])
@pytest.mark.parametrize("route", ["in-process", "wire"])
def test_block_ingest_matches_trial_ingest(kind, route):
    """``ObservationStore`` / ``IntermediateValueStore`` fed by blocks hold
    the same columns, bit for bit, as when fed by trial objects."""
    trials, m = _seeded_trials(hpo, kind)
    directions = [StudyDirection.MINIMIZE, StudyDirection.MAXIMIZE][:m]
    with contextlib.ExitStack() as stack:
        if route == "in-process":
            by_block, by_trial = _BlockMemory(), InMemoryStorage()
        else:
            v2 = stack.enter_context(StorageServer(InMemoryStorage()))
            v1 = stack.enter_context(StorageServer(InMemoryStorage(), max_protocol=1))
            by_block, by_trial = RemoteStorage(v2.url), RemoteStorage(v1.url)
            assert by_block.protocol == 2 and by_trial.protocol == 1
        assert by_block.supports_block_fetch and not by_trial.supports_block_fetch
        columns = []
        for storage in (by_block, by_trial):
            sid = storage.create_new_study(directions, "blocks")
            telemetry.reset()
            telemetry.enable()
            try:
                obs, iv = _replay(storage, trials, sid)
            finally:
                telemetry.disable()
            counters = telemetry.snapshot()["counters"]
            telemetry.reset()
            for store in ("obs", "iv"):
                blocks = counters.get(f"records.{store}.refresh.block", 0)
                assert (blocks > 0) == (storage is by_block), counters
            assert obs._block_supported and iv._block_supported
            columns.append(_store_columns(obs, iv))
            assert obs.n_observations == sum(t.state.is_finished() for t in trials)
    (names_a, a), (names_b, b) = columns
    assert names_a == names_b and names_a
    _assert_same_columns(a, b)


def test_get_observation_block_returns_the_reference_columns():
    ref = _reference()
    ours, m = _seeded_trials(hpo, "tpe")
    theirs, _ = _seeded_trials(ref, "tpe")
    port_storage, ref_storage = InMemoryStorage(), ref.InMemoryStorage()
    for storage, trials, core in ((port_storage, ours, hpo), (ref_storage, theirs, ref)):
        sid = storage.create_new_study([core.StudyDirection.MINIMIZE], "b")
        _replay(storage, trials, sid)
    for since in (0, 7):
        _assert_same_columns(port_storage.get_observation_block(0, since),
                             ref_storage.get_observation_block(0, since))
        _assert_same_columns(port_storage.get_iv_block(0, since),
                             ref_storage.get_iv_block(0, since))


# -- bit identity across backends and against the reference --------------------


def _objective(core):
    """A seeded study's objective on ``core``: five parameters of four
    kinds, three reports and a prune check per trial."""

    def objective(trial):
        xs = [trial.suggest_float(f"x{i}", -5.0, 5.0) for i in range(2)]
        lr = trial.suggest_float("lr", 1e-5, 1e-1, log=True)
        width = trial.suggest_int("width", 1, 128, log=True)
        act = trial.suggest_categorical("activation", ["relu", "tanh", "gelu"])
        loss = sum((x - 1.0) ** 2 for x in xs)
        loss += (math.log10(lr) + 3.0) ** 2 + 0.1 * abs(math.log2(width) - 5.0)
        loss += 0.3 * (act != "relu")
        for step in range(3):
            trial.report(loss * (1.0 + 1.0 / (step + 1)), step)
            if trial.should_prune():
                raise core.TrialPruned()
        return loss

    return objective


def _fingerprint(trials):
    """Every trial's number, state, parameters, values and intermediate
    values, exactly (floats by their repr)."""
    return [
        (t.number, t.state.name, sorted(t.params.items()), t.values,
         sorted(t.intermediate_values.items()))
        for t in trials
    ]


BACKEND_KINDS = ["memory", "sqlite", "journal", "remote-v1", "remote-v2-cached", "sharded"]


@contextlib.contextmanager
def _backend(kind, tmp_path):
    """A fresh port storage of ``kind``; servers run in this process."""
    with contextlib.ExitStack() as stack:
        if kind == "memory":
            storage = get_storage(None)
        elif kind == "sqlite":
            storage = get_storage(f"sqlite:///{tmp_path}/parity.db")
        elif kind == "journal":
            storage = get_storage(f"journal://{tmp_path}/parity.journal")
        elif kind == "remote-v1":
            srv = stack.enter_context(StorageServer(InMemoryStorage(), max_protocol=1))
            storage = get_storage(srv.url)
            assert storage.protocol == 1
        elif kind == "remote-v2-cached":
            srv = stack.enter_context(StorageServer(InMemoryStorage()))
            storage = get_storage(srv.url, cache=True)
            assert isinstance(storage, CachedStorage) and storage.supports_block_fetch
        else:
            pool = [stack.enter_context(StorageServer(InMemoryStorage())) for _ in range(2)]
            storage = get_storage("remote://" + ",".join(s.url.split("://")[1] for s in pool))
            assert isinstance(storage, ShardedStorage)
        yield storage
        storage.close()


def _seeded_study(core, storage, **engine):
    study = core.create_study(
        study_name="parity", storage=storage,
        sampler=core.TPESampler(seed=0, n_startup_trials=5, **engine),
        pruner=core.MedianPruner(n_startup_trials=5),
    )
    study.optimize(_objective(core), n_trials=48)
    return _fingerprint(study.get_trials(deepcopy=False))


@pytest.fixture(scope="module")
def memory_fingerprints():
    return {
        "numpy": _seeded_study(hpo, None, engine="numpy"),
        "torch": _seeded_study(hpo, None, engine="torch", device="cpu"),
    }


@pytest.mark.parametrize("kind", BACKEND_KINDS)
def test_numpy_study_bit_identical_on_every_backend(kind, tmp_path, memory_fingerprints):
    with _backend(kind, tmp_path) as storage:
        got = _seeded_study(hpo, storage, engine="numpy")
    assert got == memory_fingerprints["numpy"]
    states = {s for _, s, *_ in got}
    assert states == {"COMPLETE", "PRUNED"}


def test_numpy_study_bit_identical_to_reference(memory_fingerprints):
    ref = _reference()
    assert _seeded_study(ref, None, engine="numpy") == memory_fingerprints["numpy"]


@pytest.mark.parametrize("kind", BACKEND_KINDS[1:])
def test_torch_engine_study_bit_identical_on_every_backend(kind, tmp_path, memory_fingerprints):
    with _backend(kind, tmp_path) as storage:
        got = _seeded_study(hpo, storage, engine="torch", device="cpu")
    assert got == memory_fingerprints["torch"]


# -- files cross between the packages ------------------------------------------


def _write_study(core, url):
    """A seeded study with every trial state, user attrs and enqueued
    parameters, written to ``url`` by ``core``; returns its trials."""
    study = core.create_study(
        study_name="cross", storage=url, directions=["minimize"],
        sampler=core.TPESampler(seed=0, engine="numpy", n_startup_trials=5),
        pruner=core.MedianPruner(n_startup_trials=5),
    )
    study.set_user_attr("dataset", "svhn")
    study.enqueue_trial({"x0": 1.0, "x1": -1.0})
    study.optimize(_objective(core), n_trials=20)
    failed = study.ask()
    failed.suggest_float("x0", -5.0, 5.0)
    failed.set_user_attr("note", {"nested": [1, 2]})
    study.tell(failed, state=core.TrialState.FAIL)
    study.ask()  # left RUNNING
    study.enqueue_trial({"x0": 0.5})  # left WAITING
    return study._storage.get_all_trials(study._study_id)


def _full_fingerprint(trials):
    from repro_torch.core.distributions import distribution_to_json

    return [
        (t.number, t.state.name, sorted(t.params.items()), t.values,
         sorted(t.intermediate_values.items()), sorted(t.user_attrs.items()),
         json.dumps(t.system_attrs, sort_keys=True),
         sorted((k, distribution_to_json(v)) for k, v in t.distributions.items()),
         t.datetime_start, t.datetime_complete)
        for t in trials
    ]


@pytest.mark.parametrize("scheme", ["sqlite", "journal"])
@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_files_cross_between_packages(scheme, writer, tmp_path):
    ref = _reference()
    cores = {"repro": ref, "repro_torch": hpo}
    reader = "repro_torch" if writer == "repro" else "repro"
    url = (f"sqlite:///{tmp_path}/cross.db" if scheme == "sqlite"
           else f"journal://{tmp_path}/cross.journal")
    written = _write_study(cores[writer], url)
    read = cores[reader].load_study("cross", url, sampler=cores[reader].RandomSampler(seed=0))
    assert _full_fingerprint(read.get_trials()) == _full_fingerprint(written)
    assert read.user_attrs == {"dataset": "svhn"}
    assert {t.state.name for t in written} == {"COMPLETE", "PRUNED", "FAIL", "RUNNING", "WAITING"}
    # the reader goes on writing the same file, and the writer reads it back
    read.optimize(lambda t: t.suggest_float("x0", -5.0, 5.0) ** 2, n_trials=3)
    again = cores[writer].load_study("cross", url, sampler=cores[writer].RandomSampler(seed=0))
    assert _full_fingerprint(again.get_trials()) == _full_fingerprint(read.get_trials())
    assert len(again.get_trials()) == len(written) + 2  # the WAITING trial ran first


# -- NaN reports --------------------------------------------------------------------


def _nan_report_study(pkg, storage):
    study = pkg.create_study(storage=storage, sampler=pkg.RandomSampler(seed=0),
                             pruner=pkg.SuccessiveHalvingPruner(min_resource=1,
                                                                reduction_factor=2))

    def objective(t):
        x = t.suggest_float("x", 0, 1)
        t.report(float("nan") if t.number in (3, 6) else x, 1)
        if t.should_prune():
            raise pkg.TrialPruned()
        return x

    study.optimize(objective, n_trials=10)
    return study


@pytest.mark.parametrize("kind", BACKENDS)
def test_nan_report_reads_back_as_nan_and_is_pruned(kind, tmp_path):
    """A diverging trial reports NaN.  SQLite stores a NaN as NULL; the
    port's sqlite storage reads it back as NaN, as the other backends keep
    it, so successive halving prunes the trial (a NaN never survives a rung).
    The reference's sqlite storage reads it back as None, and the pruner's
    comparison then raises in the trial that reported it."""
    study = _nan_report_study(hpo, make_storage(kind, tmp_path))
    trials = study.trials
    assert [t.state for t in trials].count(TrialState.FAIL) == 0
    for number in (3, 6):
        assert trials[number].state == TrialState.PRUNED
        assert math.isnan(trials[number].intermediate_values[1])
    if kind == "sqlite":  # the reference's file reads back None
        ref = _reference()
        url = f"sqlite:///{tmp_path}/ref.db"
        with pytest.raises(TypeError):
            _nan_report_study(ref, url)
        (summary,) = ref.get_storage(url).get_all_studies()
        trial = ref.load_study(summary.study_name, url).trials[3]
        assert trial.intermediate_values == {1: None}
