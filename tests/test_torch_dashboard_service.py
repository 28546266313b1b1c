"""The port's HTTP analytics service (``repro_torch.serve.dashboard_service``),
held to the reference.

* The reference's own suite (``tests/test_dashboard_service.py``), each test
  under its reference name: the revision-gated delta endpoint (an idle study
  costs zero storage refetches, pinned by the telemetry counters), views and
  pages, the Prometheus exposition, scoped-token auth, and fANOVA agreeing
  with Spearman.
* Same answers across the packages: over one sqlite file, whichever package
  wrote it, the port's service and the reference's answer the same request
  sequence (``/delta`` cold, idle and after new trials, ``/views``,
  ``/importance``, ``/api/studies``) with the same JSON, and ``/metrics``
  with the same Prometheus text.
* The CLI starts the service on a storage URL and serves it.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import pytest

import repro_torch.core as hpo
from repro_torch.core import telemetry
from repro_torch.serve.dashboard_service import DashboardService

ROOT = Path(__file__).resolve().parents[1]


def _reference():
    """``repro.core`` (the JAX package); the cross-package cases skip without jax."""
    pytest.importorskip("jax")
    import repro.core as ref

    return ref


@pytest.fixture
def metrics():
    telemetry.reset()
    telemetry.enable()
    yield telemetry
    telemetry.disable()
    telemetry.reset()


def _get(svc, path, token=None, raw=False):
    req = urllib.request.Request(svc.url + path)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    body = urllib.request.urlopen(req).read()
    return body if raw else json.loads(body)


def _status(svc, path, token=None):
    try:
        req = urllib.request.Request(svc.url + path)
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        return urllib.request.urlopen(req).status
    except urllib.error.HTTPError as e:
        return e.code


def _delta(svc, name, cursor):
    """One ``/delta`` poll as the live page makes it: the cursor and the
    pending numbers go out, and come back updated when the study changed."""
    pending = ",".join(map(str, cursor["pending"]))
    d = _get(svc, f"/api/study/{name}/delta?since_rev={cursor['rev']}"
                  f"&since_num={cursor['num']}" + (f"&pending={pending}" if pending else ""))
    if not d["idle"]:
        cursor.update(rev=d["rev"], num=d["last_number"], pending=d.get("pending", []))
    return d


def _seed_study(storage, name="svc", n=20, seed=0, pkg=hpo):
    s = pkg.create_study(
        study_name=name, storage=storage, sampler=pkg.RandomSampler(seed=seed)
    )
    s.optimize(
        lambda t: t.suggest_float("x", -2, 2) ** 2 + 0.05 * t.suggest_float("y", 0, 1),
        n_trials=n,
    )
    return s


# -- the reference's suite (tests/test_dashboard_service.py) ---------------------


class TestDeltaEndpoint:
    def test_idle_poll_zero_storage_refetch(self, metrics):
        backend = hpo.InMemoryStorage()
        with hpo.StorageServer(backend) as server:
            _seed_study(hpo.RemoteStorage(server.url), n=15)
            svc = DashboardService(f"remote://{server.url.split('//')[1]}").start()
            try:
                d = _get(svc, "/api/study/svc/delta?since_rev=-1&since_num=-1")
                assert not d["idle"] and len(d["rows"]) == 15

                before = telemetry.snapshot()["counters"]
                for _ in range(5):
                    d2 = _get(
                        svc,
                        f"/api/study/svc/delta?since_rev={d['rev']}&since_num={d['last_number']}",
                    )
                    assert d2 == {"rev": d["rev"], "idle": True}
                after = telemetry.snapshot()["counters"]

                assert after.get("dashboard.delta.idle", 0) == before.get("dashboard.delta.idle", 0) + 5
                for key in after:
                    if ".refresh." in key:  # records.* and cached.* fetch paths
                        assert after[key] == before.get(key, 0), key
            finally:
                svc.stop()

    def test_active_poll_ships_only_new_rows(self, metrics):
        backend = hpo.InMemoryStorage()
        with hpo.StorageServer(backend) as server:
            url = f"remote://{server.url.split('//')[1]}"
            s = _seed_study(hpo.RemoteStorage(server.url), n=10)
            svc = DashboardService(url).start()
            try:
                d = _get(svc, "/api/study/svc/delta?since_rev=-1&since_num=-1")
                assert [r["number"] for r in d["rows"]] == list(range(10))
                s.optimize(lambda t: t.suggest_float("x", -2, 2) ** 2
                           + 0.05 * t.suggest_float("y", 0, 1), n_trials=4)
                d2 = _get(
                    svc,
                    f"/api/study/svc/delta?since_rev={d['rev']}&since_num={d['last_number']}",
                )
                assert not d2["idle"]
                assert [r["number"] for r in d2["rows"]] == [10, 11, 12, 13]
                assert d2["rev"] != d["rev"]
            finally:
                svc.stop()


class TestViewsAndPages:
    def test_views_and_pages_render(self, metrics):
        storage = hpo.InMemoryStorage()
        _seed_study(storage, n=20)
        svc = DashboardService(storage).start()
        try:
            v = _get(svc, "/api/study/svc/views")
            assert v["n_finished"] == 20
            assert len(v["history"]) == 1 and len(v["history"][0]["best"]) == 20
            assert v["contour"] is not None and v["contour"]["x_param"] in ("x", "y")
            assert {s["param"] for s in v["slices"]} == {"x", "y"}
            page = _get(svc, "/study/svc", raw=True).decode()
            assert 'data-study="svc"' in page and "optimization history" in page
            index = _get(svc, "/", raw=True).decode()
            assert "/study/svc" in index
            cluster = _get(svc, "/cluster", raw=True).decode()
            assert "shards" in cluster
            assert _status(svc, "/nope") == 404
        finally:
            svc.stop()

    def test_prometheus_exposition(self, metrics):
        storage = hpo.InMemoryStorage()
        _seed_study(storage, n=5)
        svc = DashboardService(storage).start()
        try:
            _get(svc, "/api/study/svc/delta?since_rev=-1&since_num=-1")
            text = _get(svc, "/metrics", raw=True).decode()
            assert "# TYPE repro_dashboard_http_requests_total counter" in text
            assert "repro_dashboard_delta_active_total 1" in text
            for line in text.strip().splitlines():
                assert line.startswith("#") or " " in line
        finally:
            svc.stop()


class TestAuth:
    def _svc(self, tokens):
        storage = hpo.InMemoryStorage()
        _seed_study(storage, name="mine", n=5)
        _seed_study(storage, name="other", n=5, seed=1)
        return DashboardService(storage, tokens=tokens).start()

    def test_open_when_no_tokens(self, metrics):
        svc = self._svc(None)
        try:
            assert _status(svc, "/") == 200
            assert _status(svc, "/metrics") == 200
        finally:
            svc.stop()

    def test_missing_or_bad_token_401(self, metrics):
        svc = self._svc(["sekrit"])
        try:
            assert _status(svc, "/") == 401
            assert _status(svc, "/api/study/mine/views") == 401
            assert _status(svc, "/", token="wrong") == 401
            assert _status(svc, "/", token="sekrit") == 200
            assert _status(svc, "/?token=sekrit") == 200
        finally:
            svc.stop()

    def test_readonly_token_accepted_everywhere(self, metrics):
        svc = self._svc([{"token": "ro", "readonly": True}])
        try:
            for path in ("/", "/metrics", "/cluster", "/api/studies",
                         "/api/study/mine/views", "/api/cluster/metrics"):
                assert _status(svc, path, token="ro") == 200, path
        finally:
            svc.stop()

    def test_study_scoped_token_confined(self, metrics):
        svc = self._svc([{"token": "st", "studies": ["mine"]}])
        try:
            assert _status(svc, "/api/study/mine/views", token="st") == 200
            assert _status(svc, "/study/mine", token="st") == 200
            assert _status(svc, "/api/study/other/views", token="st") == 403
            for path in ("/", "/metrics", "/cluster", "/api/studies",
                         "/api/cluster/metrics"):
                assert _status(svc, path, token="st") == 403, path
        finally:
            svc.stop()


class TestImportanceRankingAgreement:
    def test_fanova_agrees_with_spearman_on_monotone_study(self, metrics):
        s = hpo.create_study(sampler=hpo.RandomSampler(seed=7))
        s.optimize(
            lambda t: 3.0 * t.suggest_float("x", 0, 1)
            + 0.01 * t.suggest_float("y", 0, 1),
            n_trials=60,
        )
        fan = hpo.fanova_importances(s)
        spear = hpo.spearman_importances(s)
        assert max(fan, key=fan.get) == max(spear, key=spear.get) == "x"
        assert fan["x"] > 0.8 and spear["x"] > 0.8
        assert sum(fan.values()) == pytest.approx(1.0)
        assert sorted(fan, key=fan.get) == sorted(spear, key=spear.get)

    def test_fanova_fallback_small_study(self, metrics):
        s = hpo.create_study(sampler=hpo.RandomSampler(seed=3))
        s.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=4)
        assert hpo.fanova_importances(s) == hpo.spearman_importances(s)


# -- the same answers as the reference's service ---------------------------------


def _pruned_objective_of(pkg):
    def objective(t):
        x = t.suggest_float("x", -2, 2)
        kind = t.suggest_categorical("kind", ["a", "b"])
        width = t.suggest_int("width", 8, 64, log=True)
        value = x * x + (kind == "b") * 0.3 + 1.0 / width
        for step in range(3):
            t.report(value + 1.0 / (step + 1), step)
            if t.should_prune():
                raise pkg.TrialPruned()
        return value

    return objective


def _write(pkg, url, n, seed):
    study = pkg.load_study("svc", url, sampler=pkg.TPESampler(seed=seed, engine="numpy"),
                           pruner=pkg.MedianPruner(n_startup_trials=3))
    study.optimize(_pruned_objective_of(pkg), n_trials=n)


def _answers(svc_cls, tel, url, more) -> dict:
    """The service's answers to one request sequence; ``more()`` adds trials
    to the file between the idle poll and the active one."""
    tel.reset()
    tel.enable()
    svc = svc_cls(url).start()
    try:
        out = {"cold": _get(svc, "/api/study/svc/delta?since_rev=-1&since_num=-1")}
        rev, num = out["cold"]["rev"], out["cold"]["last_number"]
        out["idle"] = _get(svc, f"/api/study/svc/delta?since_rev={rev}&since_num={num}")
        out["views"] = _get(svc, "/api/study/svc/views")
        out["importance"] = _get(svc, "/api/study/svc/importance")
        tel.disable()  # count the service's work alone, not the writer's
        more()
        tel.enable()
        out["active"] = _get(svc, f"/api/study/svc/delta?since_rev={rev}&since_num={num}")
        out["views_after"] = _get(svc, "/api/study/svc/views")
        out["studies"] = _get(svc, "/api/studies")
        out["metrics"] = _get(svc, "/metrics", raw=True).decode()
    finally:
        svc.stop()
        tel.disable()
        tel.reset()
    return out


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_services_answer_alike_over_one_file(tmp_path, writer):
    ref = _reference()
    from repro.core import telemetry as ref_telemetry
    from repro.serve.dashboard_service import DashboardService as RefDashboardService

    pkg = ref if writer == "reference" else hpo
    answers = {}
    for reader, svc_cls, tel in (("port", DashboardService, telemetry),
                                 ("reference", RefDashboardService, ref_telemetry)):
        url = f"sqlite:///{tmp_path}/{reader}.db"
        pkg.create_study(study_name="svc", storage=url, engine="numpy")
        _write(pkg, url, 24, seed=0)
        answers[reader] = _answers(svc_cls, tel, url, lambda: _write(pkg, url, 6, seed=1))
    mine, want = answers["port"], answers["reference"]
    assert mine["cold"]["rev"] == want["cold"]["rev"]  # the file's revision counter
    assert len(mine["cold"]["rows"]) == 24 and mine["idle"]["idle"] is True
    assert [r["number"] for r in mine["active"]["rows"]] == list(range(24, 30))
    assert {r["state"] for r in mine["cold"]["rows"]} == {"COMPLETE", "PRUNED"}
    assert mine["metrics"] == want["metrics"]
    assert "repro_dashboard_delta_idle_total 1" in mine["metrics"]
    mine.pop("metrics"), want.pop("metrics")
    assert json.dumps(mine, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_cli_serves_a_storage_url(tmp_path):
    url = f"sqlite:///{tmp_path}/cli.db"
    _seed_study(url, n=6)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.dashboard_service", "--storage", url,
         "--port", "0", "--token", "t"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("dashboard: http://127.0.0.1:"), (line, proc.stderr.read())
        base = line.split()[1]
        req = urllib.request.Request(base + "/api/studies",
                                     headers={"Authorization": "Bearer t"})
        studies = json.loads(urllib.request.urlopen(req, timeout=30).read())
        assert studies == {"studies": [{"name": "svc", "n_trials": 6,
                                        "directions": ["minimize"]}]}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/api/studies", timeout=30)
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_live_service_watches_concurrent_slices(tmp_path, metrics):
    """Four scheduler slices write one sqlite file while the service, a
    second reader of that file, is polled: trials finish out of order, yet
    the delta polls ship every finished row exactly once, and once the study
    is idle a poll is one revision read with zero refetch."""
    import random
    import threading
    import time

    import torch

    from repro_torch.tune import TrialSliceScheduler

    url = f"sqlite:///{tmp_path}/live.db"
    study = hpo.create_study(study_name="live", storage=url,
                             sampler=hpo.TPESampler(seed=0, n_startup_trials=4, engine="numpy"),
                             pruner=hpo.SuccessiveHalvingPruner(min_resource=1, reduction_factor=2))
    jitter = random.Random(0)

    def run_trial(trial, devices):
        x = trial.suggest_float("x", -2, 2)
        y = trial.suggest_float("y", 0, 1)
        for step in range(1, 4):
            time.sleep(jitter.uniform(0.0, 0.02))
            trial.report(x * x + y + 1.0 / step, step)
            if trial.should_prune():
                raise hpo.TrialPruned()
        return x * x + y

    svc = DashboardService(url).start()
    shipped, cursor, done = [], {"rev": -1, "num": -1, "pending": []}, threading.Event()

    def poll():
        d = _delta(svc, "live", cursor)
        if not d["idle"]:
            shipped.extend(r["number"] for r in d["rows"])
        return d

    def poller():
        while not done.is_set():
            poll()
            time.sleep(0.01)

    thread = threading.Thread(target=poller)
    thread.start()
    try:
        sched = TrialSliceScheduler(study, [[torch.device("cpu")]] * 4, run_trial)
        sched.run(n_trials=32)
        done.set()
        thread.join()
        poll()  # the study is idle now: the last rows
        states = [t.state for t in study.trials]
        assert len(states) == 32 and set(states) <= {hpo.TrialState.COMPLETE,
                                                     hpo.TrialState.PRUNED}
        finished = [e[2] for e in sched.events if e[0] != "start"]
        assert finished != sorted(finished)  # out of order
        assert sorted(shipped) == list(range(32)) and cursor["pending"] == []
        before = telemetry.snapshot()["counters"]
        for _ in range(5):
            assert poll() == {"rev": cursor["rev"], "idle": True}
        after = telemetry.snapshot()["counters"]
        assert after["dashboard.delta.idle"] == before.get("dashboard.delta.idle", 0) + 5
        assert all(after[k] == before.get(k, 0) for k in after if ".refresh." in k)
        views = _get(svc, "/api/study/live/views")
        assert views["n_finished"] == 32 and views["curves"]["objectives"][0]["numbers"]
        assert set(_get(svc, "/api/study/live/importance")["fanova"]["0"]) == {"x", "y"}
    finally:
        done.set()
        thread.join()
        svc.stop()


def test_lost_trial_holds_no_row_back(tmp_path, metrics):
    """A trial left RUNNING below finished ones (its worker lost) holds no
    later row back over HTTP: the page's pending numbers bring its row once
    it finishes, and an unchanged study still answers idle."""
    url = f"sqlite:///{tmp_path}/lost.db"
    study = hpo.create_study(study_name="lost", storage=url, sampler=hpo.RandomSampler(seed=0))
    trials = study.ask(4)
    for t in trials:
        t.suggest_float("x", 0, 1)
    study.tell(trials[0], 0.0)
    svc = DashboardService(url).start()
    cursor = {"rev": -1, "num": -1, "pending": []}
    try:
        assert [r["number"] for r in _delta(svc, "lost", cursor)["rows"]] == [0]
        study.tell(trials[2], 2.0)
        study.tell(trials[3], 3.0)
        d = _delta(svc, "lost", cursor)
        assert [r["number"] for r in d["rows"]] == [2, 3] and d["pending"] == [1]
        assert _delta(svc, "lost", cursor) == {"rev": cursor["rev"], "idle": True}
        study.tell(trials[1], 1.0)
        d = _delta(svc, "lost", cursor)
        assert [r["number"] for r in d["rows"]] == [1] and "pending" not in d
        assert d["last_number"] == 3
    finally:
        svc.stop()
