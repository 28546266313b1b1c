"""The port's static dashboard (``repro_torch.core.dashboard``), held to the
reference.

* The reference's own suite (``tests/test_dashboard.py``), each test under
  its reference name: the SVG skeletons (element counts, labels,
  highlighted points) of seeded studies, the live metrics panel against a
  real storage server, and the importance edge cases.  A study built with
  no sampler takes ``engine="numpy"``: the port's default TPE needs the card.
* Same HTML: ``render_dashboard`` over one sqlite file gives the reference's
  page character for character, whichever package wrote the file; and the
  same seeded study run in each package renders the same page but for the
  trials' timestamps.
* The CLI (``python -m repro_torch.core.dashboard``) renders a file's study
  once, and with ``--live --watch`` re-renders only on a changed revision.
"""

import re

import pytest

import repro_torch.core as hpo
from repro_torch.core.dashboard import (
    _history_svg,
    _importance_svg,
    _metrics_panel_html,
    _pareto_svg,
    _throughput_svg,
    main,
    render_dashboard,
)


def _reference():
    """``repro.core`` (the JAX package); the cross-package cases skip without jax."""
    pytest.importorskip("jax")
    import repro.core as ref

    return ref


def _seeded_study(n_trials=20):
    s = hpo.create_study(sampler=hpo.RandomSampler(seed=11))

    def obj(t):
        x = t.suggest_float("x", 0, 1)
        y = t.suggest_float("y", 0, 1)
        return 5 * x + 0.1 * y

    s.optimize(obj, n_trials=n_trials)
    return s


def _seeded_moo_study(n_trials=20):
    s = hpo.create_study(
        directions=["minimize", "minimize"], sampler=hpo.RandomSampler(seed=11)
    )

    def obj(t):
        x = t.suggest_float("x", 0, 1)
        return x, 1 - x

    s.optimize(obj, n_trials=n_trials)
    return s


# -- the reference's suite (tests/test_dashboard.py) ---------------------------


class TestHistorySvg:
    def test_shape(self):
        svg = _history_svg(_seeded_study(20))
        assert svg.startswith("<svg")
        assert svg.count("<circle") == 20
        assert svg.count("<polyline") == 1
        assert svg.count("<line") == 2
        assert "trial #" in svg

    def test_empty_study(self):
        s = hpo.create_study(engine="numpy")
        assert "no completed trials" in _history_svg(s)


class TestParetoSvg:
    def test_shape(self):
        s = _seeded_moo_study(20)
        svg = _pareto_svg(s)
        assert svg.count("<circle") == 20
        n_front = len(s.pareto_front()[1])
        assert f"Pareto front ({n_front} trials)" in svg
        assert svg.count('r="3.5"') == n_front
        assert svg.count('fill="#c0392b"') == n_front + 1  # circles + legend text

    def test_empty(self):
        s = hpo.create_study(directions=["minimize", "minimize"], engine="numpy")
        assert "no completed trials" in _pareto_svg(s)


class TestImportanceSvg:
    def test_shape(self):
        svg = _importance_svg(_seeded_study(30))
        assert svg.count("<rect") == 2
        assert ">x<" in svg and ">y<" in svg
        vals = [float(v) for v in re.findall(r'font-size="10">([0-9.]+)</text>', svg)]
        assert len(vals) == 2 and abs(sum(vals) - 1.0) < 0.02

    def test_multi_objective_grouped(self):
        svg = _importance_svg(_seeded_moo_study(10))
        assert "objective 0" in svg and "objective 1" in svg
        assert svg.count("<rect") >= 2

    def test_unavailable(self):
        s = hpo.create_study(engine="numpy")
        assert "importances unavailable" in _importance_svg(s)


class TestLivePanel:
    def test_throughput_sparkline(self):
        svg = _throughput_svg([0.0, 1.0, 4.0, 2.0])
        assert svg.count("<polyline") == 1
        assert svg.count("<polygon") == 1  # the filled area
        assert "now 2.00" in svg and "peak 4.00" in svg
        assert "no samples yet" in _throughput_svg([])

    def test_metrics_panel(self):
        metrics = {
            "uptime_s": 12.0,
            "active_connections": 3,
            "frames_in": 10,
            "frames_out": 10,
            "bytes_in": 2048,
            "bytes_out": 4096,
            "spec_cache_hits": 1,
            "methods": {
                "get_trial": {
                    "calls": 7, "errors": 0, "bytes_out": 700,
                    "p50": 0.001, "p95": 0.002, "p99": 0.003, "max": 0.004,
                },
            },
        }
        htm = _metrics_panel_html(metrics)
        assert "3 active" in htm
        assert "2.0 KiB in / 4.0 KiB out" in htm
        assert "<td>get_trial</td><td>7</td>" in htm
        assert "<td>1.00</td><td>2.00</td><td>3.00</td>" in htm  # ms columns
        assert "unavailable" in _metrics_panel_html(None)

    def test_render_dashboard_live_section(self):
        s = _seeded_study(5)
        plain = render_dashboard(s)
        assert "Live server metrics" not in plain
        live = render_dashboard(s, server_metrics={}, throughput=[1.0, 2.0])
        assert "Live server metrics" in live
        assert "trials/s" in live

    def test_live_panel_from_real_server(self):
        backend = hpo.InMemoryStorage()
        with hpo.StorageServer(backend) as server:
            remote = hpo.RemoteStorage(server.url)
            s = hpo.create_study(
                study_name="live", storage=remote, sampler=hpo.RandomSampler(seed=0)
            )
            s.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=5)
            html = render_dashboard(s, server_metrics=remote.get_server_metrics())
        assert "Live server metrics" in html
        assert "<td>create_new_trial</td><td>5</td>" in html


class TestImportanceEdgeCases:
    def test_multi_objective_per_objective_dicts(self):
        s = _seeded_moo_study(20)
        for res in (hpo.param_importances(s), hpo.spearman_importances(s)):
            assert sorted(res) == [0, 1]
            for d in res.values():
                assert sorted(d) == ["x"]
                assert abs(sum(d.values()) - 1.0) < 1e-9

    def test_single_objective_unchanged(self):
        s = _seeded_study(25)
        assert hpo.param_importances(s, objective=0) == hpo.param_importances(s)
        assert hpo.spearman_importances(s, objective=0) == hpo.spearman_importances(s)

    def test_fewer_than_two_complete_trials(self):
        s = hpo.create_study(sampler=hpo.RandomSampler(seed=0))
        assert hpo.param_importances(s) == {}
        assert hpo.spearman_importances(s) == {}
        s.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=1)
        assert hpo.param_importances(s) == {}
        assert hpo.spearman_importances(s) == {}

    def test_two_and_three_trials_zero_scores(self):
        s = hpo.create_study(sampler=hpo.RandomSampler(seed=0))
        s.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=3)
        assert hpo.param_importances(s) == {"x": 0.0}
        assert hpo.spearman_importances(s) == {"x": 0.0}

    def test_failed_trials_only(self):
        s = hpo.create_study(engine="numpy")

        def boom(t):
            t.suggest_float("x", 0, 1)
            raise ValueError("nope")

        s.optimize(boom, n_trials=3, catch=(ValueError,))
        assert hpo.param_importances(s) == {}


# -- the same HTML as the reference's ---------------------------------------------


def _objective_of(pkg):
    """Two floats, an int and a categorical, with reports (learning curves)
    and pruning (dimmed curves, PRUNED rows in the table)."""

    def objective(t):
        x = t.suggest_float("x", -2, 2)
        lr = t.suggest_float("lr", 1e-4, 1e-1, log=True)
        layers = t.suggest_int("layers", 1, 4)
        act = t.suggest_categorical("act", ["relu", "gelu"])
        value = x * x + 0.01 / lr ** 0.25 + 0.05 * layers + (act == "gelu") * 0.2
        for step in range(3):
            t.report(value + 0.5 / (step + 1), step)
            if t.should_prune():
                raise pkg.TrialPruned()
        t.set_user_attr("layers_seen", layers)
        return value

    return objective


def _seeded_file(pkg, path, directions=None):
    """A seeded ``engine="numpy"`` study of ``pkg`` written to a sqlite file."""
    url = f"sqlite:///{path}"
    if directions is None:
        study = pkg.create_study(
            study_name="dash", storage=url,
            sampler=pkg.TPESampler(seed=0, n_startup_trials=6, engine="numpy"),
            pruner=pkg.MedianPruner(n_startup_trials=3, n_warmup_steps=0),
        )
        study.optimize(_objective_of(pkg), n_trials=30)
    else:
        study = pkg.create_study(
            study_name="dash", storage=url, directions=directions,
            sampler=pkg.TPESampler(seed=2, n_startup_trials=6, engine="numpy"),
        )
        study.optimize(lambda t: (t.suggest_float("x", 0, 1),
                                  (1 - t.suggest_float("x", 0, 1)) ** 2
                                  + t.suggest_float("y", 0, 0.3)), n_trials=30)
    return url


def _strip_times(htm: str) -> str:
    return re.sub(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d[.\d]*", "T", htm)


@pytest.mark.parametrize("directions", [None, ["minimize", "minimize"]],
                         ids=["single", "two-objective"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_render_dashboard_equals_the_reference_on_one_file(tmp_path, writer, directions):
    ref = _reference()
    url = _seeded_file(ref if writer == "reference" else hpo, tmp_path / "dash.db", directions)
    mine = render_dashboard(hpo.load_study("dash", url, engine="numpy"))
    want = ref.render_dashboard(ref.load_study("dash", url))
    assert mine == want
    assert "Learning curves" in mine and mine.count("<svg") >= 4
    if directions is None:
        assert "PRUNED" in mine and "COMPLETE" in mine


def test_render_dashboard_equals_the_reference_on_seeded_studies(tmp_path):
    """The same seeded study run by each package: the pages differ only in
    the trials' start and end times."""
    ref = _reference()
    mine = render_dashboard(hpo.load_study(
        "dash", _seeded_file(hpo, tmp_path / "a.db"), engine="numpy"))
    want = ref.render_dashboard(ref.load_study("dash", _seeded_file(ref, tmp_path / "b.db")))
    assert mine != want  # the timestamps
    assert _strip_times(mine) == _strip_times(want)


def test_save_dashboard_and_cli(tmp_path, capsys):
    url = _seeded_file(hpo, tmp_path / "dash.db")
    study = hpo.load_study("dash", url, engine="numpy")
    path = hpo.save_dashboard(study, str(tmp_path / "saved.html"))
    saved = open(path).read()
    assert saved == render_dashboard(study) and "Study: dash" in saved

    out = tmp_path / "cli.html"
    main([url, "dash", str(out)])
    assert "rendered 30 trials" in capsys.readouterr().out
    assert _strip_times(out.read_text()) == _strip_times(saved)

    # --live --watch: the first tick renders, idle ticks do not re-render
    main([url, "dash", str(out), "--live", "--watch", "0.01", "--ticks", "3"])
    printed = capsys.readouterr().out
    assert printed.count("rendered 30 trials") == 1
    assert "Live server metrics" in out.read_text()
