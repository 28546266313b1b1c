"""BENCHMARK.json against the benchmark's contract, the traffic generator's
seeding, the import guard, and cells found by their files alone."""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import generate, harness
from portbench.harness import ROOT
from portbench.reference import deepseek

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def _metrics():
    return MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
               for p in MANIFEST["paths"])
    assert len(MANIFEST["command"]) <= 32
    assert MANIFEST["command"][1].startswith(MANIFEST["paths"][0] + "/")


def test_names_and_units():
    names = [m["name"] for m in _metrics()]
    for w in MANIFEST["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    names += [c["name"] for c in MANIFEST["configs"]]
    names += [k for c in MANIFEST["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in ("end_to_end", "per_layer", "workloads", "configs"):
        own = [x["name"] for x in MANIFEST[group]]
        assert len(own) == len(set(own)), group
    assert len({m["name"] for m in _metrics()}) == len(_metrics())
    for m in _metrics():
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [w["why"] for w in MANIFEST["workloads"]] + [m["layer"] for m in MANIFEST["per_layer"]]
    texts += [c[k] for c in MANIFEST["configs"] for k in ("why", "source")]
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_only_their_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in SOURCES_E2E and 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES


def test_every_config_has_a_cell_and_a_file():
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(MANIFEST["paths"][0] + "/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and sorted(data["reduced"]) == sorted(c["reduced"])
    assert len({c["file"] for c in MANIFEST["configs"]}) == len(MANIFEST["configs"])


def test_at_most_one_four_chip_cell():
    chips = [w["chips"] for w in MANIFEST["workloads"]]
    assert set(chips) <= {1, 4} and chips.count(4) <= max(1, len(chips) // 4)


def test_each_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = [w["name"] for w in MANIFEST["workloads"]]

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    for cell in cells:
        assert reports(e2e["setup_s"], cell)
        assert sum(reports(m, cell) for m in MANIFEST["end_to_end"]) >= 2
        assert any(reports(m, cell) for m in MANIFEST["per_layer"])
    for m in MANIFEST["per_layer"]:
        for cell in m.get("workloads", cells):
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_are_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.traffic["kind"] in ("train", "serve")
    assert set(c.limits) and all("limit" in v for v in c.limits.values())
    for m in c.per_layer:
        assert callable(harness._load_reader(m["name"]))


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_program_runs_what_the_file_states(cell):
    c = harness.load_cell(cell)
    harness.check_port_matches(harness.port_config(c.config), c.config)


def test_catalog_config_keeps_the_published_numbers():
    c = json.loads((ROOT / "portbench/configs/deepseek-v2-lite-5l.json").read_text())
    assert c["source"].startswith("https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite")
    published = {"hidden_size": 2048, "intermediate_size": 10944, "kv_lora_rank": 512,
                 "moe_intermediate_size": 1408, "n_routed_experts": 64, "n_shared_experts": 2,
                 "num_attention_heads": 16, "num_experts_per_tok": 6, "qk_nope_head_dim": 128,
                 "qk_rope_head_dim": 64, "v_head_dim": 128, "vocab_size": 102400,
                 "first_k_dense_replace": 1, "rms_norm_eps": 1e-6, "rope_theta": 10000}
    assert {k: c[k] for k in published} == published
    assert c["num_hidden_layers"] == 5 and "num_hidden_layers" in c["reduced"]
    assert c["rope_scaling"] == {"beta_fast": 32, "beta_slow": 1, "factor": 1, "mscale": 0.707,
                                 "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                                 "type": "yarn"}


def test_yarn_at_factor_one_is_plain_rope():
    """DeepSeek-V2's YaRN (its modeling file's frequencies and mscale
    terms), at the file's factor 1, is the reference's plain RoPE."""
    c = json.loads((ROOT / "portbench/configs/deepseek-v2-lite-5l.json").read_text())
    r, dim, base = c["rope_scaling"], c["qk_rope_head_dim"], c["rope_theta"]

    def mscale(scale, m):
        return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

    def corr(rot):
        return dim * math.log(r["original_max_position_embeddings"] / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(r["beta_fast"])), 0)
    high = min(math.ceil(corr(r["beta_slow"])), dim - 1)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float64) - low) / max(high - low, 1e-3), 0, 1)
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    inter = extra / r["factor"]
    yarn = inter * ramp + extra * (1 - ramp)
    assert torch.allclose(yarn, extra, rtol=1e-14, atol=0)
    assert mscale(r["factor"], r["mscale"]) / mscale(r["factor"], r["mscale_all_dim"]) == 1.0
    assert mscale(r["factor"], r["mscale_all_dim"]) == 1.0
    deepseek.dims(c)
    with pytest.raises(ValueError):
        deepseek.dims(dict(c, rope_scaling=dict(r, factor=40)))


def test_train_batches_follow_the_seed():
    t = json.loads((ROOT / "portbench/traffic/train-8x2048.json").read_text())
    t = dict(t, batch=2, seq_len=16)
    a = generate.train_batch(t, 1000, 2 ** 33 + 7, 4, "cpu")
    b = generate.train_batch(t, 1000, 2 ** 33 + 7, 4, "cpu")
    c = generate.train_batch(t, 1000, 2 ** 33 + 7, 5, "cpu")
    assert torch.equal(a["tokens"], b["tokens"]) and not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])


def test_serve_passes_follow_the_seed_with_the_same_sizes():
    t = json.loads((ROOT / "portbench/traffic/docs.json").read_text())
    a = generate.serve_pass(t, 102400, 3000000017, 1)
    b = generate.serve_pass(t, 102400, 3000000017, 1)
    c = generate.serve_pass(t, 102400, 12, 1)
    d = generate.serve_pass(t, 102400, 3000000017, 2)
    assert all(np.array_equal(x, y) for ga, gb in zip(a, b) for x, y in zip(ga, gb))
    # every seed and pass: the same lengths in the same groups, other tokens
    sizes = lambda cyc: [sorted(len(p) for p in g) for g in cyc]  # noqa: E731
    assert sizes(a) == sizes(c) == sizes(d)
    for other in (c, d):
        assert not any(np.array_equal(x, y) for ga, gb in zip(a, other) for x in ga for y in gb)
    lengths = [len(p) for g in a for p in g]
    assert min(lengths) >= t["prompt_min"] and max(lengths) <= t["prompt_max"]
    assert max(lengths) + t["max_new"] <= t["capacity"]
    assert all(p.min() >= 1 for g in a for p in g)


def test_weights_follow_the_seed():
    table = [("a", (3, 5), 0.0, 1.0), ("b", (7,), 1.0, 0.1)]
    one = {n: torch.empty(s) for n, s, _, _ in table}
    two = {n: torch.empty(s) for n, s, _, _ in table}
    generate.fill_weights(one, table, 11, "cpu")
    generate.fill_weights(two, table, 11, "cpu")
    assert all(torch.equal(one[n], two[n]) for n in one)
    assert abs(float(one["b"].mean()) - 1.0) < 0.2


def test_import_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules({"jax.numpy": 1, "os": 1}) == ["jax"]
    assert harness.forbidden_modules({"repro.core.study": 1}) == ["repro"]
    assert harness.forbidden_modules({"flax": 1, "jaxlib.xla": 1}) == ["flax", "jaxlib"]
    assert harness.forbidden_modules({"repro_torch.models": 1, "reprox": 1,
                                      "portbench.harness": 1}) == []


def test_benchmark_sources_import_neither_jax_nor_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|repro)(\s|\.|$)", re.M)
    for path in (ROOT / "portbench").rglob("*.py"):
        if path.name.startswith("test_"):
            continue
        assert not pattern.search(path.read_text()), path
    ref = re.compile(r"^\s*(import|from)\s+(repro_torch|portbench\.(harness|cell_))", re.M)
    for path in (ROOT / "portbench/reference").glob("*.py"):
        assert not ref.search(path.read_text()), path


STUB_FAMILY = """
def expected(cfg, c):
    return {"width": (cfg.width, c["stub_width"])}


def smoke_sizes(cfg):
    return {"stub_width": cfg.width}


def forward_flops(c, S):
    return 1000 * c["stub_width"] * S
"""


def test_a_new_cell_is_found_by_adding_files(tmp_path, monkeypatch):
    import types

    import portbench.reference
    from portbench.smoke import smoke_config

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "portbench"
    config = json.loads((bench / "configs/deepseek-v2-lite-5l.json").read_text())
    config.update(name="tiny", reference="stub", stub_width=7)
    (bench / "configs/tiny.json").write_text(json.dumps(config))
    (bench / "reference/stub.py").write_text(STUB_FAMILY)
    (bench / "traffic/short.json").write_text(json.dumps(
        dict(json.loads((bench / "traffic/train-8x2048.json").read_text()), seq_len=256)))
    (bench / "limits/tiny.short.json").write_text(json.dumps({"loss_gap": {"limit": 1.0}}))
    (bench / "metrics/tokens_seen.train.py").write_text(
        "def read(ctx):\n    return float(ctx['steps'])\n")
    manifest["configs"].append(dict(manifest["configs"][0], name="tiny",
                                    file="portbench/configs/tiny.json"))
    manifest["workloads"].append({"name": "tiny.short", "config": "tiny", "traffic": "short",
                                  "chips": 1, "why": "a cell made of files only"})
    manifest["per_layer"].append({"name": "tokens_seen.train", "unit": "steps", "better": "higher",
                                  "source": "host_clock", "layer": "train step",
                                  "moves": "train_tokens_per_s", "workloads": ["tiny.short"]})
    manifest["end_to_end"][0]["workloads"].append("tiny.short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.load_cell("tiny.short", root=tmp_path)
    assert cell.config["name"] == "tiny" and cell.traffic["seq_len"] == 256
    assert [m["name"] for m in cell.per_layer][-1] == "tokens_seen.train"
    reader = harness._load_reader("tokens_seen.train", root=tmp_path)
    assert reader({"steps": 3}) == 3.0

    # the new family's module is found by the name in the configuration
    monkeypatch.setattr(portbench.reference, "__path__",
                        [str(bench / "reference"), *portbench.reference.__path__])
    monkeypatch.delitem(sys.modules, "portbench.reference.stub", raising=False)
    family = harness.reference_family(cell.config)
    assert family.__file__ == str(bench / "reference/stub.py")
    c = cell.config
    cfg = types.SimpleNamespace(
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], vocab=c["vocab_size"],
        n_layers=c["num_hidden_layers"], norm_eps=c["rms_norm_eps"], rope_theta=c["rope_theta"],
        tie_embeddings=c["tie_word_embeddings"], compute_dtype=c["compute_dtype"],
        param_dtype=c["param_dtype"], name="tiny-port", width=7)
    harness.check_port_matches(cfg, c)
    with pytest.raises(ValueError, match="width"):
        harness.check_port_matches(types.SimpleNamespace(**dict(vars(cfg), width=8)), c)
    assert smoke_config(c, types.SimpleNamespace(**dict(vars(cfg), width=3)))["stub_width"] == 3
    mfu = harness._load_reader("mfu.train", root=tmp_path)
    ctx = {"kind": "train", "steps": 2, "window_s": 1.0, "traffic": cell.traffic, "config": c,
           "family": family}
    assert mfu(ctx) == pytest.approx(100 * 3 * 8 * 7000 * 256 * 2 / 989e12)
    sys.modules.pop("portbench.reference.stub", None)


def test_run_refuses_without_the_program_or_a_card(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "deepseek-train-8x2048",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
