"""Every entry of ``BENCHMARK.json`` resolves to its files by name, no file
is left that no entry names, the manifest keeps the contract's form, and
a new cell, configuration or metric is added by new files and entries
alone."""

import json
import re
import shutil

import pytest

from portbench import run
from portbench.reference import arch_of

BENCH = run.manifest()
# the cells held out of the manifest, in its form (PERF.md says why)
HELD = json.loads((run.HERE / "held.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DATA_DIRS = {"configs": ".json", "workloads": ".json", "drivers": ".py",
             "e2e": ".py", "metrics": ".py"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection)\w*size|"
                   r"(_dim|_rank)$|head_size|expansion|experts_per_tok")


def test_manifest_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + metrics]
    assert len(names) == len(set(names))
    for x in BENCH["workloads"]:
        assert NAME.match(x["traffic"]) and NAME.match(x["config"])
        assert x["chips"] == 1 and 1 <= len(x["why"]) <= 200
    for name in names:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH, indent=1)) < 64 * 1024


def test_configs_state_what_changed():
    """Nothing is cut (``reduced`` is empty), the top level holds the
    published values, and each departure names a published key, its
    published value and the value the run uses, which differ; no width
    departs."""
    for c in BENCH["configs"] + HELD["configs"]:
        doc = json.loads((run.ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/configs/")
        assert doc["source"] == c["source"]
        assert doc["reduced"] == c["reduced"] == []
        for key, dep in doc["departures"].items():
            assert not WIDTH.search(key), key
            assert set(dep) == {"published", "run", "why"}
            assert doc[key] == dep["published"] != dep["run"]
        arch = arch_of(doc)
        assert arch["eps"] == doc["departures"].get(
            "rms_norm_eps", doc["departures"].get("layer_norm_eps"))["run"]


@pytest.mark.parametrize("bench", [BENCH, HELD], ids=["manifest", "held"])
def test_every_cell_reports_what_it_must(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    # set-up is reported in every cell, those that later entries add too
    assert all("workloads" not in m for m in bench["end_to_end"]
               if m["name"] == "setup_s")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]
    for cell in cells:
        assert cell in e2e["setup_s"]
        assert any(cell in w for n, w in e2e.items() if n != "setup_s")
        assert any(cell in m["workloads"] for m in bench["per_layer"])


def test_entries_resolve_and_nothing_is_orphaned():
    needed = run.needed_files(BENCH)
    held = run.needed_files(HELD)
    assert all(p.is_file() for p in needed | held)
    present = {p for d, ext in DATA_DIRS.items()
               for p in (run.HERE / d).glob(f"*{ext}")
               if p.name != "__init__.py"}
    assert present == needed | held
    assert not {w["name"] for w in HELD["workloads"]} & \
        {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"] + HELD["workloads"]:
        wl = run.load_json("workloads", w["name"])
        assert wl["name"] == w["name"] and wl["config"] == w["config"]
        assert wl["why"] == w["why"]


def test_a_new_cell_config_and_metric_need_only_new_files(tmp_path):
    base = tmp_path / "portbench"
    for d in DATA_DIRS:
        shutil.copytree(run.HERE / d, base / d)
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((base / "configs" / "bert-base.json").read_text())
    cfg["name"] = "bert-large"
    (base / "configs" / "bert-large.json").write_text(json.dumps(cfg))
    wl = run.load_json("workloads", "bert-base.shm-c2560", base)
    wl.update(name="bert-large.shm-c64", config="bert-large")
    (base / "workloads" / "bert-large.shm-c64.json").write_text(json.dumps(wl))
    (base / "metrics" / "batcher.batch_rows.py").write_text(
        "def read(rec):\n    return rec['rows']\n")
    bench["configs"].append(dict(bench["configs"][0], name="bert-large",
                                 file="portbench/configs/bert-large.json"))
    bench["workloads"].append({"name": "bert-large.shm-c64",
                               "config": "bert-large", "traffic": "shm-c64",
                               "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({"name": "batcher.batch_rows", "unit": "rows",
                               "better": "higher", "source": "program_counter",
                               "layer": "dynamic batcher",
                               "moves": "infer_per_s",
                               "workloads": ["bert-large.shm-c64"]})
    for m in bench["end_to_end"]:
        if "bert-base.shm-c2560" in m.get("workloads", []):
            m["workloads"].append("bert-large.shm-c64")
    needed = run.needed_files(bench, base)
    assert all(p.is_file() for p in needed)
    assert base / "metrics" / "batcher.batch_rows.py" in needed
    names = [m["name"] for m in run.cell_metrics(bench, "bert-large.shm-c64",
                                                 True)]
    assert names == ["batcher.batch_rows"]
    assert run.reader("metrics", "batcher.batch_rows", base)({"rows": 7}) == 7
    # the files that were there are untouched
    for d in DATA_DIRS:
        for p in (run.HERE / d).iterdir():
            if p.is_file():
                assert (base / d / p.name).read_bytes() == p.read_bytes()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]
                                  + HELD["workloads"]])
def test_cell_limits_are_stated(cell):
    limits = run.load_json("workloads", cell)["limits"]
    assert limits.get("failed") == {"max": 0}
    assert all(len(v) == 1 and next(iter(v)) in ("max", "min")
               for v in limits.values())
