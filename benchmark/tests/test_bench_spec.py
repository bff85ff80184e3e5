"""Every cell, configuration, mix and metric of BENCHMARK.json resolves
to its file by name, and a cell made of added files alone resolves and
reads."""

import json
import os
import shutil

from benchmark import run


def test_every_entry_resolves():
    spec = run.load_spec()
    for conf in spec["configs"]:
        with open(os.path.join(run.ROOT, conf["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == conf["source"]
        assert cfg["reduced"] == conf["reduced"]
    for cell in spec["workloads"]:
        res = run.resolve(spec, cell["name"])
        assert callable(run.driver(res["traffic"]["kind"]))
        assert {m["name"] for m in res["e2e"]} >= {"setup_s"}
        assert len(res["e2e"]) >= 2 and res["per_layer"]
    for m in spec["per_layer"]:
        assert callable(run.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


def test_added_files_make_a_cell(tmp_path):
    """A new configuration, mix and per-layer metric: new files and new
    entries, no edit of a file the benchmark has."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(run.ROOT, "benchmark"),
                    os.path.join(root, "benchmark"))
    spec = run.load_spec()
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), root)
    with open(os.path.join(root, "benchmark/configs/egonet_w48_car.json")) as f:
        cfg = json.load(f)
    cfg["about"] = "a dummy configuration"
    with open(os.path.join(root, "benchmark/configs/dummy_cfg.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "benchmark/traffic/offline_batch64_car.json")) as f:
        tr = json.load(f)
    tr["frames_per_dispatch"] = 8
    with open(os.path.join(root, "benchmark/traffic/dummy_mix.json"),
              "w") as f:
        json.dump(tr, f)
    with open(os.path.join(root, "benchmark/metrics/dummy_metric.py"),
              "w") as f:
        f.write("def read(record):\n    return 2.0 * record['crops']\n")
    spec["configs"].append({"name": "dummy_cfg", "source": "https://x",
                            "file": "benchmark/configs/dummy_cfg.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "dummy_cell", "config": "dummy_cfg",
                              "traffic": "dummy_mix", "chips": 1,
                              "why": "test"})
    spec["end_to_end"][0]["workloads"].append("dummy_cell")
    spec["per_layer"].append({"name": "dummy_metric", "unit": "x",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "crops_per_s",
                              "workloads": ["dummy_cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    res = run.resolve(run.load_spec(root), "dummy_cell", root)
    assert res["cfg"]["about"] == "a dummy configuration"
    assert res["traffic"]["frames_per_dispatch"] == 8
    assert [m["name"] for m in res["e2e"]] == ["crops_per_s", "setup_s"]
    assert [m["name"] for m in res["per_layer"]] == ["dummy_metric"]
    assert run.reader("dummy_metric", root)({"crops": 3}) == 6.0
